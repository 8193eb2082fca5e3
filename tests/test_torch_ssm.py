"""Port Mamba2: the plain SSD scan against the JAX package's Pallas kernel
(interpret mode) and its chunked oracle on the reference's kernel cases, the
wrapper's contract, and the SSM block (prefill with state, decode step) on
converted weights.  The CUDA kernel is held against the plain version on a
card in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(2)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(bt, l, h, p, n, seed):
    """numpy inputs in the reference test's recipe: dt = softplus(N(0,1)),
    a = −exp(linspace(0, 2, H))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, l, h, p), np.float32)
    dt = np.logaddexp(rng.standard_normal((bt, l, h), np.float32), 0).astype(np.float32)
    a = -np.exp(np.linspace(0.0, 2.0, h)).astype(np.float32)
    return (x, dt, a, rng.standard_normal((bt, l, n), np.float32),
            rng.standard_normal((bt, l, n), np.float32))


def _both(arrays, dtype):
    """(jax, torch) copies; x, B, C in ``dtype``, dt and a in fp32."""
    x, dt, a, bm, cm = arrays
    j = [jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(a),
         jnp.asarray(bm).astype(dtype), jnp.asarray(cm).astype(dtype)]
    t = [torch.from_numpy(x).to(_TORCH[dtype]), torch.from_numpy(dt), torch.from_numpy(a),
         torch.from_numpy(bm).to(_TORCH[dtype]), torch.from_numpy(cm).to(_TORCH[dtype])]
    return j, t


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("bt,l,h,p,n,chunk,dtype,tol", ref.SSD_CASES)
def test_plain_vs_jax_kernel_and_oracle(bt, l, h, p, n, chunk, dtype, tol):
    j, t = _both(_inputs(bt, l, h, p, n, seed=l + p), dtype)
    jax_kernel = jops.ssd_scan(*j, chunk=chunk)
    jax_oracle = jref.ssd_scan_ref(*j, chunk)
    y = ops.ssd_scan(*t, chunk=chunk)
    assert y.dtype == _TORCH[dtype] and y.shape == (bt, l, h, p)
    np.testing.assert_allclose(_f32(y), _f32(jax_kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(y), _f32(jax_oracle), atol=tol, rtol=tol)
    np.testing.assert_array_equal(_f32(ref.ssd_scan_ref(*t, chunk)), _f32(y))


@pytest.mark.parametrize("bt,l,h,p,n,chunk,dtype,tol", ref.SSD_CASES)
def test_final_state_matches_jax_ssd_chunked(bt, l, h, p, n, chunk, dtype, tol):
    """The state the scan ends with (the kernel's extra output) is the
    reference's h_last, held at 2e-4."""
    j, t = _both(_inputs(bt, l, h, p, n, seed=l + p + 1), dtype)
    q = min(chunk, l)
    _, h_j = jssm.ssd_chunked(*j, q)
    y, h_t = ops.ssd_scan(*t, chunk=chunk, return_state=True)
    assert h_t.dtype == torch.float32 and h_t.shape == (bt, h, p, n)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(_f32(y), _f32(ops.ssd_scan(*t, chunk=chunk)))


def test_state_carry_across_chunks():
    """Same data, different chunk sizes ⇒ same output (state carry correct)."""
    _, t = _both(_inputs(1, 256, 2, 16, 32, seed=3), "float32")
    y32 = ops.ssd_scan(*t, chunk=32)
    y128 = ops.ssd_scan(*t, chunk=128)
    np.testing.assert_allclose(y32.numpy(), y128.numpy(), atol=5e-4, rtol=5e-4)


def test_initial_state_continues_a_split_sequence():
    """ssd_chunked(h0=h_last of the first half) on the second half equals
    the second half of one scan over the whole sequence."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _inputs(2, 128, 3, 16, 8, seed=4))
    y, h = ref.ssd_chunked(x, dt, a, bm, cm, 32)
    y1, h1 = ref.ssd_chunked(x[:, :64], dt[:, :64], a, bm[:, :64], cm[:, :64], 32)
    y2, h2 = ref.ssd_chunked(x[:, 64:], dt[:, 64:], a, bm[:, 64:], cm[:, 64:], 32, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), atol=1e-5)


def test_ragged_rejected_like_reference():
    _, t = _both(_inputs(1, 100, 2, 16, 8, seed=5), "float32")
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(*t, chunk=64)
    j, _ = _both(_inputs(1, 100, 2, 16, 8, seed=5), "float32")
    with pytest.raises(ValueError):
        jops.ssd_scan(*j, chunk=64)
    assert ssd.check_chunk(100, 256) == 100      # q = min(chunk, L)


def test_cuda_path_never_falls_back():
    """The kernel launcher refuses CPU tensors and shapes it does not take
    before any build; the wrapper refuses other devices."""
    _, t = _both(_inputs(1, 64, 2, 16, 8, seed=6), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_fwd(*t, 64)
    _, t48 = _both(_inputs(1, 64, 2, 48, 8, seed=6), "float32")
    with pytest.raises(ValueError, match="kernel takes"):
        ssd.ssd_scan_fwd(*t48, 64)
    x, dt, a, bm, cm = t
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan_fwd(x, dt.double(), a, bm, cm, 64)
    m = [v.to("meta") for v in t]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.ssd_scan(*m, chunk=64)


# ==========================================================================
# The SSM block on converted weights
# ==========================================================================


def _block(dtype, seed=0):
    cfg = configs.get_smoke("mamba2-370m").replace(compute_dtype=dtype)
    jcfg = jconfigs.get_smoke("mamba2-370m").replace(compute_dtype=dtype)
    p_j = jssm.init(jax.random.PRNGKey(seed), jcfg)
    p_np = jax.tree.map(np.asarray, p_j)
    return cfg, jcfg, p_j, to_torch(p_np, device="cpu")


@pytest.mark.parametrize("l", [24, 32, 7])
def test_apply_with_state_and_decode_match_jax(l):
    """fp32: prefill output and decode state (L=24 pads 8 rows with dt=0 to
    the chunk of 16; L=7 is shorter than one chunk), then two decode steps."""
    cfg, jcfg, p_j, p_t = _block("float32")
    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l, cfg.d_model)).astype(np.float32)
    out_j, st_j = jssm.apply_with_state(p_j, jcfg, jnp.asarray(x))
    out_t, st_t = ssm.apply_with_state(p_t, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    assert set(st_t) == set(st_j) == {"h", "conv_x", "conv_b", "conv_c"}
    for k in st_j:
        assert st_t[k].shape == st_j[k].shape
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ssm.apply(p_t, cfg, torch.from_numpy(x)).numpy(),
                                  out_t.numpy())
    for step in range(2):
        xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        dj, st_j = jssm.decode_step(p_j, jcfg, jnp.asarray(xd), st_j)
        dt_, st_t = ssm.decode_step(p_t, cfg, torch.from_numpy(xd), st_t)
        np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), atol=1e-5, rtol=1e-5)
        for k in st_j:
            np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                       atol=1e-5, rtol=1e-5)


def test_bf16_block_matches_eager_jax():
    cfg, jcfg, p_j, p_t = _block("bfloat16", seed=1)
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        out_j, st_j = jssm.apply_with_state(p_j, jcfg, jnp.asarray(x).astype(jnp.bfloat16))
        dj, _ = jssm.decode_step(p_j, jcfg, jnp.asarray(x[:, :1]).astype(jnp.bfloat16), st_j)
    out_t, st_t = ssm.apply_with_state(p_t, cfg, torch.from_numpy(x).bfloat16())
    dt_, _ = ssm.decode_step(p_t, cfg, torch.from_numpy(x[:, :1]).bfloat16(), st_t)
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(_f32(dt_), _f32(dj), atol=3e-2, rtol=3e-2)
    assert st_t["h"].dtype == torch.float32 and st_t["conv_x"].dtype == torch.bfloat16


def test_init_state_and_param_tree_match_jax():
    cfg = configs.get_smoke("mamba2-370m")
    jcfg = jconfigs.get_smoke("mamba2-370m")
    mine = ssm.init(torch.Generator().manual_seed(0), cfg, device="cpu", lead=(3,))
    theirs = jssm.init(jax.random.PRNGKey(0), jcfg)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: (3,) + tuple(v.shape) for k, v in theirs.items()}
    np.testing.assert_allclose(mine["A_log"][2].numpy(), np.asarray(theirs["A_log"]), atol=1e-6)
    np.testing.assert_allclose(mine["dt_bias"][0].numpy(), np.asarray(theirs["dt_bias"]),
                               rtol=1e-5)
    st = ssm.init_state(cfg, 2, device="cpu")
    st_j = jssm.init_state(jcfg, 2)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in st.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in st_j.items()}
