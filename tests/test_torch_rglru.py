"""Port RecurrentGemma: the plain RG-LRU scan against the JAX package's
Pallas kernel (interpret mode) and its associative-scan oracle on the
reference's kernel cases, the wrapper's contract, and the RG-LRU block
(prefill with state, decode step) on converted weights.  The CUDA kernel is
held against the plain version on a card in ``test_torch_cuda.py``."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.models import common, rglru  # noqa: E402

torch.set_num_threads(2)


def _inputs(bt, l, w, dtype, seed):
    """The reference test's recipe from numpy: log_a = −softplus(N(0,1)),
    b = N(0,1) rounded to ``dtype``, then fp32 × 0.1."""
    rng = np.random.default_rng(seed)
    log_a = -np.logaddexp(rng.standard_normal((bt, l, w), np.float32), 0).astype(np.float32)
    b = np.asarray(jnp.asarray(rng.standard_normal((bt, l, w), np.float32))
                   .astype(dtype).astype(jnp.float32)) * np.float32(0.1)
    return log_a, b


@pytest.mark.parametrize("bt,l,w,bl,bw,dtype,tol",
                         ref.RGLRU_CASES + [(1, 1024, 32, 64, 32, "float32", 1e-5)])
def test_plain_vs_jax_kernel_and_oracle(bt, l, w, bl, bw, dtype, tol):
    """The reference's 4 cases and its long carry (L=1024 over 16 tiles)."""
    log_a, b = _inputs(bt, l, w, dtype, seed=w + l)
    jax_kernel = jops.rglru_scan(jnp.asarray(log_a), jnp.asarray(b), block_l=bl, block_w=bw)
    jax_oracle = jref.rglru_scan_ref(jnp.asarray(log_a), jnp.asarray(b))
    h = ops.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(b), block_l=bl, block_w=bw)
    assert h.dtype == torch.float32 and h.shape == (bt, l, w)
    np.testing.assert_allclose(h.numpy(), np.asarray(jax_kernel), atol=tol, rtol=1e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(jax_oracle), atol=tol, rtol=1e-3)


def test_plain_is_the_recurrence_with_h0():
    """The log-depth plain version against the serial recurrence, h0 included."""
    log_a, b = (torch.from_numpy(v) for v in _inputs(2, 37, 5, "float32", seed=0))
    h0 = torch.linspace(-1.0, 1.0, 5).expand(2, 5)
    want, hv = [], h0
    for t in range(37):
        hv = torch.exp(log_a[:, t]) * hv + b[:, t]
        want.append(hv)
    np.testing.assert_allclose(rglru.scan_ref(log_a, b, h0).numpy(),
                               torch.stack(want, 1).numpy(), atol=1e-6, rtol=1e-5)
    jh = jrglru.scan_ref(jnp.asarray(log_a.numpy()), jnp.asarray(b.numpy()),
                         jnp.asarray(h0.numpy()))
    np.testing.assert_allclose(rglru.scan_ref(log_a, b, h0).numpy(), np.asarray(jh),
                               atol=1e-6, rtol=1e-5)


def test_ragged_rejected_like_reference():
    z = torch.zeros((1, 100, 64))
    with pytest.raises(ValueError, match="must tile"):
        ops.rglru_scan(z, z, block_l=64, block_w=64)
    with pytest.raises(ValueError, match="must tile"):
        ops.rglru_scan(torch.zeros((1, 64, 96)), torch.zeros((1, 64, 96)),
                       block_l=64, block_w=64)
    with pytest.raises(ValueError):
        jops.rglru_scan(jnp.zeros((1, 100, 64)), jnp.zeros((1, 100, 64)),
                        block_l=64, block_w=64)


def test_cuda_path_never_falls_back():
    z = torch.zeros((1, 64, 32))
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru_scan_fwd(z, z)
    with pytest.raises(TypeError, match="float32"):
        rg.rglru_scan_fwd(z.double(), z.double())
    m = z.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.rglru_scan(m, m)


# the kernel's geometry (csrc/rglru_scan.cu): steps a segment, segments a
# tile, segments a warp
_SEG, _NSEG, _WARP_SEGS = 8, 32, 4


def _kernel_order(log_a, b):
    """The CUDA kernel's composition order on the CPU, in fp32: per tile of
    _SEG·_NSEG steps (steps past L are the identity), each segment composed
    serially into (∏a, h from 0); a shuffle-tree inclusive scan over each
    warp's _WARP_SEGS segments (offsets of 1 and 2 segments); the warps'
    totals folded in order from the previous tile's carry; then each segment
    re-run from its incoming h."""
    bt, l, w = log_a.shape
    tile, nw = _SEG * _NSEG, _NSEG // _WARP_SEGS
    a_all, b_all = torch.exp(log_a.float()), b.float()
    carry = torch.zeros((bt, w))
    out = []
    for t0 in range(0, l, tile):
        n = min(tile, l - t0)
        a = torch.ones((bt, tile, w))
        x = torch.zeros((bt, tile, w))
        a[:, :n], x[:, :n] = a_all[:, t0:t0 + n], b_all[:, t0:t0 + n]
        a, x = a.reshape(bt, _NSEG, _SEG, w), x.reshape(bt, _NSEG, _SEG, w)
        A, H = a[:, :, 0].clone(), x[:, :, 0].clone()
        for j in range(1, _SEG):
            H, A = a[:, :, j] * H + x[:, :, j], A * a[:, :, j]
        A, H = A.reshape(bt, nw, _WARP_SEGS, w), H.reshape(bt, nw, _WARP_SEGS, w)
        off = 1
        while off < _WARP_SEGS:
            pa = torch.cat([torch.ones_like(A[:, :, :off]), A[:, :, :-off]], dim=2)
            ph = torch.cat([torch.zeros_like(H[:, :, :off]), H[:, :, :-off]], dim=2)
            H, A = ph * A + H, A * pa
            off *= 2
        ea = torch.cat([torch.ones_like(A[:, :, :1]), A[:, :, :-1]], dim=2)
        eh = torch.cat([torch.zeros_like(H[:, :, :1]), H[:, :, :-1]], dim=2)
        hin = []
        for wp in range(nw):
            hin.append(carry)
            carry = A[:, wp, -1] * carry + H[:, wp, -1]
        hs = (ea * torch.stack(hin, dim=1)[:, :, None] + eh).reshape(bt, _NSEG, w)
        steps = []
        for j in range(_SEG):
            hs = a[:, :, j] * hs + x[:, :, j]
            steps.append(hs)
        out.append(torch.stack(steps, dim=2).reshape(bt, tile, w)[:, :n])
    return torch.cat(out, dim=1)


#: (bt, l, w, dtype, atol): the reference's 4 cases, the edge and long cases
#: the card runs, and the serving shape scaled down to W = 256
_ORDER_CASES = ([(bt, l, w, dtype, tol) for (bt, l, w, _, _, dtype, tol)
                 in ref.RGLRU_CASES + ref.RGLRU_EDGE_CASES]
                + [(2, 512, 256, "float32", 1e-5)])


@pytest.mark.parametrize("bt,l,w,dtype,tol", _ORDER_CASES)
def test_kernel_composition_order_vs_jax_oracle(bt, l, w, dtype, tol):
    """Serial segments, a scan across segments and the carry across tiles
    give the reference's recurrence at its tolerances."""
    log_a, b = _inputs(bt, l, w, dtype, seed=w + l)
    want = np.asarray(jrglru.scan_ref(jnp.asarray(log_a), jnp.asarray(b)))
    got = _kernel_order(torch.from_numpy(log_a), torch.from_numpy(b))
    assert got.shape == (bt, l, w)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-3)


@pytest.mark.parametrize("w,want", [(4096, "vec4"), (64, "vec4"), (100, "vec4"),
                                    (4, "vec4"), (6, "scalar"), (1, "scalar"),
                                    (30, "scalar")])
def test_variant_by_width(w, want):
    """float4 lanes wherever W % 4 == 0, 4-byte lanes otherwise."""
    assert rg.variant(w) == want
    assert want in rg.VARIANTS and want in ops.rglru_variant_launches


def test_variant_launch_counts_reset_with_the_launches():
    ops.rglru_variant_launches["vec4"] += 3
    ops.rglru_variant_launches["scalar"] += 1
    ops.launches["rglru_scan"] += 4
    ops.reset_launches()
    assert ops.rglru_variant_launches == dict.fromkeys(rg.VARIANTS, 0)
    assert ops.launches["rglru_scan"] == 0
    z = torch.zeros((1, 64, 32))
    ops.rglru_scan(z, z)                        # the plain version: no launch
    assert ops.rglru_variant_launches == dict.fromkeys(rg.VARIANTS, 0)
    assert ops.launches["rglru_scan"] == 0


def test_launcher_argtypes_match_the_entry_point():
    """ctypes passes each argument as its declared type: one c_void_p per
    pointer of the C entry point, one c_int per int (the variant included)."""
    src = (Path(rg.__file__).parent / "csrc" / "rglru_scan.cu").read_text()
    params = re.search(r'extern "C" int rglru_scan_fwd\((.*?)\)', src, re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in prm else ctypes.c_int for prm in params.split(",")]
    assert kinds == rg._ARGTYPES
    assert "int variant" in params


@pytest.mark.parametrize("l", [300, 512])
def test_prefill_scan_pads_untiled_lengths(l):
    """L > 256 that 256 does not divide is padded at the end and sliced; the
    result is the unpadded recurrence."""
    log_a, b = (torch.from_numpy(v) for v in _inputs(1, l, 8, "float32", seed=l))
    np.testing.assert_allclose(rglru._scan(log_a, b).numpy(),
                               ref.rglru_scan_ref(log_a, b).numpy(), atol=1e-6)


def test_numerics_helpers_match_jax_bit_for_bit():
    """gelu (tanh form) and softplus (logaddexp) op by op, as eager JAX."""
    x = np.random.default_rng(0).standard_normal(1 << 14).astype(np.float32) * 4
    for dtype, tdtype in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        with jax.disable_jit():
            gj = np.asarray(jax.nn.gelu(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
            sj = np.asarray(jax.nn.softplus(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
        xt = torch.from_numpy(x).to(tdtype)
        if dtype == jnp.bfloat16:
            np.testing.assert_array_equal(rglru.gelu(xt).float().numpy(), gj)
            np.testing.assert_array_equal(common.softplus(xt).float().numpy(), sj)
        else:
            np.testing.assert_allclose(rglru.gelu(xt).numpy(), gj, atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(common.softplus(xt).numpy(), sj, atol=1e-6, rtol=1e-6)


# ==========================================================================
# The RG-LRU block on converted weights
# ==========================================================================


def _block(dtype, seed=0):
    cfg = configs.get_smoke("recurrentgemma-9b").replace(compute_dtype=dtype)
    jcfg = jconfigs.get_smoke("recurrentgemma-9b").replace(compute_dtype=dtype)
    p_j = jrglru.init(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, p_j, to_torch(jax.tree.map(np.asarray, p_j), device="cpu")


@pytest.mark.parametrize("l", [24, 2])
def test_apply_with_state_and_decode_match_jax(l):
    """fp32 prefill output and state (L=2 is shorter than the conv tail),
    then two decode steps."""
    cfg, jcfg, p_j, p_t = _block("float32")
    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l, cfg.d_model)).astype(np.float32)
    out_j, st_j = jrglru.apply_with_state(p_j, jcfg, jnp.asarray(x))
    out_t, st_t = rglru.apply_with_state(p_t, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    assert set(st_t) == set(st_j) == {"h", "conv"}
    for k in st_j:
        assert st_t[k].shape == st_j[k].shape
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(rglru.apply(p_t, cfg, torch.from_numpy(x)).numpy(),
                                  out_t.numpy())
    for _ in range(2):
        xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        dj, st_j = jrglru.decode_step(p_j, jcfg, jnp.asarray(xd), st_j)
        dt_, st_t = rglru.decode_step(p_t, cfg, torch.from_numpy(xd), st_t)
        np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), atol=1e-5, rtol=1e-5)
        for k in st_j:
            np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                       atol=1e-5, rtol=1e-5)


def test_bf16_block_matches_eager_jax():
    cfg, jcfg, p_j, p_t = _block("bfloat16", seed=1)
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        out_j, st_j = jrglru.apply_with_state(p_j, jcfg, jnp.asarray(x).astype(jnp.bfloat16))
        dj, _ = jrglru.decode_step(p_j, jcfg, jnp.asarray(x[:, :1]).astype(jnp.bfloat16), st_j)
    out_t, st_t = rglru.apply_with_state(p_t, cfg, torch.from_numpy(x).bfloat16())
    dt_, _ = rglru.decode_step(p_t, cfg, torch.from_numpy(x[:, :1]).bfloat16(), st_t)
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(dt_.float().numpy(), np.asarray(dj.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)
    assert st_t["h"].dtype == torch.float32 and st_t["conv"].dtype == torch.bfloat16


def test_init_state_and_param_tree_match_jax():
    cfg = configs.get_smoke("recurrentgemma-9b")
    jcfg = jconfigs.get_smoke("recurrentgemma-9b")
    mine = rglru.init(torch.Generator().manual_seed(0), cfg, device="cpu", lead=(2,))
    theirs = jrglru.init(jax.random.PRNGKey(0), jcfg)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: (2,) + tuple(v.shape) for k, v in theirs.items()}
    np.testing.assert_allclose(mine["lam"][1].numpy(), np.asarray(theirs["lam"]), atol=1e-6)
    st = rglru.init_state(cfg, 3, device="cpu")
    st_j = jrglru.init_state(jcfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in st.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in st_j.items()}
