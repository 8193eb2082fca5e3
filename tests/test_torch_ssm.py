"""Port Mamba2: the plain SSD scan against the JAX package's Pallas kernel
(interpret mode) and its chunked oracle on the reference's kernel cases, the
wrapper's contract, the choice between the kernel's two variants and the mma
variant's numerics emulated on the CPU, and the SSM block (prefill with
state, decode step) on converted weights.  The CUDA kernels are held against
the plain version on a card in ``test_torch_cuda.py``."""

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
# The mma variant: its choice, its contract and its numerics on the CPU
# ==========================================================================


def _model_inputs(bt, l, h, p, n, dt0, seed):
    """numpy inputs in the model's recipe (:data:`ref.SSD_MMA_CASES`):
    A = −linspace(1, 16, H), dt = softplus(N(0,1) + log(expm1(dt0)))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, l, h, p), np.float32)
    z = rng.standard_normal((bt, l, h), np.float32) + np.float32(np.log(np.expm1(dt0)))
    dt = np.logaddexp(z, 0).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    return (x, dt, a, rng.standard_normal((bt, l, n), np.float32),
            rng.standard_normal((bt, l, n), np.float32))


def _block_scan(v):
    """Inclusive sum over the last axis (≤ 256) in the kernel's order: a
    Kogge-Stone scan in each warp of 32 lanes, the same over the warp
    totals, each lane then adding the totals of the warps before it."""
    q = v.shape[-1]
    nw = -(-q // 32)
    w = torch.nn.functional.pad(v, (0, nw * 32 - q)).reshape(*v.shape[:-1], nw, 32)

    def ks(t):
        d = 1
        while d < t.shape[-1]:
            t = torch.cat([t[..., :d], t[..., d:] + t[..., :-d]], -1)
            d *= 2
        return t

    w = ks(w)
    tot = ks(w[..., -1])
    w = torch.cat([w[..., :1, :], w[..., 1:, :] + tot[..., :-1, None]], -2)
    return w.reshape(*v.shape[:-1], nw * 32)[..., :q]


def _bf16(t):
    return t.bfloat16().float()


def _mma_numerics(x, dt, a, bm, cm, q, *, split=True):
    """The mma kernel's arithmetic on the CPU, rounding where it rounds:
    cum by the block scan; S_c = Σ_j (X ⊙ w)_j ⊗ B_j with X ⊙ w split into
    bf16 hi + lo (one bf16 rounding without ``split``); the carry in fp32;
    y = exp(cum_i)·(C_i · bf16(h_in)ᵀ) + bf16(masked scores) · X, fp32
    accumulation, y rounded to bf16.  The decay of a score is
    exp(cum_i − cum_j)·dt_j, or, for j before the first row i0 of the
    kernel's 128-row block when cum never rises, the factors
    exp(cum_i0 − cum_j)·dt_j and exp(cum_i − cum_i0)."""
    bt, l, h, p = x.shape
    n, nc = bm.shape[-1], l // q
    xc = x.float().reshape(bt, nc, q, h, p).permute(0, 1, 3, 2, 4)     # b c h q p
    dtc = dt.float().reshape(bt, nc, q, h).permute(0, 1, 3, 2)         # b c h q
    bc = bm.float().reshape(bt, nc, 1, q, n)
    cc = cm.float().reshape(bt, nc, 1, q, n)
    cum = _block_scan(dtc * a.float()[None, None, :, None])
    last = cum[..., -1:]
    xw = xc * (torch.exp(last - cum) * dtc)[..., None]
    hi = _bf16(xw)
    s_c = (hi.transpose(-1, -2) @ bc + _bf16(xw - hi).transpose(-1, -2) @ bc if split
           else hi.transpose(-1, -2) @ bc)                              # b c h p n
    gamma = torch.exp(last[..., 0])
    hcur, h_in = torch.zeros((bt, h, p, n)), []
    for c in range(nc):
        h_in.append(hcur)
        hcur = hcur * gamma[:, c, :, None, None] + s_c[:, c]
    acc = (cc @ _bf16(torch.stack(h_in, 1)).transpose(-1, -2)) * torch.exp(cum)[..., None]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool))
    seg = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    cb = cc @ bc.transpose(-1, -2)
    scores = cb * torch.exp(seg) * dtc[..., None, :]
    i0 = torch.arange(q) // 128 * 128                                   # block of row i
    decays = bool((a <= 0).all()) and bool((dt >= 0).all())
    if decays and q > 128:
        cref = cum[..., i0]                                             # cum_i0 per row
        colf = torch.exp(cref[..., :, None] - cum[..., None, :]) * dtc[..., None, :]
        factored = cb * colf * torch.exp(cum - cref)[..., None]
        below = torch.arange(q)[None, :] < i0[:, None]
        scores = torch.where(below, factored, scores)
    scores = torch.where(causal, scores, 0.0)
    acc = acc + _bf16(scores) @ xc
    return acc.permute(0, 1, 3, 2, 4).reshape(bt, l, h, p).bfloat16(), hcur


@pytest.mark.parametrize("p,n,q,dtype,want", [
    (64, 128, 256, "bfloat16", "mma"),      # mamba2-370m serving
    (16, 32, 32, "bfloat16", "mma"),        # the reference's bf16 case
    (128, 16, 16, "bfloat16", "mma"),
    (32, 112, 80, "bfloat16", "mma"),
    (64, 128, 256, "float32", "fma"),       # the 2e-4 fp32 tolerance
    (16, 32, 32, "float32", "fma"),
    (48, 128, 256, "bfloat16", "fma"),
    (64, 8, 256, "bfloat16", "fma"),
    (64, 24, 256, "bfloat16", "fma"),
    (64, 144, 256, "bfloat16", "fma"),
    (64, 128, 8, "bfloat16", "fma"),
    (64, 128, 100, "bfloat16", "fma"),
])
def test_variant_by_shape_and_dtype(p, n, q, dtype, want):
    """bf16 with P in {16, 32, 64, 128} and N, Q multiples of 16 up to 128
    and 256 runs on the tensor cores; everything else keeps the FMA kernel."""
    assert ssd.variant(p, n, q, _TORCH[dtype]) == want
    assert want in ssd.VARIANTS and want in ops.ssd_variant_launches


def test_variant_launch_counts_reset_with_the_launches():
    ops.ssd_variant_launches["mma"] += 2
    ops.launches["ssd_scan"] += 2
    ops.reset_launches()
    assert ops.ssd_variant_launches == dict.fromkeys(ssd.VARIANTS, 0)
    assert ops.launches["ssd_scan"] == 0
    _, t = _both(_inputs(1, 32, 2, 16, 16, seed=7), "bfloat16")
    ops.ssd_scan(*t, chunk=16)                  # the plain version: no launch
    assert ops.ssd_variant_launches == dict.fromkeys(ssd.VARIANTS, 0)


def test_launcher_argtypes_match_the_entry_point():
    """ctypes passes each argument as its declared type (a pointer cut to
    32 bits would crash on the card): one c_void_p per pointer of the C
    entry point, one c_int per int."""
    src = (Path(ssd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    params = re.search(r'extern "C" int ssd_scan_fwd\((.*?)\)', src, re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in prm else ctypes.c_int for prm in params.split(",")]
    assert kinds == ssd._ARGTYPES


def test_mma_call_on_cpu_tensors_is_refused_before_any_build():
    _, t = _both(_model_inputs(1, 64, 2, 64, 128, 0.01, seed=8), "bfloat16")
    assert ssd.variant(64, 128, 64, torch.bfloat16) == "mma"
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_fwd(*t, 64, return_state=True)


_MMA_EMULATED = ([(case, ref.ssd_dt0(case)) for case in ref.SSD_MMA_CASES]
                 + [((bt, l, h, p, n, chunk), None)
                    for (bt, l, h, p, n, chunk, dt, _) in ref.SSD_CASES if dt == "bfloat16"])


@pytest.mark.parametrize("case,dt0", _MMA_EMULATED, ids=str)
def test_mma_numerics_within_tolerance(case, dt0):
    """The mma variant's roundings keep y within 5e-2 and the final state
    within 2e-4 of the plain version (dt0 None: the reference test's recipe)."""
    bt, l, h, p, n, chunk = case
    q = min(chunk, l)
    assert ssd.variant(p, n, q, torch.bfloat16) == "mma"
    arrays = (_inputs(bt, l, h, p, n, seed=l + p) if dt0 is None
              else _model_inputs(bt, l, h, p, n, dt0, seed=l + p))
    _, t = _both(arrays, "bfloat16")
    y, h_last = _mma_numerics(*t, q)
    y_ref, h_ref = ref.ssd_chunked(*t, q)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h_last).all())
    np.testing.assert_allclose(_f32(y), _f32(y_ref), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(h_last.numpy(), h_ref.numpy(), atol=2e-4, rtol=2e-4)


def test_state_needs_the_hi_lo_split():
    """Why the kernel splits X ⊙ w: at the serving dims one bf16 rounding of
    it puts the final state outside 2e-4, the split brings it well inside."""
    case = (2, 512, 8, 64, 128, 256)
    _, t = _both(_model_inputs(*case[:5], ref.ssd_dt0(case), seed=case[1] + case[3]),
                 "bfloat16")
    _, h_ref = ref.ssd_chunked(*t, 256)
    err = [float((_mma_numerics(*t, 256, split=s)[1] - h_ref).abs().max())
           for s in (False, True)]
    assert err[0] > 2e-4 > 20 * err[1]


def test_rising_cum_limits_the_mma_numerics():
    """The mma variant is held to the reference's contract, a < 0.  Where a
    head's a > 0 lifts cum by under 1 in a chunk its roundings stay within
    5e-2; where cum rises by several units (a = 2), outputs grow and cancel,
    and one bf16 rounding of the scores no longer holds 5e-2."""
    _, t = _both(_model_inputs(1, 512, 4, 32, 64, 0.01, seed=9), "bfloat16")
    x, dt, _, bm, cm = t
    for a, holds in (([-8.0, -1.0, 0.05, 0.2], True), ([-8.0, -1.0, 0.5, 2.0], False)):
        a = torch.tensor(a)
        y, _ = _mma_numerics(x, dt, a, bm, cm, 256)
        y_ref, _ = ref.ssd_chunked(x, dt, a, bm, cm, 256)
        assert torch.allclose(y.float(), y_ref.float(), atol=5e-2, rtol=5e-2) == holds


def test_stress_case_drives_cum_past_the_overflow_of_exp():
    """In the stress case the steepest head's cum falls to between −100 and
    −200 within a chunk, so exp(−cum_j) is inf in fp32: the decay has to be
    exp(cum_i − cum_j), and the plain version stays finite."""
    bt, l, h, p, n, chunk = case = ref.SSD_STRESS_CASE
    arrays = _model_inputs(bt, l, h, p, n, ref.ssd_dt0(case), seed=l + p)
    _, t = _both(arrays, "bfloat16")
    cum = torch.cumsum((t[1] * t[2]).reshape(bt, l // chunk, chunk, h), dim=2)
    assert -200.0 < float(cum.min()) < -100.0
    assert bool(torch.isinf(torch.exp(-cum.min())))
    y, h_last = ref.ssd_chunked(*t, chunk)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h_last).all())


@pytest.mark.parametrize("case", ref.SSD_MMA_CASES, ids=str)
def test_plain_vs_jax_on_mma_cases(case):
    """The plain version against the JAX package's ssd_chunked on the mma
    variant's cases: y in bf16 at 5e-2, the final state at 2e-4."""
    bt, l, h, p, n, chunk = case
    j, t = _both(_model_inputs(bt, l, h, p, n, ref.ssd_dt0(case), seed=l + p), "bfloat16")
    y_j, h_j = jssm.ssd_chunked(*j, chunk)
    y_t, h_t = ref.ssd_chunked(*t, chunk)
    np.testing.assert_allclose(_f32(y_t), _f32(y_j), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=2e-4, rtol=2e-4)


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
