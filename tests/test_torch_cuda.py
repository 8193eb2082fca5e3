"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` finds no
card: a CUDA kernel has no CPU mode.  The file imports no JAX, so it also
runs on a machine with the card and without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.convert import tree_to  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models import flash, lm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train.commit import batch_to  # noqa: E402
from repro_torch.train.step import make_train_step, train_state_init  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,hkv,hd,window,cap,dtype,tol",
                         ref.FLASH_CASES + ref.FLASH_HD256_CASES)
def test_flash_kernel_vs_plain(card, b, l, h, hkv, hd, window, cap, dtype, tol):
    rng = np.random.default_rng(l + h)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, n, hd), np.float32))
               .to(getattr(torch, dtype)).to(card) for n in (h, hkv, hkv))
    n0 = ops.launches["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=True, window=window, softcap=cap,
                              block_q=128, block_k=128)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == n0 + 1
    expect = ref.flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap)
    np.testing.assert_allclose(out.float().cpu().numpy(), expect.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,hkv,hd,causal,window,cap", ref.FLASH_WGMMA_CASES)
def test_flash_wgmma_variant_vs_plain(card, b, l, h, hkv, hd, causal, window, cap):
    """bf16 on the tensor cores: every head dim 16–256, GQA groups 1–16, L not
    a multiple of the 128-row tile, window, softcap and the non-causal path."""
    rng = np.random.default_rng(l + h + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, n, hd), np.float32))
               .to(torch.bfloat16).to(card) for n in (h, hkv, hkv))
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                              block_q=l, block_k=l)
    torch.cuda.synchronize()
    assert ops.flash_variant_launches == {**n0, "wgmma": n0["wgmma"] + 1}
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(out.float().cpu().numpy(), expect.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype,want", [(64, "float32", "fma"), (8, "bfloat16", "fma"),
                                           (128, "bfloat16", "wgmma")])
def test_flash_variant_launch_counts(card, hd, dtype, want):
    q = torch.randn((1, 128, 4, hd), device=card).to(getattr(torch, dtype))
    n0 = dict(ops.flash_variant_launches)
    ops.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    torch.cuda.synchronize()
    assert ops.flash_variant_launches == {**n0, want: n0[want] + 1}


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 64, 4, 64), device=card)
    strided = torch.zeros((1, 4, 64, 64), device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(strided, q, q)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-27b", "mamba2-370m", "recurrentgemma-9b"])
def test_smoke_model_on_card_matches_cpu(card, arch):
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 23), generator=torch.Generator().manual_seed(1))
    _, want = lm.prefill(params, cfg, toks, max_len=30)
    _, got = lm.prefill(tree_to(params, card), cfg, toks.to(card), max_len=30)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("l,causal,window", [(100, True, 0), (100, True, 40),
                                             (192, False, 0)])
def test_flash_kernel_ragged_tiles_and_non_causal(card, l, causal, window):
    """L not a multiple of the kernel's 64-row tile, and the non-causal path."""
    rng = np.random.default_rng(l)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, l, n, 64), np.float32)).to(card)
               for n in (8, 2, 2))
    out = ops.flash_attention(q, k, v, causal=causal, window=window, block_q=l, block_k=l)
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.cpu().numpy(), expect.cpu().numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,hkv,hd,window,dtype,tol", ref.FLASH_WINDOW_CASES)
def test_flash_window_without_causal_vs_plain(card, b, l, h, hkv, hd, window, dtype, tol):
    """Both variants apply the window without causal masking, as the
    reference's kernel does: fp32 on the fma variant, bf16 at hd 64–256 on
    wgmma; whole key tiles fall before the later rows' windows."""
    rng = np.random.default_rng(l + hd + window)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, n, hd), np.float32))
               .to(getattr(torch, dtype)).to(card) for n in (h, hkv, hkv))
    want = "fma" if dtype == "float32" else "wgmma"
    assert fa.variant(hd, q.dtype) == want
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=False, window=window, block_q=l, block_k=l)
    torch.cuda.synchronize()
    assert ops.flash_variant_launches == {**n0, want: n0[want] + 1}
    expect = ref.flash_attention_plain(q, k, v, causal=False, window=window)
    np.testing.assert_allclose(out.float().cpu().numpy(), expect.float().cpu().numpy(),
                               atol=tol, rtol=tol)


def _ssd_inputs(bt, l, h, p, n, dtype, seed, device):
    """The reference test's input recipe (tests/test_kernels.py), from numpy."""
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dt_).to(device)
    x = t((bt, l, h, p))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((bt, l, h), np.float32))).to(device)
    a = -torch.exp(torch.linspace(0.0, 2.0, h)).to(device)
    return x, dt, a, t((bt, l, n)), t((bt, l, n))


@pytest.mark.cuda
@pytest.mark.parametrize("bt,l,h,p,n,chunk,dtype,tol", ref.SSD_CASES)
def test_ssd_kernel_vs_plain(card, bt, l, h, p, n, chunk, dtype, tol):
    x, dt, a, bm, cm = _ssd_inputs(bt, l, h, p, n, dtype, l + p, card)
    n0 = ops.launches["ssd_scan"]
    y, h_last = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan"] == n0 + 1 and y.dtype == x.dtype
    y_ref, h_ref = ref.ssd_chunked(x, dt, a, bm, cm, min(chunk, l))
    np.testing.assert_allclose(y.float().cpu().numpy(), y_ref.float().cpu().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(h_last.cpu().numpy(), h_ref.cpu().numpy(),
                               atol=2e-4, rtol=2e-4)
    y_only = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    np.testing.assert_array_equal(y_only.float().cpu().numpy(), y.float().cpu().numpy())


def _ssd_model_inputs(bt, l, h, p, n, dt0, seed, device):
    """The model's recipe (ref.SSD_MMA_CASES), from numpy as in
    test_torch_ssm.py: A = −linspace(1, 16, H), dt = softplus(N(0,1) +
    log(expm1(dt0)))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, l, h, p), np.float32)
    z = rng.standard_normal((bt, l, h), np.float32) + np.float32(np.log(np.expm1(dt0)))
    dt = np.logaddexp(z, 0).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm, cm = (rng.standard_normal((bt, l, n), np.float32) for _ in range(2))
    bf = lambda v: torch.from_numpy(v).to(torch.bfloat16).to(device)  # noqa: E731
    return bf(x), torch.from_numpy(dt).to(device), torch.from_numpy(a).to(device), \
        bf(bm), bf(cm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ref.SSD_MMA_CASES, ids=str)
def test_ssd_mma_variant_vs_plain(card, case):
    """bf16 on the tensor cores: P 16–128, N 16–128, Q 16–256, one to 8
    chunks, the serving dims and the stress case; y at 5e-2, state at 2e-4."""
    bt, l, h, p, n, chunk = case
    x, dt, a, bm, cm = _ssd_model_inputs(bt, l, h, p, n, ref.ssd_dt0(case), l + p, card)
    if case == ref.SSD_STRESS_CASE:
        cum = torch.cumsum((dt * a).reshape(bt, l // chunk, chunk, h), dim=2)
        assert -200.0 < float(cum.min()) < -100.0
    n0 = dict(ops.ssd_variant_launches)
    y, h_last = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ops.ssd_variant_launches == {**n0, "mma": n0["mma"] + 1}
    y_ref, h_ref = ref.ssd_chunked(x, dt, a, bm, cm, chunk)
    np.testing.assert_allclose(y.float().cpu().numpy(), y_ref.float().cpu().numpy(),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(h_last.cpu().numpy(), h_ref.cpu().numpy(),
                               atol=2e-4, rtol=2e-4)
    y_only = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    np.testing.assert_array_equal(y_only.float().cpu().numpy(), y.float().cpu().numpy())


@pytest.mark.cuda
def test_ssd_mma_where_cum_rises(card):
    """Heads with a > 0 (cum rises within a chunk) take exp(cum_i − cum_j) in
    every tile: the factored decay below a block's rows holds only for a ≤ 0
    and dt ≥ 0.  cum rises by under 1 here; where it rises by several
    units, outputs grow and cancel beyond what the bf16 scores hold
    (test_torch_ssm.py::test_rising_cum_limits_the_mma_numerics)."""
    x, dt, _, bm, cm = _ssd_model_inputs(1, 512, 4, 32, 64, 0.01, 9, card)
    a = torch.tensor([-8.0, -1.0, 0.05, 0.2], device=card)
    y, h_last = ops.ssd_scan(x, dt, a, bm, cm, chunk=256, return_state=True)
    y_ref, h_ref = ref.ssd_chunked(x, dt, a, bm, cm, 256)
    np.testing.assert_allclose(y.float().cpu().numpy(), y_ref.float().cpu().numpy(),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(h_last.cpu().numpy(), h_ref.cpu().numpy(),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,chunk,dtype,want", [
    (64, 128, 256, "bfloat16", "mma"), (16, 32, 32, "bfloat16", "mma"),
    (64, 128, 256, "float32", "fma"), (64, 8, 64, "bfloat16", "fma"),
    (32, 64, 40, "bfloat16", "fma")])
def test_ssd_variant_launch_counts(card, p, n, chunk, dtype, want):
    x, dt, a, bm, cm = _ssd_inputs(1, 2 * chunk, 2, p, n, dtype, 5, card)
    n0, k0 = dict(ops.ssd_variant_launches), ops.launches["ssd_scan"]
    ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_variant_launches == {**n0, want: n0[want] + 1}
    assert ops.launches["ssd_scan"] == k0 + 1


@pytest.mark.cuda
def test_ssd_mma_refuses_misaligned_inputs(card):
    """The mma variant's copies move 16 bytes: a tensor that starts off a
    16-byte boundary is refused, not sent to the other variant."""
    x, dt, a, bm, cm = _ssd_inputs(1, 64, 2, 64, 32, "bfloat16", 6, card)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)[1:].view(x.shape)
    shifted.copy_(x)
    n0 = dict(ops.ssd_variant_launches)
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan(shifted, dt, a, bm, cm, chunk=64)
    assert ops.ssd_variant_launches == n0


@pytest.mark.cuda
def test_ssd_kernel_chunk_invariance_and_ragged(card):
    x, dt, a, bm, cm = _ssd_inputs(1, 256, 2, 16, 32, "float32", 3, card)
    y32 = ops.ssd_scan(x, dt, a, bm, cm, chunk=32)
    y128 = ops.ssd_scan(x, dt, a, bm, cm, chunk=128)
    np.testing.assert_allclose(y32.cpu().numpy(), y128.cpu().numpy(), atol=5e-4, rtol=5e-4)
    with pytest.raises(ValueError):
        ops.ssd_scan(x[:, :100], dt[:, :100], a, bm[:, :100], cm[:, :100], chunk=64)


#: (bt, l, w, bl, bw, dtype, atol): the reference's 4 cases, the edge and
#: long cases, and the recurrentgemma-9b serving shape
_RGLRU_CARD_CASES = (ref.RGLRU_CASES + ref.RGLRU_EDGE_CASES
                     + [(4, 512, 4096, 256, 256, "float32", 1e-5)])


def _rglru_inputs(bt, l, w, dtype, seed, device):
    rng = np.random.default_rng(seed)
    log_a = -torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((bt, l, w), np.float32))).to(device)
    b = (torch.from_numpy(rng.standard_normal((bt, l, w), np.float32))
         .to(getattr(torch, dtype)).float() * 0.1).to(device)
    return log_a, b


@pytest.mark.cuda
@pytest.mark.parametrize("bt,l,w,bl,bw,dtype,tol", _RGLRU_CARD_CASES)
def test_rglru_kernel_vs_plain(card, bt, l, w, bl, bw, dtype, tol):
    log_a, b = _rglru_inputs(bt, l, w, dtype, w + l, card)
    want = rg.variant(w)
    n0, v0 = ops.launches["rglru_scan"], dict(ops.rglru_variant_launches)
    h = ops.rglru_scan(log_a, b, block_l=bl, block_w=bw)
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan"] == n0 + 1 and h.dtype == torch.float32
    assert ops.rglru_variant_launches == {**v0, want: v0[want] + 1}
    np.testing.assert_allclose(h.cpu().numpy(), ref.rglru_scan_ref(log_a, b).cpu().numpy(),
                               atol=tol, rtol=1e-3)
    if bl < l:
        with pytest.raises(ValueError):
            ops.rglru_scan(log_a[:, :l - 1], b[:, :l - 1], block_l=bl, block_w=bw)


@pytest.mark.cuda
def test_rglru_vec4_refuses_misaligned_inputs(card):
    """The vec4 variant loads 16 bytes at a time: an input that starts off a
    16-byte boundary is refused, not sent to the scalar variant."""
    log_a, b = _rglru_inputs(1, 64, 32, "float32", 7, card)
    shifted = torch.empty(b.numel() + 1, device=card)[1:].view(b.shape)
    shifted.copy_(b)
    v0 = dict(ops.rglru_variant_launches)
    with pytest.raises(ValueError, match="16-byte"):
        ops.rglru_scan(log_a, shifted)
    assert ops.rglru_variant_launches == v0


# ---- the training path: lse, the Function's gradients, refusals, a step ------

#: (b, l, h, hkv, hd, window, cap, dtype, tol): the fp32 reference cases on
#: the fma variant, and bf16 at hd 64, 128 and 256 on wgmma; lse at 1e-5
#: (fma) and 1e-4 (wgmma, whose exponentials are ex2.approx)
_LSE_CASES = ([c for c in ref.FLASH_CASES if c[7] == "float32"]
              + [(2, 256, 8, 4, 64, 0, 0.0, "bfloat16", 1e-4),
                 (1, 576, 32, 4, 128, 0, 50.0, "bfloat16", 1e-4),
                 (1, 256, 4, 1, 256, 64, 0.0, "bfloat16", 1e-4)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,hkv,hd,window,cap,dtype,tol", _LSE_CASES)
def test_flash_lse_vs_plain(card, b, l, h, hkv, hd, window, cap, dtype, tol):
    """Both variants store each row's log-sum-exp when asked; the output is
    the same as without it, bit for bit."""
    rng = np.random.default_rng(l + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, n, hd), np.float32))
               .to(getattr(torch, dtype)).to(card) for n in (h, hkv, hkv))
    kw = dict(causal=True, window=window, softcap=cap, block_q=l, block_k=l)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
    _, want = ref.flash_attention_plain_lse(q, k, v, causal=True, window=window, softcap=cap)
    assert lse.shape == (b, h, l) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_flash_function_grads_vs_plain_autograd(card, dtype, tol):
    """The Function (kernel forward, FA2 backward) against autograd through
    the dense plain version in fp32 on the same bf16-exact inputs: fp32 on
    the fma variant at 1e-4; bf16 on wgmma (hd 128) at 3e-2, the
    reference's bf16 model tolerance, as the gradients are rounded to
    bf16."""
    rng = np.random.default_rng(11)
    base = [torch.from_numpy(rng.standard_normal((2, 256, n, 128), np.float32))
            .to(getattr(torch, dtype)).to(card) for n in (8, 2, 2, 8)]
    q, k, v = (t.clone().requires_grad_() for t in base[:3])
    n0 = dict(ops.flash_variant_launches)
    flash.flash_attention(q, k, v, window=100, softcap=30.0).backward(base[3])
    want = fa.variant(128, q.dtype)
    assert ops.flash_variant_launches == {**n0, want: n0[want] + 1}
    q2, k2, v2 = (t.float().requires_grad_() for t in base[:3])
    ref.flash_attention_plain(q2, k2, v2, window=100, softcap=30.0).backward(base[3].float())
    for a, b in ((q, q2), (k, k2), (v, v2)):
        np.testing.assert_allclose(a.grad.float().cpu().numpy(), b.grad.cpu().numpy(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernels_refuse_a_gradient_they_would_drop(card):
    """The flash wrapper outside the flash Function still refuses inputs
    that need a gradient; the scans now carry one, through their backward
    kernels, down to a smoke mamba2's embedding."""
    x, dt, a, bm, cm = _ssd_inputs(1, 64, 2, 16, 16, "float32", 3, card)
    n0 = ops.launches["ssd_scan_bwd"]
    ops.ssd_scan(x.requires_grad_(), dt, a, bm, cm, chunk=32).sum().backward()
    assert ops.launches["ssd_scan_bwd"] == n0 + 1 and bool(x.grad.abs().sum() > 0)
    with torch.no_grad():
        ops.ssd_scan(x, dt, a, bm, cm, chunk=32)
    assert ops.launches["ssd_scan_bwd"] == n0 + 1
    log_a, b = _rglru_inputs(1, 64, 32, "float32", 7, card)
    n0 = ops.launches["rglru_scan_bwd"]
    ops.rglru_scan(log_a, b.requires_grad_()).sum().backward()
    assert ops.launches["rglru_scan_bwd"] == n0 + 1 and bool(b.grad.abs().sum() > 0)
    q = torch.zeros((1, 64, 4, 64), device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="models.flash"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    cfg = configs.get_smoke("mamba2-370m")
    params = lm.init(torch.Generator(device=card).manual_seed(0), cfg, device=card)
    params["embed"].requires_grad_()
    lm.loss_fn(params, cfg, batch_to(make_batch(cfg, 32, 2), card))[0].backward()
    assert bool(torch.isfinite(params["embed"].grad).all())


def _rglru_bwd_check(log_a, b, dh, la, bb):
    d_la, d_b = ref.rglru_scan_bwd_plain(log_a, b, dh)
    for got, want in ((la.grad, d_la), (bb.grad, d_b)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bt,l,w,bl,bw,dtype,tol", ref.RGLRU_CASES + ref.RGLRU_EDGE_CASES)
def test_rglru_bwd_kernel_vs_plain(card, bt, l, w, bl, bw, dtype, tol):
    """The RG-LRU Function (kernel forward and backward) against autograd
    of the plain version at atol = rtol = 1e-4; the backward runs the
    variant its width picks, once."""
    log_a, b = _rglru_inputs(bt, l, w, dtype, w + l + 1, card)
    dh = torch.from_numpy(np.random.default_rng(w).standard_normal((bt, l, w))
                          .astype(np.float32)).to(card)
    la, bb = log_a.clone().requires_grad_(), b.clone().requires_grad_()
    want = rg.variant(w)
    v0 = dict(ops.rglru_bwd_variant_launches)
    ops.rglru_scan(la, bb, block_l=l, block_w=w).backward(dh)
    torch.cuda.synchronize()
    assert ops.rglru_bwd_variant_launches == {**v0, want: v0[want] + 1}
    _rglru_bwd_check(log_a, b, dh, la, bb)


@pytest.mark.cuda
def test_rglru_bwd_through_a_padded_length(card):
    """models/rglru._scan pads L = 300 to 512 (log_a = 0, b = 0): the
    padding's gradient stays out of the real rows."""
    from repro_torch.models import rglru
    log_a, b = _rglru_inputs(2, 300, 64, "float32", 5, card)
    dh = torch.randn((2, 300, 64), device=card)
    la, bb = log_a.clone().requires_grad_(), b.clone().requires_grad_()
    rglru._scan(la, bb).backward(dh)
    _rglru_bwd_check(log_a, b, dh, la, bb)


@pytest.mark.cuda
@pytest.mark.parametrize("w,want", [(4096, "vec4"), (64, "vec4"), (100, "vec4"),
                                    (6, "scalar"), (30, "scalar")])
def test_rglru_bwd_variant_launch_counts(card, w, want):
    log_a, b = _rglru_inputs(1, 64, w, "float32", 3, card)
    h = ops.rglru_scan(log_a, b)
    n0, v0 = ops.launches["rglru_scan_bwd"], dict(ops.rglru_bwd_variant_launches)
    ops.rglru_scan_bwd(log_a, h, torch.ones_like(h))
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan_bwd"] == n0 + 1
    assert ops.rglru_bwd_variant_launches == {**v0, want: v0[want] + 1}


def _ssd_bwd_check(args, chunk, with_state, card):
    """The SSD Function against autograd of the plain version: fp32 dx, dB,
    dC at atol = rtol = 1e-4; bf16 ones at rtol 1e-2 (one bf16 rounding)
    and atol 1e-3 of their largest value; ddt and da at 1e-4 relative, atol
    1e-4 of their largest value (sums of many terms)."""
    x = args[0]
    rng = np.random.default_rng(x.shape[1])
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(x.dtype).to(card)
    dh = (torch.from_numpy(rng.standard_normal((x.shape[0], x.shape[2], x.shape[3],
                                                args[3].shape[-1])).astype(np.float32))
          .to(card) if with_state else None)
    leaves = [t.clone().requires_grad_() for t in args]
    n0 = ops.launches["ssd_scan_bwd"]
    y, h_last = ops.ssd_scan(*leaves, chunk=chunk, return_state=True)
    torch.autograd.backward([y, h_last] if with_state else [y],
                            [dy, dh] if with_state else [dy])
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan_bwd"] == n0 + 1
    want = ref.ssd_scan_bwd_plain(*args, min(chunk, x.shape[1]), dy, dh)
    for name, leaf, w in zip(("dx", "ddt", "da", "dB", "dC"), leaves, want):
        got, w = leaf.grad.float().cpu().numpy(), w.float().cpu().numpy()
        assert leaf.grad.dtype == leaf.dtype
        scale = float(np.abs(w).max())
        if name in ("ddt", "da"):
            np.testing.assert_allclose(got, w, atol=1e-4 * scale, rtol=1e-4, err_msg=name)
        elif x.dtype == torch.bfloat16:
            np.testing.assert_allclose(got, w, atol=1e-3 * scale, rtol=1e-2, err_msg=name)
        else:
            np.testing.assert_allclose(got, w, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,l,h,p,n,chunk,_dtype,tol", ref.SSD_CASES)
def test_ssd_bwd_kernel_vs_plain(card, bt, l, h, p, n, chunk, _dtype, tol, dtype, with_state):
    _ssd_bwd_check(_ssd_inputs(bt, l, h, p, n, dtype, l + p, card), chunk, with_state, card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ref.SSD_MMA_CASES, ids=str)
def test_ssd_bwd_kernel_vs_plain_on_mma_cases(card, case, dtype):
    """P 16–128, N 16–128, Q 16–256, 1–8 chunks and the stress case, whose
    cum passes −100: the decay is taken only where j ≤ i."""
    bt, l, h, p, n, chunk = case
    args = list(_ssd_model_inputs(bt, l, h, p, n, ref.ssd_dt0(case), l + p, card))
    for i in (0, 3, 4):
        args[i] = args[i].to(getattr(torch, dtype))
    _ssd_bwd_check(args, chunk, True, card)


@pytest.mark.cuda
def test_bwd_entry_points_bind_with_their_argtypes(card):
    """Both backward entry points load from the built libraries with the
    argtypes the launchers declare."""
    from repro_torch.kernels import ssd_scan as ssd
    assert rg._lib("rglru_scan_bwd", rg._BWD_ARGTYPES).argtypes == rg._BWD_ARGTYPES
    assert ssd._lib("ssd_scan_bwd", "ssd_scan_bwd", ssd._BWD_ARGTYPES).argtypes == \
        ssd._BWD_ARGTYPES


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_train_step_on_card_matches_cpu(card, arch):
    """One fp32 step of a smoke recurrent arch on the card (the scans'
    kernels, forward and backward) against the CPU (their plain versions)
    from the same state: loss, gradient norm and parameters at 1e-4."""
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32", remat="dots")
    state = train_state_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = make_batch(cfg, 64, 2)
    want_state, want = make_train_step(cfg, lr=1e-3)(state, batch_to(batch, "cpu"))
    ops.reset_launches()
    got_state, got = make_train_step(cfg, lr=1e-3)(tree_to(state, card), batch_to(batch, card))
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan_bwd"] + ops.launches["rglru_scan_bwd"] > 0
    for key in ("loss", "grad_norm"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-4, abs=1e-4)
    for a, b in zip(tree_leaves(got_state["params"]), tree_leaves(want_state["params"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("dots", 2), ("full", 2)])
def test_train_step_on_card_matches_cpu(card, remat, per_layer):
    """One fp32 step of the yi-9b smoke config on the card against the CPU
    from the same state: loss, gradient norm and parameters at 1e-4 (the
    embedding's backward accumulates in no fixed order on the card); the
    flash launches are one per layer, two under remat."""
    cfg = configs.get_smoke("yi-9b").replace(compute_dtype="float32", remat=remat)
    state = train_state_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = make_batch(cfg, 64, 2)
    want_state, want = make_train_step(cfg, lr=1e-3)(state, batch_to(batch, "cpu"))
    ops.reset_launches()
    got_state, got = make_train_step(cfg, lr=1e-3)(tree_to(state, card), batch_to(batch, card))
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == per_layer * cfg.n_layers
    for key in ("loss", "grad_norm"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-4, abs=1e-4)
    for a, b in zip(tree_leaves(got_state["params"]), tree_leaves(want_state["params"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4, rtol=1e-4)
