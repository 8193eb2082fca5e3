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
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models import flash, lm, moe  # noqa: E402
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
                         ref.FLASH_CASES + ref.FLASH_HD256_CASES + ref.FLASH_HD96_CASES)
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
    """bf16 on the tensor cores: every head dim 16–256 (96 included), GQA
    groups 1–16, L not a multiple of the 128-row tile, window, softcap and
    the non-causal path."""
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
                                           (128, "bfloat16", "wgmma"), (96, "bfloat16", "wgmma"),
                                           (96, "float32", "fma")])
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
@pytest.mark.parametrize("arch", ["gemma2-27b", "mamba2-370m", "recurrentgemma-9b",
                                  "deepseek-moe-16b", "dbrx-132b", "phi-3-vision-4.2b",
                                  "seamless-m4t-medium"])
def test_smoke_model_on_card_matches_cpu(card, arch):
    """fp32 prefill logits, card against CPU; the VLM with its patch prefix,
    the enc-dec config with 25 frames (not a multiple of a 64-row tile)."""
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 23), generator=gen)
    modal = {}
    if cfg.n_patches:
        modal["patches"] = torch.randn((2, cfg.n_patches, 1024), generator=gen)
    if cfg.frame_input:
        modal["frames"] = torch.randn((2, 25, 1024), generator=gen)
    max_len = 30 + cfg.n_patches
    _, want = lm.prefill(params, cfg, toks, max_len=max_len, **modal)
    _, got = lm.prefill(tree_to(params, card), cfg, toks.to(card), max_len=max_len,
                        **tree_to(modal, card))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [512, 1088])
def test_flash_at_phi3_vision_prefill_shapes(card, l):
    """phi-3-vision-4.2b's prefill attention, q/k/v [4, L, 32, 96] bf16 (L
    512 text only, 1088 with the 576-patch prefix), runs the wgmma variant
    within 2e-2 of the plain version."""
    rng = np.random.default_rng(l)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, l, 32, 96), np.float32))
               .to(torch.bfloat16).to(card) for _ in range(3))
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert ops.flash_variant_launches == {**n0, "wgmma": n0["wgmma"] + 1}
    expect = ref.flash_attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), expect.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


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

#: (b, l, h, hkv, hd, window, cap, dtype, tol): the fp32 reference cases and
#: hd 96 on the fma variant, and bf16 at hd 64, 96, 128 and 256 on wgmma;
#: lse at 1e-5 (fma) and 1e-4 (wgmma, whose exponentials are ex2.approx)
_LSE_CASES = ([c for c in ref.FLASH_CASES + ref.FLASH_HD96_CASES if c[7] == "float32"]
              + [(2, 256, 8, 4, 64, 0, 0.0, "bfloat16", 1e-4),
                 (1, 576, 32, 8, 96, 0, 50.0, "bfloat16", 1e-4),
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
    1e-4 of their largest value (sums of many terms).  bf16 runs the mma
    backward, fp32 the fma one."""
    x = args[0]
    rng = np.random.default_rng(x.shape[1])
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(x.dtype).to(card)
    dh = (torch.from_numpy(rng.standard_normal((x.shape[0], x.shape[2], x.shape[3],
                                                args[3].shape[-1])).astype(np.float32))
          .to(card) if with_state else None)
    leaves = [t.clone().requires_grad_() for t in args]
    n0, v0 = ops.launches["ssd_scan_bwd"], dict(ops.ssd_bwd_variant_launches)
    y, h_last = ops.ssd_scan(*leaves, chunk=chunk, return_state=True)
    torch.autograd.backward([y, h_last] if with_state else [y],
                            [dy, dh] if with_state else [dy])
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan_bwd"] == n0 + 1
    kind = "mma" if x.dtype == torch.bfloat16 else "fma"    # every case is in the mma domain
    assert ssd.bwd_variant(x.shape[3], args[3].shape[-1], min(chunk, x.shape[1]), x.dtype) == kind
    assert ops.ssd_bwd_variant_launches == {**v0, kind: v0[kind] + 1}
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
    assert rg._lib("rglru_scan_bwd", rg._BWD_ARGTYPES).argtypes == rg._BWD_ARGTYPES
    assert ssd._lib("ssd_scan_bwd", "ssd_scan_bwd", ssd._BWD_ARGTYPES).argtypes == \
        ssd._BWD_ARGTYPES
    assert ssd._lib("ssd_scan_bwd_mma", "ssd_scan_bwd_mma", ssd._BWD_MMA_ARGTYPES).argtypes == \
        ssd._BWD_MMA_ARGTYPES


def _ssd_bwd_args(card, bt=1, l=512, h=8, p=64, n=128, dtype="bfloat16", seed=31):
    x, dt, a, bm, cm = _ssd_model_inputs(bt, l, h, p, n, 0.01, seed, card)
    x, bm, cm = (t.to(getattr(torch, dtype)) for t in (x, bm, cm))
    rng = np.random.default_rng(seed)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(x.dtype).to(card)
    dh = torch.from_numpy(rng.standard_normal((bt, h, p, n)).astype(np.float32)).to(card)
    return x, dt, a, bm, cm, dy, dh


@pytest.mark.cuda
@pytest.mark.parametrize("most", [None, 1, 2, 8])
def test_ssd_bwd_mma_launches_are_bit_identical(card, most, monkeypatch):
    """No atomics: two launches of the mma backward on the same inputs give
    the same bits, whatever the heads per block (H = 8 heads, at most
    ``most`` a block; None: the default)."""
    if most is not None:
        monkeypatch.setattr(ssd, "BWD_HEADS_PER_BLOCK", most)
    x, dt, a, bm, cm, dy, dh = _ssd_bwd_args(card)
    first = ops.ssd_scan_bwd(x, dt, a, bm, cm, 256, dy, dh)
    second = ops.ssd_scan_bwd(x, dt, a, bm, cm, 256, dy, dh)
    torch.cuda.synchronize()
    for name, u, v in zip(("dx", "ddt", "da", "dB", "dC"), first, second):
        assert torch.equal(u, v), name


@pytest.mark.cuda
def test_ssd_bwd_mma_heads_per_block_only_regroups_sums(card, monkeypatch):
    """The head groups change the order dB and dC are summed in, nothing
    else: each grouping of H = 8 heads (1, 4, 8, and 2 where at most 3 are
    allowed) holds the plain version's tolerances, and dx, ddt and da are
    the same bits."""
    x, dt, a, bm, cm, dy, dh = _ssd_bwd_args(card)
    want = ref.ssd_scan_bwd_plain(x, dt, a, bm, cm, 256, dy, dh)
    outs = []
    for most, group in ((1, 1), (4, 4), (8, 8), (3, 2)):
        monkeypatch.setattr(ssd, "BWD_HEADS_PER_BLOCK", most)
        assert ssd.bwd_heads_per_block(x.shape[2]) == group
        outs.append(ops.ssd_scan_bwd(x, dt, a, bm, cm, 256, dy, dh))
    for got in outs:
        for name, u, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
            u, w = u.float().cpu().numpy(), w.float().cpu().numpy()
            scale = float(np.abs(w).max())
            tol = (1e-4, 1e-4) if name in ("ddt", "da") else (1e-3, 1e-2)
            np.testing.assert_allclose(u, w, atol=tol[0] * scale, rtol=tol[1], err_msg=name)
        for u, v in zip(got[:3], outs[0][:3]):
            assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,chunk,dtype,want", [
    (64, 128, 256, "bfloat16", "mma"), (16, 32, 32, "bfloat16", "mma"),
    (64, 128, 256, "float32", "fma"), (64, 8, 64, "bfloat16", "fma"),
    (32, 64, 40, "bfloat16", "fma")])
def test_ssd_bwd_variant_launch_counts(card, p, n, chunk, dtype, want):
    """bf16 at mamba2's dims runs the mma backward, fp32 and shapes outside
    its domain the fma one: one launch, counted under its variant."""
    x, dt, a, bm, cm = _ssd_inputs(1, 2 * chunk, 2, p, n, dtype, 5, card)
    dy = torch.ones_like(x)
    n0, v0 = ops.launches["ssd_scan_bwd"], dict(ops.ssd_bwd_variant_launches)
    ops.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy)
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan_bwd"] == n0 + 1
    assert ops.ssd_bwd_variant_launches == {**v0, want: v0[want] + 1}


@pytest.mark.cuda
def test_ssd_bwd_mma_refuses_misaligned_dy(card):
    """The mma backward moves dy and dh_last 16 bytes at a time: a tensor
    off a 16-byte boundary is refused, not sent to the other variant."""
    x, dt, a, bm, cm, dy, dh = _ssd_bwd_args(card, l=256, h=2)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)[1:].view(t.shape)
        return out.copy_(t)
    v0 = dict(ops.ssd_bwd_variant_launches)
    for args in ((shifted(dy), None), (dy, shifted(dh))):
        with pytest.raises(ValueError, match="16-byte"):
            ops.ssd_scan_bwd(x, dt, a, bm, cm, 256, *args)
    assert ops.ssd_bwd_variant_launches == v0


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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_moe_forward_on_card_matches_cpu(card, arch):
    """The MoE smoke configs' forward in fp32 on the card (flash kernel,
    plain dispatch and expert products) against the CPU: logits and the
    aux loss at 1e-4, one flash launch a layer."""
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(1))
    want, want_aux = lm.forward(params, cfg, toks)
    n0 = ops.launches["flash_attention"]
    got, got_aux = lm.forward(tree_to(params, card), cfg, toks.to(card))
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == n0 + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-4, abs=1e-4)


@pytest.mark.cuda
def test_moe_dispatch_on_card_matches_cpu_with_drops(card):
    """deepseek-moe-16b's 64 experts and top-6 over 2048 tokens whose router
    sends every token to experts 0–5 first: the card's sort, ranks, drop
    flags and buffer rows equal the CPU's bit for bit, and the layer's
    output agrees in fp32."""
    cfg = configs.get_smoke("deepseek-moe-16b").replace(
        compute_dtype="float32", moe=configs.get("deepseek-moe-16b").moe)
    p = moe.init(torch.Generator().manual_seed(2), cfg, device="cpu")
    x = torch.randn((4, 512, cfg.d_model), generator=torch.Generator().manual_seed(3))
    x[..., 0] += 4.0
    p["router"][0, :6] += torch.arange(12.0, 6.0, -1.0)
    cap = moe.capacity(2048, cfg)
    ids, _ = moe.route(p, cfg, x.reshape(-1, cfg.d_model))
    want = moe.dispatch(ids, cfg.moe.num_experts, cap)
    assert not want["kept"].all()
    ids_card, _ = moe.route(tree_to(p, card), cfg, x.to(card).reshape(-1, cfg.d_model))
    got = moe.dispatch(ids_card, cfg.moe.num_experts, cap)
    assert torch.equal(ids_card.cpu(), ids)
    for key in ("order", "expert", "pos", "kept", "row"):
        assert torch.equal(got[key].cpu(), want[key]), key
    np.testing.assert_allclose(moe.apply_ref(tree_to(p, card), cfg, x.to(card)).cpu().numpy(),
                               moe.apply_ref(p, cfg, x).numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_at_the_deepseek_serving_shape_runs_wgmma(card):
    """MHA (G = 1) at hd 128, q/k/v [4, 512, 16, 128] bf16, causal: the
    wgmma variant, within 2e-2 of the plain version."""
    cfg = configs.get("deepseek-moe-16b")
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 512, n, cfg.hd), np.float32))
               .to(torch.bfloat16).to(card) for n in (cfg.n_heads, cfg.n_kv_heads,
                                                      cfg.n_kv_heads))
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.flash_variant_launches == {**n0, "wgmma": n0["wgmma"] + 1}
    expect = ref.flash_attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), expect.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


# ==========================================================================
# the distributed branches: 4 gloo ranks sharing the card, a (2, 2) mesh
# ==========================================================================

MESH_CASES = ["float32-random", "bfloat16-random", "float32-drop", "bfloat16-drop",
              "float32-nodrop", "bfloat16-nodrop"]


def _mesh_moe(mesh_run, case):
    """(config, input on the card) of a mesh MoE case; kind ``nodrop`` runs
    ``parallel.ref.no_drop``'s capacity, as the ranks do."""
    from repro_torch.parallel import ref as pref

    dtype = case.split("-")[0]
    cfg = configs.get_smoke("deepseek-moe-16b").replace(compute_dtype=dtype)
    if case.endswith("nodrop"):
        cfg = pref.no_drop(cfg)
    x = torch.from_numpy(mesh_run["inputs"][f"x/{case}"]).to(getattr(torch, dtype))
    return cfg, x.cuda()


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """``tests/torch_mesh_worker.py`` on the card at the smoke configs: 4
    ranks (NCCL refuses two ranks on one device, gloo takes CUDA tensors),
    the expert-parallel MoE cases and the sequence-sharded decode."""
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the ranks place their tensors on it")
    d = tmp_path_factory.mktemp("mesh_card")
    cfg = configs.get_smoke("deepseek-moe-16b")
    p = moe.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    inputs = {f"p/{k}": v.numpy() for k, v in p.items() if k != "shared"}
    inputs.update({f"p/shared/{k}": v.numpy() for k, v in p["shared"].items()})
    inputs["cases"] = np.array(",".join(MESH_CASES))
    rng = np.random.default_rng(7)
    for case in MESH_CASES:
        x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
        if case.endswith("-drop"):
            x[:, :12] = x[0, 0]
        inputs[f"x/{case}"] = torch.from_numpy(x).to(getattr(torch, case.split("-")[0])
                                                     ).float().numpy()
    inputs["toks"] = rng.integers(0, configs.get_smoke("yi-9b").vocab, (2, 17))
    np.savez(d / "inputs.npz", **inputs)
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, os.path.join(here, "torch_mesh_worker.py"), str(d),
                        "2", "2", "cuda", "ep,decode"],
                       env=dict(os.environ, PYTHONPATH=os.path.join(here, "..", "src")),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return {"inputs": inputs, "params": p,
            "ranks": [dict(np.load(d / f"rank{i}.npz")) for i in range(4)]}


@pytest.mark.cuda
@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_apply_ep_on_card_ranks_matches_emulation(mesh_run, case):
    """Each rank's ``apply_ep`` output (gloo all-reduces of CUDA tensors)
    against ``parallel.ref.apply_ep_emulated`` on the card in this process:
    fp32 1e-5, bf16 3e-2."""
    from repro_torch.parallel import ref as pref

    tol = {"float32": 1e-5, "bfloat16": 3e-2}[case.split("-")[0]]
    cfg, x = _mesh_moe(mesh_run, case)
    want = pref.apply_ep_emulated(tree_to(mesh_run["params"], "cuda"), cfg, x,
                                  {"data": 2, "model": 2}).float().cpu().numpy()
    for i, out in enumerate(mesh_run["ranks"]):
        assert list(out["backends"]) == ["gloo", "gloo"]
        np.testing.assert_allclose(out[f"ep/{case}"], want, atol=tol, rtol=tol,
                                   err_msg=f"rank {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float32-nodrop", "bfloat16-nodrop"])
def test_mesh_apply_ep_on_card_ranks_matches_apply_ref_without_drops(mesh_run, case):
    """The oracle that does not run ``moe.ep_partial``: where no assignment
    drops on either path, each rank's ``apply_ep`` against ``apply_ref`` on
    the card in this process, fp32 1e-5, bf16 3e-2."""
    from repro_torch.parallel import ref as pref

    tol = {"float32": 1e-5, "bfloat16": 3e-2}[case.split("-")[0]]
    cfg, x = _mesh_moe(mesh_run, case)
    p = tree_to(mesh_run["params"], "cuda")
    assert pref.dropped(p, cfg, x) == 0 and pref.dropped(p, cfg, x, {"data": 2, "model": 2}) == 0
    want = moe.apply_ref(p, cfg, x).float().cpu().numpy()
    for i, out in enumerate(mesh_run["ranks"]):
        np.testing.assert_allclose(out[f"ep/{case}"], want, atol=tol, rtol=tol,
                                   err_msg=f"rank {i}")


@pytest.mark.cuda
def test_mesh_seqshard_decode_on_card_matches_plain(mesh_run):
    """Sequence-sharded decode against each rank's plain decode: bf16
    within 1e-1 with equal argmax on the first step, fp32 within 1e-4 on
    every greedy step with equal tokens, the rings' prefill rows exact and
    their unwritten rows zero."""
    for i, out in enumerate(mesh_run["ranks"]):
        plain, seq = out["plain/bfloat16"][0], out["seq/bfloat16"][0]
        assert np.abs(plain - seq).max() < 1e-1, i
        np.testing.assert_array_equal(plain.argmax(-1), seq.argmax(-1))
        np.testing.assert_allclose(out["seq/float32"], out["plain/float32"], atol=1e-4,
                                   rtol=1e-4, err_msg=f"rank {i}")
        np.testing.assert_array_equal(out["seq/float32"].argmax(-1),
                                      out["plain/float32"].argmax(-1))
        for dtype in ("bfloat16", "float32"):
            prefill, decode, unwritten = out[f"ring_err/{dtype}"]
            assert prefill == 0.0 and unwritten == 0.0
        assert out["ring_err/float32"][1] < 1e-4
        assert (out["calls/float32"][0], out["calls/float32"][1] > 0) == (0, True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m", "recurrentgemma-9b"])
def test_dry_run_predicts_a_smoke_prefill_peak(card, arch):
    """launch/dryrun traces the smoke prefill on fake CUDA tensors; the same
    call on the card, after a warm-up (so the cuBLAS workspace is resident),
    allocates beyond what was resident before it within 5 % of what the
    dry run predicts beyond its arguments and that workspace, and launches each kernel as
    often as the trace calls its operator."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.serve.engine import make_prefill_step

    cfg = configs.get_smoke(arch)
    b, l = 4, 256
    rec = dryrun.run_cell(cfg, ShapeSpec("smoke", l, b, "prefill"), verbose=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = dryrun.serve_dtype(lm.init(g, cfg, device="cuda"))
    inputs = {"tokens": torch.randint(0, cfg.vocab, (b, l), generator=g, device="cuda",
                                      dtype=torch.int32)}
    step = make_prefill_step(cfg, max_len=l)
    with torch.inference_mode():
        step(params, inputs)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        out = step(params, inputs)
        torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    m = rec["memory"]
    predicted = m["peak_bytes"] - m["argument_bytes"] - m["workspace_bytes"]
    print(f"[dry run] {arch} smoke prefill [{b}, {l}]: predicted {predicted} B beyond the "
          f"arguments, measured {measured} B, rel {(predicted - measured) / measured:+.5f}")
    assert abs(predicted - measured) <= 0.05 * measured, (predicted, measured)
    calls = {k.split(".")[1].removesuffix("_fwd"): v["calls"] for k, v in rec["kernels"].items()}
    assert {k: n for k, n in ops.launches.items() if n} == calls
    del out


# ==========================================================================
# the sharded train step of the recurrent, MoE and multimodal families: 4 gloo ranks
# sharing the card as a (2, 2) ("data", "model") mesh
# ==========================================================================


def _train_worker(tmp_path_factory, world: int) -> list:
    """``tests/torch_mesh_train_worker.py``'s ``card`` task on ``world``
    ranks on the card (4: the (2, 2) mesh; 3: the (1, 3) mesh): the fp32
    sharded steps of the mamba2-370m, recurrentgemma-9b, deepseek-moe-16b
    (at ``no_drop``'s capacity), phi-3-vision-4.2b (with its patches) and
    seamless-m4t-medium (with its frames) smoke configs, through the scan
    kernels and their backwards and flash; each rank's record."""
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the ranks place their tensors on it")
    d = tmp_path_factory.mktemp(f"mesh_train_card{world}")
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, os.path.join(here, "torch_mesh_train_worker.py"),
                        str(d), str(world), "card"],
                       env=dict(os.environ, PYTHONPATH=os.path.join(here, "..", "src")),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return [dict(np.load(d / f"card-rank{i}.npz")) for i in range(world)]


@pytest.fixture(scope="module")
def mesh_train_card(tmp_path_factory):
    """The train worker's ``card`` task on 4 ranks as the (2, 2) mesh."""
    return _train_worker(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def mesh_train_card3(tmp_path_factory):
    """The train worker's ``card`` task on 3 ranks as the (1, 3) mesh."""
    return _train_worker(tmp_path_factory, 3)


CARD_TRAIN_ARCHS = ["mamba2-370m", "recurrentgemma-9b", "deepseek-moe-16b",
                    "phi-3-vision-4.2b", "seamless-m4t-medium"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CARD_TRAIN_ARCHS)
def test_mesh_train_step_on_card_ranks_matches_plain(mesh_train_card, card, arch):
    """Each rank's fp32 sharded steps (the scans at the rank's heads or
    width block; the MoE layers expert parallel, 4 of the 8 experts a rank,
    where nothing drops; the VLM with its patch prefix; the enc-dec encoder
    and cross-attention, tensor parallel) against the plain steps on the card in this process from
    the same state and batches: :func:`_hold_train_ranks`."""
    _hold_train_ranks(mesh_train_card, card, arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CARD_TRAIN_ARCHS)
def test_mesh_train_step_on_3_card_ranks_matches_plain(mesh_train_card3, card, arch):
    """The same on 3 ranks as the (1, 3) mesh, whose model axis of 3 divides
    few of the smoke configs' split dims (the vocab 512, the heads, the
    SSM's heads and inner width, the RG-LRU width 64): each rank computes
    those products whole, the scans and flash on every head and channel of
    the whole batch, the MoE layers through the global dispatch (8
    experts); :func:`_hold_train_ranks`."""
    _hold_train_ranks(mesh_train_card3, card, arch)


def _hold_train_ranks(ranks, card, arch):
    """Each rank's fp32 sharded steps of ``arch`` against the plain steps on
    the card in this process from the same state and batches: losses and
    grad norms at 1e-4 relative, the gathered parameters at 1e-4 and the
    moments within 1e-4 of their leaf's largest, every rank launching each
    kernel as often as the plain step."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_train_worker as worker

    cfg, state, batches = worker.card_inputs(arch)
    state = tree_to(state, card)
    step = make_train_step(cfg)
    ops.reset_launches()
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, batch_to(batch, card))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = [ops.launches[k] for k in sorted(ops.launches)]
    if set(cfg.layer_pattern) & {"ssm", "rglru"}:
        assert ops.launches["ssd_scan_bwd"] + ops.launches["rglru_scan_bwd"] > 0
    else:
        assert ops.launches["flash_attention"] > 0
    for i, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{arch}/loss"], losses, rtol=1e-4, err_msg=f"rank {i}")
        np.testing.assert_allclose(out[f"{arch}/grad_norm"], norms, rtol=1e-4,
                                   err_msg=f"rank {i}")
        assert list(out["launch_names"]) == sorted(ops.launches)
        assert list(out[f"{arch}/launches"]) == launches, i
    got = ranks[0]
    for key, want in worker.flatten({"params": state["params"], "opt": state["opt"]}).items():
        a, b = got[f"{arch}/state/{key}"], worker._np(want.cpu())
        if key.startswith("opt/"):
            np.testing.assert_allclose(a, b, atol=1e-4 * max(float(np.abs(b).max()), 1e-30),
                                       err_msg=key)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=key)


# ==========================================================================
# serving on sharded parameters: gloo ranks sharing the card
# ==========================================================================


def _serve_worker(tmp_path_factory, world: int, task: str) -> list:
    """Run ``tests/torch_mesh_serve_worker.py``'s ``task`` on ``world``
    ranks on the card; each rank's record."""
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the ranks place their tensors on it")
    d = tmp_path_factory.mktemp(f"mesh_serve_{task}")
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, os.path.join(here, "torch_mesh_serve_worker.py"),
                        str(d), str(world), task],
                       env=dict(os.environ, PYTHONPATH=os.path.join(here, "..", "src")),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return [dict(np.load(d / f"{task}-rank{i}.npz")) for i in range(world)]


@pytest.fixture(scope="module")
def mesh_serve_card(tmp_path_factory):
    """The serve worker's ``card`` task: 4 ranks as the (2, 2) mesh."""
    return _serve_worker(tmp_path_factory, 4, "card")


@pytest.fixture(scope="module")
def mesh_serve_card3(tmp_path_factory):
    """The serve worker's ``card`` task: 3 ranks as the (1, 3) mesh."""
    return _serve_worker(tmp_path_factory, 3, "card")


@pytest.fixture(scope="module")
def mesh_serve_card8(tmp_path_factory):
    """The serve worker's ``card8`` task: 8 ranks as the (1, 8) mesh."""
    return _serve_worker(tmp_path_factory, 8, "card8")


CARD_SERVE_ARCHS = ["yi-9b", "gemma2-27b", "phi-3-vision-4.2b", "deepseek-moe-16b",
                    "mamba2-370m", "recurrentgemma-9b", "seamless-m4t-medium"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CARD_SERVE_ARCHS)
def test_mesh_serve_on_3_card_ranks_matches_plain(mesh_serve_card3, arch):
    """:func:`test_mesh_serve_on_card_ranks_matches_plain` on 3 ranks as the
    (1, 3) mesh: the rule table's guard leaves whole what a model axis of 3
    does not divide (the vocab, the heads and every ring of these smoke
    configs, their SSM heads and RG-LRU width), each rank's prefill
    launching each kernel once a layer of its kind on every head or
    channel of the whole batch."""
    _hold_serve_ranks(mesh_serve_card3, arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CARD_SERVE_ARCHS)
def test_mesh_serve_on_card_ranks_matches_plain(mesh_serve_card, arch):
    """Each rank's fp32 sharded prefill and 3 greedy decode steps of the
    smoke config (make_prefill_step / make_decode_step on DTensor
    parameters: yi-9b's and recurrentgemma-9b's rings over their head_dim,
    the others' over their kv heads; deepseek-moe-16b expert parallel at
    no_drop's capacity; mamba2-370m's SSM state and recurrentgemma-9b's
    RG-LRU state on the rank's heads and width; seamless-m4t-medium's
    projected memory over its kv heads) against its plain ones on the card:
    logits within 1e-4, the tokens equal, in the prefill flash launched
    once a causal self-attention layer, the SSD scan once an SSM layer and
    the RG-LRU scan once an RG-LRU layer (:func:`_hold_serve_ranks`)."""
    _hold_serve_ranks(mesh_serve_card, arch)


def _hold_serve_ranks(ranks, arch):
    """Each rank's logits of ``arch`` within 1e-4 of the plain run's, the
    tokens equal, and each kernel launched once a layer of its kind in the
    sharded prefill."""
    cfg = configs.get_smoke(arch)
    kinds = [cfg.pattern_of(i) for i in range(cfg.n_layers)]
    want = {"flash_attention": sum(k in ("attn", "local") for k in kinds),
            "ssd_scan": kinds.count("ssm"), "rglru_scan": kinds.count("rglru")}
    for i, out in enumerate(ranks):
        assert float(out[f"{arch}/max_abs_err"]) <= 1e-4, (i, float(out[f"{arch}/max_abs_err"]))
        assert bool(out[f"{arch}/tokens_equal"]), i
        for kernel, n in want.items():
            assert int(out[f"{arch}/launches/{kernel}"]) == n, (i, kernel)


@pytest.mark.cuda
def test_mesh_global_dispatch_on_8_card_ranks_matches_plain(mesh_serve_card8):
    """dbrx-132b smoke on 8 ranks as the (1, 8) mesh on the card, its 4
    experts on every rank (the global dispatch on the gathered tokens):
    the sharded prefill and decode within 1e-4 of the plain ones with equal
    tokens, and 2 sharded train steps' loss and grad norm within 1e-4
    relative of the plain steps'."""
    for i, out in enumerate(mesh_serve_card8):
        assert float(out["serve/max_abs_err"]) <= 1e-4, (i, float(out["serve/max_abs_err"]))
        assert bool(out["serve/tokens_equal"]), i
        np.testing.assert_allclose(out["train/sharded"], out["train/plain"], rtol=1e-4,
                                   err_msg=f"rank {i}")


@pytest.mark.cuda
def test_remote_serve_workflow_survives_a_killed_card_worker(card, tmp_path):
    """The serve workflow on the port's RemoteRunner, its workers forked
    from a coordinator subprocess (``tests/torch_remote_worker.py``) that
    never touches the card: yi-9b smoke, each decoding worker building the
    weights from the seed on the card at its first decode.  The aws/lambda
    decode replica's worker is SIGKILLed at its output commit and the other
    aws worker claims the invocation again; one detok completion, the
    committed tokens equal to a direct greedy_generate on the same seed's
    weights, and every model run one flash launch a layer (the crash
    policy, phase 5c's, logs each run's launches at its output commit)."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.kernels import build
    from repro_torch.serve import engine, workflow

    build.build_all()               # the workers load the kernels, never build one
    cfg = configs.get_smoke("yi-9b")
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompt = torch.tensor(workflow.prompt_ids(cfg, 2, 16, 7), dtype=torch.long, device="cuda")
    direct = engine.greedy_generate(params, cfg, prompt, steps=12).cpu().tolist()
    del params
    torch.cuda.empty_cache()
    with open(tmp_path / "job.json", "w") as f:
        json.dump({"arch": "yi-9b", "compute_dtype": cfg.compute_dtype, "device": "cuda",
                   "params": 0, "batch": 2, "prompt_len": 16, "steps": 12, "seed": 7,
                   "lease_ms": 20000.0}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, os.path.join(here, "torch_remote_worker.py"),
                        str(tmp_path)], capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTORCH_NVML_BASED_CUDA_CHECK="1"))
    assert r.returncode == 0, r.stderr[-4000:]
    with open(tmp_path / "result.json") as f:
        out = json.load(f)
    assert out["ids"] == direct
    assert out["completions"] == 1
    aws = {pid for name, pid in out["workers"].items() if name.startswith("aws-")}
    kills = [e for e in out["log"] if e["event"] == "kill"]
    assert len(kills) == 1 and kills[0]["pid"] in aws
    again = [e for e in out["log"] if e["event"] == "claim" and e["function"] == "decode"
             and e["faas"] == workflow.PRIMARY and e["attempt"] == 1]
    assert len(again) == 1 and again[0]["pid"] in aws - {kills[0]["pid"]}
    runs = [e for e in out["log"] if e["function"] == "decode" and e["event"] != "claim"]
    assert kills[0] in runs
    for d in runs:
        assert d["cuda"] and d["launches"]["flash_attention"] == cfg.n_layers, d
    decoders = {d["pid"] for d in runs}
    assert not any(e["cuda"] for e in out["log"] if e["pid"] not in decoders)
