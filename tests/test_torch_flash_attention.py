"""Port flash attention: the plain PyTorch version against the JAX package's
Pallas kernel (interpret mode) and its dense oracle, on the reference's
kernel cases; the wrapper's contract and variant choice; the wgmma
variant's numerics emulated on the CPU; the FA2 backward (the Function's
gradients against ``jax.vjp`` of the reference), the backward kernel's mma
roundings emulated on the CPU, its tile skipping and its wrapper's
contract.  The CUDA kernels themselves are held against the plain version
on a card in ``test_torch_cuda.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

torch.set_num_threads(2)

FLASH_CASES = ref.FLASH_CASES + ref.FLASH_HD256_CASES + ref.FLASH_HD96_CASES
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, l, h, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, hd), np.float32),
            rng.standard_normal((b, l, hkv, hd), np.float32),
            rng.standard_normal((b, l, hkv, hd), np.float32))


def _t(x, dtype, device="cpu"):
    return torch.from_numpy(x).to(_TORCH[dtype]).to(device)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,l,h,hkv,hd,window,cap,dtype,tol", FLASH_CASES)
def test_plain_vs_jax_kernel_and_oracle(b, l, h, hkv, hd, window, cap, dtype, tol):
    qn, kn, vn = _inputs(b, l, h, hkv, hd, seed=l + h)
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (qn, kn, vn))
    jax_kernel = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                      softcap=cap, block_q=128, block_k=128)
    jax_oracle = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window,
                                          softcap=cap)
    out = ops.flash_attention(_t(qn, dtype), _t(kn, dtype), _t(vn, dtype),
                              causal=True, window=window, softcap=cap,
                              block_q=128, block_k=128)
    assert out.dtype == _TORCH[dtype] and out.shape == (b, l, h, hd)
    np.testing.assert_allclose(_f32(out), _f32(jax_kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(out), _f32(jax_oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("window", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_window_with_and_without_causal_vs_jax_kernel(causal, window, dtype, tol):
    """The reference's kernel applies ``window`` whether or not the call is
    causal; with 64-key blocks at L = S = 128 whole key tiles fall outside
    the window.  The plain twin of the reference's oracle keeps its meaning
    (no mask at all without causal)."""
    qn, kn, vn = _inputs(1, 128, 4, 2, 32, seed=window + causal)
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (qn, kn, vn))
    jax_kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      block_q=64, block_k=64)
    q, k, v = (_t(x, dtype) for x in (qn, kn, vn))
    out = ops.flash_attention(q, k, v, causal=causal, window=window, block_q=64, block_k=64)
    assert out.dtype == _TORCH[dtype] and out.shape == (1, 128, 4, 32)
    np.testing.assert_allclose(_f32(out), _f32(jax_kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _f32(ref.flash_attention_ref(q, k, v, causal=causal, window=window)),
        _f32(jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)),
        atol=tol, rtol=tol)


def test_window_mask_without_causal():
    m = attention.make_window_mask(5, 6, window=2)
    assert m.tolist() == [[j > i - 2 for j in range(6)] for i in range(5)]
    assert bool((m | ~attention.make_causal_mask(5, 6, window=2)).all())


def test_ragged_rejected_like_reference():
    q = torch.zeros((1, 100, 4, 64))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :4], q[:, :, :4], block_q=64, block_k=64)
    with pytest.raises(ValueError):
        jops.flash_attention(jnp.zeros((1, 100, 4, 64)), jnp.zeros((1, 100, 4, 64))[:, :, :4],
                             jnp.zeros((1, 100, 4, 64))[:, :, :4], block_q=64, block_k=64)


@pytest.mark.parametrize("l,window,cap", [(24, 0, 0.0), (23, 16, 50.0), (130, 64, 0.0)])
def test_padded_causal_call_is_exact(l, window, cap):
    """attention pads L to the block multiple; the padding must not leak."""
    qn, kn, vn = _inputs(2, l, 4, 2, 16, seed=l)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    out = attention._flash_causal(q, k, v, window=window, cap=cap)
    expect = ref.flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap)
    assert out.shape == (2, l, 4, 16)
    np.testing.assert_allclose(out.numpy(), expect.numpy(), atol=2e-6, rtol=2e-6)


def test_cuda_path_never_falls_back():
    """The kernel launcher refuses CPU tensors and unsupported head dims
    before any build; the wrapper refuses other devices."""
    q = torch.zeros((1, 64, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, q[:, :, :2], q[:, :, :2])
    q48 = torch.zeros((1, 64, 4, 48))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q48, q48, q48)
    m = torch.zeros((1, 64, 4, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.flash_attention(m, m, m)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "CUDA_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all(["flash_attention"])
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").iterdir())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_variant_by_head_dim_and_dtype(hd, dtype):
    """bf16 at head dims 16–256 (96 included) runs on the tensor cores; fp32
    (whose 2e-5 tolerance rules out TF32) and head dim 8 keep the FMA
    kernel."""
    want = "wgmma" if dtype == torch.bfloat16 and hd >= 16 else "fma"
    assert fa.variant(hd, dtype) == want
    assert want in fa.VARIANTS and want in ops.flash_variant_launches
    assert 96 in fa.HEAD_DIMS and fa.variant(96, torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("arch", [a for a in configs.ARCHS if {"attn", "local"} & set(
    configs.get(a).layer_pattern)])
def test_every_config_head_dim_is_a_kernel_head_dim(arch):
    """The reference's kernel takes any head dim and the card's only those
    it is instantiated at, so every attention config's head dim, at full width and in
    its smoke config (which may be narrower: phi-3-vision-4.2b runs hd 16
    there and 96 at full width), must be one of them; the full configs'
    bf16 serving runs the wgmma variant."""
    full, smoke = configs.get(arch), configs.get_smoke(arch)
    assert full.hd in fa.HEAD_DIMS and smoke.hd in fa.HEAD_DIMS
    assert fa.variant(full.hd, full.cdtype) == "wgmma"


def _wgmma_numerics(q, k, v, *, causal, window, softcap):
    """The wgmma kernel's arithmetic on the CPU: fp32 logits, an online
    softmax over key tiles of 128 (64 at hd 256), the denominator summed from
    fp32 p, p rounded to bf16 for P·V with fp32 accumulation, bf16 output."""
    b, l, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    bk = 64 if hd == 256 else 128
    kf = k.float().repeat_interleave(h // hkv, dim=2)
    vf = v.float().repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("blhd,bshd->bhls", q.float(), kf) * (1.0 / math.sqrt(hd))
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if causal or window:
        mask = (attention.make_causal_mask(l, s, window=window) if causal
                else attention.make_window_mask(l, s, window=window))
        logits = torch.where(mask, logits, torch.tensor(attention.NEG_INF))
    m = torch.full((b, h, l), attention.NEG_INF)
    den = torch.zeros((b, h, l))
    acc = torch.zeros((b, h, l, hd))
    for k0 in range(0, s, bk):
        tile = logits[..., k0:k0 + bk]
        m_new = torch.maximum(m, tile.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(tile - m_new[..., None])
        den = den * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhls,bshd->bhld", p.bfloat16().float(), vf[:, k0:k0 + bk])
        m = m_new
    out = acc / torch.clamp(den, min=1e-37)[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


# (b, l, h, hkv, hd, causal, window, softcap): the bf16 reference cases, the
# two serving shapes at batch 1 (yi-9b, recurrentgemma-9b), the wgmma cases
# and the bf16 non-causal windows
_WGMMA_EMULATED = (
    [(b, l, h, hkv, hd, True, w, cap)
     for (b, l, h, hkv, hd, w, cap, dt, _) in FLASH_CASES if dt == "bfloat16"]
    + [(1, 512, 32, 4, 128, True, 0, 0.0), (1, 512, 16, 1, 256, True, 0, 0.0)]
    + ref.FLASH_WGMMA_CASES
    + [(b, l, h, hkv, hd, False, w, 0.0)
       for (b, l, h, hkv, hd, w, dt, _) in ref.FLASH_WINDOW_CASES if dt == "bfloat16"])


@pytest.mark.parametrize("b,l,h,hkv,hd,causal,window,cap", _WGMMA_EMULATED)
def test_wgmma_numerics_within_bf16_tolerance(b, l, h, hkv, hd, causal, window, cap):
    """Rounding p to bf16 before P·V keeps the wgmma variant within the bf16
    tolerance (2e-2) of the plain version, so p needs no two-term split."""
    qn, kn, vn = _inputs(b, l, h, hkv, hd, seed=l + h + hd)
    q, k, v = (_t(x, "bfloat16") for x in (qn, kn, vn))
    got = _wgmma_numerics(q, k, v, causal=causal, window=window, softcap=cap)
    want = ref.flash_attention_plain(q, k, v, causal=causal, window=window, softcap=cap)
    assert got.shape == want.shape and bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


def test_build_target_tracks_headers(monkeypatch, tmp_path):
    """An edited header under csrc/ names a new library, so it is rebuilt."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "flash_attention.cu").write_text('#include "part.cuh"\n')
    (csrc / "part.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build._target("flash_attention")
    (csrc / "part.cuh").write_text("// two\n")
    assert build._target("flash_attention") != first
    (csrc / "part.cuh").write_text("// one\n")
    assert build._target("flash_attention") == first


# ---- the training path: lse, and the FA2 backward of models/flash ----------

from repro.models import flash as jflash  # noqa: E402
from repro_torch.models import flash  # noqa: E402

# (l, causal, window, softcap, hd): causal, windowed, softcapped and
# non-causal, at hd 16 and at phi-3-vision's hd 96
_GRAD_CASES = [(l, causal, window, cap, hd) for (l, hd) in ((256, 16), (2048, 16), (256, 96))
               for (causal, window, cap) in ((True, 0, 0.0), (True, 96, 0.0),
                                             (True, 0, 30.0), (False, 0, 0.0))]


def _grad_inputs(l, seed, b=1, h=4, hkv=2, hd=16):
    qn, kn, vn = _inputs(b, l, h, hkv, hd, seed=seed)
    don = np.random.default_rng(seed + 1).standard_normal((b, l, h, hd)).astype(np.float32)
    return qn, kn, vn, don


@pytest.mark.parametrize("l,causal,window,cap,hd", _GRAD_CASES)
def test_flash_function_forward_and_grads_vs_jax(l, causal, window, cap, hd):
    """The Function's output and its gradients against ``jax.vjp`` of the
    reference's ``custom_vjp`` (blockwise forward, FA2 backward), fp32 at
    1e-4, on the reference's 512-row tiles."""
    qn, kn, vn, don = _grad_inputs(l, seed=l + window + int(cap), hd=hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    out_j, vjp = jax.vjp(lambda q, k, v: jflash.flash_attention(q, k, v, **kw),
                         *(jnp.asarray(x) for x in (qn, kn, vn)))
    grads_j = vjp(jnp.asarray(don))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    out = flash.flash_attention(q, k, v, **kw)
    out.backward(torch.from_numpy(don))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-4, rtol=1e-4)
    for name, t, gj in zip("qkv", (q, k, v), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("l,causal,window,cap,hd", _GRAD_CASES)
def test_lse_vs_jax_flash_fwd_impl(l, causal, window, cap, hd):
    """The wrapper's lse (the plain version's on the CPU) and the port's
    blockwise forward against the reference's ``_flash_fwd_impl``, 1e-5;
    head h = kv·G + g."""
    qn, kn, vn, _ = _grad_inputs(l, seed=l + 7, hd=hd)
    b, _, h, hd = qn.shape
    hkv = kn.shape[2]
    kw = dict(causal=causal, window=window, softcap=cap, bq=min(512, l), bk=min(512, l))
    group = lambda x: np.moveaxis(x.reshape(b, l, hkv, h // hkv, hd), 1, 3)  # noqa: E731
    out_j, lse_j = jflash._flash_fwd_impl(jnp.asarray(group(qn)), jnp.asarray(
        np.moveaxis(kn, 1, 2)), jnp.asarray(np.moveaxis(vn, 1, 2)), **kw)
    lse_j = np.asarray(lse_j).reshape(b, h, l)
    out, lse = ops.flash_attention(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                                   causal=causal, window=window, softcap=cap,
                                   return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, l)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=1e-5)
    plain = ref.flash_attention_plain(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                                      causal=causal, window=window, softcap=cap)
    assert torch.equal(out, plain)
    out_b, lse_b = flash._flash_fwd_impl(
        flash._grouped_q(torch.from_numpy(qn), hkv), torch.from_numpy(kn).transpose(1, 2),
        torch.from_numpy(vn).transpose(1, 2), **kw)
    np.testing.assert_allclose(lse_b.numpy(), np.asarray(
        jflash._flash_fwd_impl(jnp.asarray(group(qn)), jnp.asarray(np.moveaxis(kn, 1, 2)),
                               jnp.asarray(np.moveaxis(vn, 1, 2)), **kw)[1]),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(flash._ungrouped_q(out_b).numpy(), np.asarray(
        jflash.flash_attention(*(jnp.asarray(x) for x in (qn, kn, vn)), causal=causal,
                               window=window, softcap=cap)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("l,window,cap", [(100, 0, 0.0), (23, 16, 50.0), (600, 0, 0.0)])
def test_padded_rows_get_no_gradient(l, window, cap):
    """``_flash_causal`` pads L to a multiple of 64 and slices; through the
    Function the real rows' gradients equal dense autograd's, and the
    backward hands the padded rows zero (L = 600 pads to 640, which 512
    does not tile, so the tiles are 64 rows)."""
    qn, kn, vn, don = _grad_inputs(l, seed=l, b=2)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    attention._flash_causal(q, k, v, window=window, cap=cap).backward(torch.from_numpy(don))
    q2, k2, v2 = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    ref.flash_attention_ref(q2, k2, v2, causal=True, window=window, softcap=cap).backward(
        torch.from_numpy(don))
    for a, b_ in ((q, q2), (k, k2), (v, v2)):
        np.testing.assert_allclose(a.grad.numpy(), b_.grad.numpy(), atol=1e-5, rtol=1e-5)

    pad = -l % attention.FLASH_BLOCK
    qp, kp, vp = (torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, 0, 0, pad))
                  .requires_grad_() for x in (qn, kn, vn))
    dop = torch.nn.functional.pad(torch.from_numpy(don), (0, 0, 0, 0, 0, pad))
    block = 512 if (l + pad) % min(512, l + pad) == 0 else attention.FLASH_BLOCK
    flash.flash_attention(qp, kp, vp, window=window, softcap=cap, block_q=block,
                          block_k=block).backward(dop)
    for t in (qp, kp, vp):
        assert not t.grad[:, l:].any()
        assert t.grad[:, :l].abs().sum() > 0


def test_flash_function_ragged_rejected_like_reference():
    q = torch.zeros((1, 600, 4, 16), requires_grad=True)
    with pytest.raises(ValueError):
        flash.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError):
        jflash.flash_attention(jnp.zeros((1, 600, 4, 16)), jnp.zeros((1, 600, 2, 16)),
                               jnp.zeros((1, 600, 2, 16)))


def test_launcher_argtypes_match_the_entry_point():
    """ctypes passes each argument as its declared type (a pointer cut to
    32 bits would crash on the card): one c_void_p per pointer of the C
    entry point (lse among them), c_float per float, c_int per int."""
    import ctypes
    import pathlib
    import re
    src = (pathlib.Path(fa.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    params = re.search(r'extern "C" int flash_attention_fwd\((.*?)\)', src, re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in prm else ctypes.c_float if "float" in prm
             else ctypes.c_int for prm in params.split(",")]
    assert kinds == fa._ARGTYPES
    assert "float* lse" in params


# ---- the backward kernel: its numerics, its tiles, its wrapper ------------


@pytest.mark.parametrize("l,causal,window,cap,hd", _GRAD_CASES)
def test_mma_bwd_roundings_vs_jax_grads(l, causal, window, cap, hd):
    """The backward's wgmma variant (as the mma.sync kernel before it) rounds
    p and ds to bf16 once, as the A operands of pᵀ·do, dsᵀ·q and ds·k
    (``ref.flash_bwd_mma_emulated``); on
    bf16 inputs its gradients hold against ``jax.vjp`` of the reference's
    ``flash_attention`` at the bf16 gradient tolerance, atol = rtol = 3e-2,
    so p and ds need no hi + lo split."""
    qn, kn, vn, don = _grad_inputs(l, seed=l + window + int(cap) + hd, hd=hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in (qn, kn, vn, don))
    _, vjp = jax.vjp(lambda q, k, v: jflash.flash_attention(q, k, v, **kw), jq, jk, jv)
    grads_j = vjp(jdo)
    q, k, v, do = (_t(x, "bfloat16") for x in (qn, kn, vn, don))
    out, lse = ref.flash_attention_plain_lse(q, k, v, **kw)
    got = ref.flash_bwd_mma_emulated(q, k, v, out, lse, do, **kw)
    for name, g, gj, t in zip("qkv", got, grads_j, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        np.testing.assert_allclose(_f32(g), _f32(gj.astype(jnp.float32)), atol=3e-2,
                                   rtol=3e-2, err_msg=f"d{name}")


def _rows_seeing(k_lo, k_hi, l, causal, window):
    """The query rows a key of [k_lo, k_hi] is seen by, as the backward
    kernel's ``Mask::rows_seeing`` bounds its q tiles."""
    return (k_lo if causal else 0), (min(l - 1, k_hi + window - 1) if window else l - 1)


def _keys_seen(q_lo, q_hi, s_len, causal, window):
    """... and ``Mask::keys_seen`` its kv tiles."""
    return (max(0, q_lo - window + 1) if window else 0), (min(s_len - 1, q_hi) if causal
                                                          else s_len - 1)


def _keeps_any(q_lo, q_hi, k_lo, k_hi, l, s_len, causal, window):
    """Whether the mask keeps a pair of the rows [q_lo, q_hi] and keys
    [k_lo, k_hi], as ``Mask::keeps_any`` decides whether a wgmma
    warpgroup's 64 rows and a streamed tile need their products."""
    return (q_lo < l and k_lo < s_len and not (causal and k_lo > min(q_hi, l - 1))
            and not (window and min(k_hi, s_len - 1) <= q_lo - window))


def _skipping_bwd(q, k, v, out, lse, do, *, causal, window, softcap, br, bc, wr):
    """The plain backward's tile math (grouped layout) on the kernel's tiles
    only: a block of ``br`` rows visits the ``bc``-wide column tiles that
    hold a pair its mask keeps, and inside it each ``wr`` rows (a wgmma
    warpgroup's; ``wr = br`` where a block does not split) skip the tiles
    their own mask hides; every other tile is skipped."""
    b, hkv, g, l, hd = q.shape
    s_len = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    f = torch.float32
    delta = (do.float() * out.float()).sum(-1)

    def tile(i0, i1, j0, j1):
        s = torch.einsum("bkgqd,bksd->bkgqs", q[..., i0:i1, :].float(),
                         k[:, :, j0:j1].float()) * scale
        s_pre = s
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = torch.ones((i1 - i0, j1 - j0), dtype=torch.bool)
        qpos, kpos = torch.arange(i0, i1)[:, None], torch.arange(j0, j1)[None, :]
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        p = torch.where(mask, torch.exp(s - lse[..., i0:i1, None]), torch.zeros((), dtype=f))
        dp = torch.einsum("bkgqd,bksd->bkgqs", do[..., i0:i1, :].float(), v[:, :, j0:j1].float())
        ds = p * (dp - delta[..., i0:i1, None])
        if softcap:
            ds = ds * (1.0 - torch.tanh(s_pre / softcap) ** 2)
        return p, torch.where(mask, ds, torch.zeros((), dtype=f))

    dq = torch.zeros(q.shape, dtype=f)
    for b0 in range(0, l, br):
        lo, hi = _keys_seen(b0, min(b0 + br, l) - 1, s_len, causal, window)
        for j0 in range(lo // bc * bc, hi + 1 if lo <= hi else 0, bc):
            j1 = min(j0 + bc, s_len)
            for i0 in range(b0, min(b0 + br, l), wr):
                i1 = min(i0 + wr, l)
                if not _keeps_any(i0, i0 + wr - 1, j0, j0 + bc - 1, l, s_len, causal, window):
                    continue
                _, ds = tile(i0, i1, j0, j1)
                dq[..., i0:i1, :] += torch.einsum("bkgqs,bksd->bkgqd", ds,
                                                  k[:, :, j0:j1].float()) * scale
    dk, dv = torch.zeros(k.shape, dtype=f), torch.zeros(v.shape, dtype=f)
    for b0 in range(0, s_len, br):
        lo, hi = _rows_seeing(b0, min(b0 + br, s_len) - 1, l, causal, window)
        for i0 in range(lo // bc * bc, hi + 1 if lo <= hi else 0, bc):
            i1 = min(i0 + bc, l)
            for j0 in range(b0, min(b0 + br, s_len), wr):
                j1 = min(j0 + wr, s_len)
                if not _keeps_any(i0, i0 + bc - 1, j0, j0 + wr - 1, l, s_len, causal, window):
                    continue
                p, ds = tile(i0, i1, j0, j1)
                dv[:, :, j0:j1] += torch.einsum("bkgqs,bkgqd->bksd", p,
                                                do[..., i0:i1, :].float())
                dk[:, :, j0:j1] += torch.einsum("bkgqs,bkgqd->bksd", ds,
                                                q[..., i0:i1, :].float()) * scale
    return dq, dk, dv


_SKIP_MASKS = [(256, True, 0, 0.0), (256, True, 96, 0.0), (256, False, 96, 0.0),
               (256, True, 0, 30.0), (256, False, 0, 0.0), (192, True, 70, 0.0),
               (192, False, 40, 50.0)]
#: (block rows, column tile, warpgroup rows): the fma variant's 32 × 32 tiles;
#: the wgmma variant's dk/dv sweep (128 keys against 64 queries, 64 keys at
#: hd 256) and dq sweep (128 rows against 64 keys, 128 at hd 16 and 32, 32
#: at hd 256), each block split between two warpgroups of 64 rows
_SKIP_TILES = [(32, 32, 32), (64, 64, 64), (128, 64, 64), (128, 128, 64), (128, 32, 64)]


@pytest.mark.parametrize("l,causal,window,cap,br,bc,wr", [
    (l if l % br == 0 and l % bc == 0 else 2 * l, causal, window, cap, br, bc, wr)
    for (l, causal, window, cap) in _SKIP_MASKS for (br, bc, wr) in _SKIP_TILES])
def test_bwd_tile_skipping_is_exact(l, causal, window, cap, br, bc, wr):
    """Skipping the tiles that the causal mask or the window empties, as the
    backward kernel does (both variants' row and column tiles, and the
    wgmma variant's warpgroups on their own rows), changes nothing: the
    skipping plain backward equals ``_flash_bwd_impl`` (every tile visited)
    on the same tiles at 1e-6 wherever every row sees a key (L = S): its dq
    on (bq, bk) = (br, bc), its dk and dv on (bc, br)."""
    qn, kn, vn, don = _grad_inputs(l, seed=l + window + br + bc, hd=16)
    q, k, v, do = (torch.from_numpy(x) for x in (qn, kn, vn, don))
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = ref.flash_attention_plain_lse(q, k, v, **kw)
    hkv = k.shape[2]
    args = (flash._grouped_q(q, hkv), k.transpose(1, 2), v.transpose(1, 2),
            flash._grouped_q(out, hkv), lse.reshape(1, hkv, -1, l), flash._grouped_q(do, hkv))
    want = (flash._flash_bwd_impl(*args, bq=br, bk=bc, **kw)[0],
            *flash._flash_bwd_impl(*args, bq=bc, bk=br, **kw)[1:])
    got = _skipping_bwd(*args, br=br, bc=bc, wr=wr, **kw)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=f"d{name}")


def test_cuda_bwd_never_falls_back(monkeypatch):
    """A tensor that stands for the card's (a fake tensor on ``meta``) goes
    to the backward operator and never to the plain backward, which sizes
    the wgmma dk/dv sweep's fp32 head-share partials by its grid (128 keys
    a block: one block for these 64 keys, so each of the 2 kv heads' G = 2
    query heads gets a share); the launcher refuses CPU tensors and head
    dims it lacks before any build; the wrapper refuses other devices."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*a, **k):
        raise AssertionError("the plain backward ran for a card tensor")

    monkeypatch.setattr(flash, "flash_bwd_plain", plain)
    monkeypatch.setattr(flash, "_flash_bwd_impl", plain)
    ops.reset_launches()
    with FakeTensorMode():
        mk = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
        q, k, lse = mk(1, 64, 4, 64), mk(1, 64, 2, 64), torch.empty((1, 4, 64), device="meta")
        dq, dk, dv = ops.flash_attention_bwd(q, k, k, q, lse, q)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
        _, delta, part = fa._bwd_buffers(q, k, k, fa.bwd_variant(64, q.dtype))
        assert fa.bwd_variant(64, q.dtype) == "wgmma" and delta.shape == (1, 4, 64)
        assert part.shape == (2, 2, *k.shape) and part.dtype == torch.float32
    assert not any(ops.launches.values())
    c = torch.zeros((1, 64, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(c, c[:, :, :2], c[:, :, :2], c, torch.zeros((1, 4, 64)), c)
    c48 = torch.zeros((1, 64, 4, 48))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd(c48, c48, c48, c48, torch.zeros((1, 4, 64)), c48)
    m = torch.zeros((1, 64, 4, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.flash_attention_bwd(m, m, m, m, torch.zeros((1, 4, 64), device="meta"), m)


def test_bwd_launcher_argtypes_match_the_entry_point():
    """As for the forward: one c_void_p per pointer of the backward's C
    entry point (lse and the delta scratch among them), c_float per float,
    c_int per int; and the source is built with the others."""
    import ctypes
    import pathlib
    import re
    src = (pathlib.Path(fa.__file__).parent / "csrc" / "flash_attention_bwd.cu").read_text()
    params = re.search(r'extern "C" int flash_attention_bwd\((.*?)\)', src, re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in prm else ctypes.c_float if "float" in prm
             else ctypes.c_int for prm in params.split(",")]
    assert kinds == fa._BWD_ARGTYPES
    assert "const float* lse" in params and "float* delta" in params
    assert build.SOURCES["flash_attention_bwd"] == "flash_attention_bwd.cu"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_bwd_variant_by_head_dim_and_dtype(hd, dtype):
    """Every (head dim, dtype) the forward takes has a backward on the
    forward's variant: wgmma (bf16 at every head dim but 8), fma (fp32, and
    bf16 at 8)."""
    want = "wgmma" if dtype == torch.bfloat16 and hd != 8 else "fma"
    assert fa.variant(hd, dtype) == want
    assert fa.bwd_variant(hd, dtype) == want
    assert want in fa.BWD_VARIANTS and want in ops.flash_bwd_variant_launches
    with pytest.raises(ValueError, match="head dim"):
        fa.bwd_variant(48, dtype)


@pytest.mark.parametrize("arch", [a for a in configs.ARCHS if {"attn", "local"} & set(
    configs.get(a).layer_pattern)])
def test_every_config_head_dim_has_a_backward(arch):
    """Every attention config's head dim, full and smoke, has a backward
    variant in both dtypes; the full configs' bf16 training runs wgmma."""
    full, smoke = configs.get(arch), configs.get_smoke(arch)
    for cfg in (full, smoke):
        for dtype in (torch.float32, torch.bfloat16):
            assert fa.bwd_variant(cfg.hd, dtype) in fa.BWD_VARIANTS
    assert fa.bwd_variant(full.hd, full.cdtype) == "wgmma"


def test_bwd_wrapper_cpu_is_the_plain_backward():
    """On the CPU ``ops.flash_attention_bwd`` is ``_flash_bwd_impl`` in the
    model's layout, bit for bit, and keeps the reference's tile contract."""
    qn, kn, vn, don = _grad_inputs(256, seed=3)
    q, k, v, do = (torch.from_numpy(x) for x in (qn, kn, vn, don))
    out, lse = ref.flash_attention_plain_lse(q, k, v, window=64)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, window=64, block_q=128, block_k=64)
    hkv = k.shape[2]
    want = flash._flash_bwd_impl(
        flash._grouped_q(q, hkv), k.transpose(1, 2), v.transpose(1, 2),
        flash._grouped_q(out, hkv), lse.reshape(1, hkv, -1, 256), flash._grouped_q(do, hkv),
        causal=True, window=64, softcap=0.0, bq=128, bk=64)
    for a, w in zip(got, (flash._ungrouped_q(want[0]), want[1].transpose(1, 2),
                          want[2].transpose(1, 2))):
        assert torch.equal(a, w)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q[:, :200], k[:, :200], v[:, :200], out[:, :200],
                                lse[..., :200], do[:, :200], block_q=128, block_k=128)


def test_bwd_kv_splits_fill_the_card_and_keep_each_share():
    """The wgmma dk/dv sweep shares a kv tile's G heads among blocks only
    where B·Hkv·⌈S/rows⌉ blocks (128 keys a block, 64 at hd 256) are fewer
    than four a streaming multiprocessor, and never more shares than heads;
    fma never shares."""
    assert [fa.kv_sweep_rows(hd) for hd in fa.WGMMA_HEAD_DIMS] == [128] * 5 + [64]
    assert fa.bwd_kv_splits(2, 2048, 32, 4, 128, "wgmma") == 5     # yi-9b training: 128 blocks
    assert fa.bwd_kv_splits(1, 2048, 16, 2, 128, "wgmma") == 8     # a 6c rank: 32 blocks
    assert fa.bwd_kv_splits(1, 4096, 16, 1, 256, "wgmma") == 9     # recurrentgemma-9b: 64
    assert fa.bwd_kv_splits(1, 2048, 8, 1, 256, "wgmma") == 8      # a 6d rank: 32, at most G
    assert fa.bwd_kv_splits(1, 2048, 8, 8, 128, "wgmma") == 1      # MHA: one head a tile
    assert fa.bwd_kv_splits(1, 100, 16, 1, 64, "wgmma") == 16      # few blocks: at most G
    assert fa.bwd_kv_splits(4, 4096, 32, 4, 128, "wgmma") == 2     # 512 blocks
    assert fa.bwd_kv_splits(8, 4096, 32, 4, 128, "wgmma") == 1     # 1024 blocks
    assert fa.bwd_kv_splits(1, 100, 16, 1, 128, "fma") == 1
