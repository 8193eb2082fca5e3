"""Port flash attention: the plain PyTorch version against the JAX package's
Pallas kernel (interpret mode) and its dense oracle, on the reference's
kernel cases, and the wrapper's contract.  The CUDA kernel itself is held
against the plain version on a card in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

torch.set_num_threads(2)

FLASH_CASES = ref.FLASH_CASES
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
