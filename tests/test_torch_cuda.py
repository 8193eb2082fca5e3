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
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,hkv,hd,window,cap,dtype,tol", ref.FLASH_CASES)
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
def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 64, 4, 64), device=card)
    strided = torch.zeros((1, 4, 64, 64), device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(strided, q, q)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.cuda
def test_smoke_model_on_card_matches_cpu(card):
    cfg = configs.get_smoke("gemma2-27b").replace(compute_dtype="float32")
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
