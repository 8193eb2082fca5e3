"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each is the naive semantics, independent of the kernel's tiling: the CPU
path of :mod:`repro_torch.kernels.ops` and the yardstick the card's kernels
are held against.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as _attn

#: The JAX package's kernel cases (tests/test_kernels.py FLASH_CASES), the
#: shapes and tolerances the flash kernel is held to on the card and its
#: plain version on the CPU: (b, l, h, hkv, hd, window, softcap, dtype, tol).
FLASH_CASES = [
    (2, 256, 8, 4, 64, 0, 0.0, "float32", 2e-5),
    (1, 512, 4, 1, 32, 0, 0.0, "float32", 2e-5),
    (2, 256, 8, 8, 64, 128, 0.0, "float32", 2e-5),
    (1, 256, 4, 2, 128, 0, 30.0, "float32", 2e-5),
    (1, 512, 8, 2, 64, 128, 50.0, "float32", 2e-5),
    (2, 256, 8, 4, 64, 0, 0.0, "bfloat16", 2e-2),
    (1, 256, 16, 16, 32, 64, 0.0, "bfloat16", 2e-2),
]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Dense softmax attention. q: [B,L,H,hd]; k,v: [B,S,Hkv,hd]."""
    l, s = q.shape[1], k.shape[1]
    mask = (_attn.make_causal_mask(l, s, window=window, device=q.device)[None]
            if causal else None)
    return _attn._sdpa(q, k, v, mask, softcap)
