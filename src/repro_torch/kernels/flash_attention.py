"""Launch of the hand-written Hopper flash-attention forward kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``; its note says what
bounds it on the card and how the design answers.  This module validates the
tensors, allocates the output and launches on the calling thread's current
stream; :func:`repro_torch.kernels.ops.flash_attention` is the public wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_p = ctypes.c_void_p
_i = ctypes.c_int
_ARGTYPES = [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i,
             ctypes.c_float, ctypes.c_float, _p]


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_tiles(l: int, s_len: int, block_q: int, block_k: int) -> None:
    """The reference's ragged-shape contract: L and S must tile by the blocks."""
    bq, bk = min(block_q, l), min(block_k, s_len)
    if l % bq or s_len % bk:
        raise ValueError(f"L={l}, S={s_len} must tile by ({bq},{bk})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: [B,L,H,hd]; k,v: [B,S,Hkv,hd] on the card → [B,L,H,hd] in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,L,H,hd], k=v [B,S,Hkv,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; kernel has {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPE_CODE)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, l, s_len, h, hkv, hd, _DTYPE_CODE[q.dtype], int(causal),
                     int(window) if causal else 0, float(softcap),
                     1.0 / (hd ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    return out
