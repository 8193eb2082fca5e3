"""Launch of the hand-written Hopper RG-LRU scan kernel (RecurrentGemma).

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan``, in two instantiations that
:func:`variant` picks by width:

* ``"vec4"``: 16-byte (float4) lanes, for W % 4 == 0 (recurrentgemma-9b's
  4096); needs 16-byte-aligned log_a, b and h;
* ``"scalar"``: the same kernel with 4-byte lanes, for every other W.

The source's note says what bounds it on the card and how the design
answers.  This module validates the tensors, allocates the output and
launches on the calling thread's current stream;
:func:`repro_torch.kernels.ops.rglru_scan` is the public wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

VARIANTS = ("vec4", "scalar")
_VARIANT_CODE = {"scalar": 0, "vec4": 1}

_p = ctypes.c_void_p
_i = ctypes.c_int
_ARGTYPES = [_p, _p, _p, _i, _i, _i, _i, _p]


def variant(w: int) -> str:
    """The instantiation a call of width ``w`` runs: ``"vec4"`` where W % 4
    == 0, ``"scalar"`` otherwise."""
    return "vec4" if w % 4 == 0 else "scalar"


def _lib():
    fn = build.load("rglru_scan").rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_tiles(l: int, w: int, block_l: int, block_w: int) -> None:
    """The reference's contract: L and W must tile by (min(block_l, L), min(block_w, W))."""
    bl, bw = min(block_l, l), min(block_w, w)
    if l % bl or w % bw:
        raise ValueError(f"L={l}, W={w} must tile by ({bl},{bw})")


def rglru_scan_fwd(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b: [B,L,W] fp32 on the card → h [B,L,W] fp32."""
    if log_a.dim() != 3 or log_a.shape != b.shape:
        raise ValueError(f"expected log_a = b [B,L,W]; got {tuple(log_a.shape)}, "
                         f"{tuple(b.shape)}")
    if log_a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"log_a and b must be float32; got {log_a.dtype}, {b.dtype}")
    for name, t in (("log_a", log_a), ("b", b)):
        if t.device.type != "cuda" or t.device != log_a.device:
            raise ValueError(f"{name} must be on log_a's CUDA device; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bt, l, w = log_a.shape
    kind = variant(w)
    h = torch.empty_like(log_a)
    if kind == "vec4":
        for name, t in (("log_a", log_a), ("b", b), ("h", h)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary for the "
                                 "vec4 variant")
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream(log_a.device).cuda_stream
        err = _lib()(log_a.data_ptr(), b.data_ptr(), h.data_ptr(), bt, l, w,
                     _VARIANT_CODE[kind], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan ({kind}) launch failed: cudaError {err}")
    return h
