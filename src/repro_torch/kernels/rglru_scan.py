"""Launch of the hand-written Hopper RG-LRU scan kernel (RecurrentGemma).

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan``, in two instantiations that
:func:`variant` picks by width:

* ``"vec4"``: 16-byte (float4) lanes, for W % 4 == 0 (recurrentgemma-9b's
  4096); needs 16-byte-aligned log_a, b and h;
* ``"scalar"``: the same kernel with 4-byte lanes, for every other W.

The same source holds the backward (``rglru_scan_bwd``), which has no TPU
kernel to replace (the JAX package takes autodiff of
``repro/models/rglru.py:62`` ``scan_ref``), in the same two variants.  The
source's note says what bounds each on the card and how the design answers.
This module validates the tensors, allocates the outputs and launches on the
calling thread's current stream; :func:`repro_torch.kernels.ops.rglru_scan`
is the public wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

VARIANTS = ("vec4", "scalar")
_VARIANT_CODE = {"scalar": 0, "vec4": 1}

_p = ctypes.c_void_p
_i = ctypes.c_int
_ARGTYPES = [_p, _p, _p, _i, _i, _i, _i, _p]
_BWD_ARGTYPES = [_p, _p, _p, _p, _p, _i, _i, _i, _i, _p]


def variant(w: int) -> str:
    """The instantiation a call of width ``w`` runs: ``"vec4"`` where W % 4
    == 0, ``"scalar"`` otherwise."""
    return "vec4" if w % 4 == 0 else "scalar"


def _lib(entry: str = "rglru_scan_fwd", argtypes=_ARGTYPES):
    fn = getattr(build.load("rglru_scan"), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_tiles(l: int, w: int, block_l: int, block_w: int) -> None:
    """The reference's contract: L and W must tile by (min(block_l, L), min(block_w, W))."""
    bl, bw = min(block_l, l), min(block_w, w)
    if l % bl or w % bw:
        raise ValueError(f"L={l}, W={w} must tile by ({bl},{bw})")


def _check(**tensors: torch.Tensor) -> str:
    """Same [B,L,W] shape, fp32, contiguous, one CUDA device; 16-byte
    aligned where the width takes the vec4 variant, which it returns.
    Outputs come from torch.empty_like, whose blocks are aligned."""
    first = next(iter(tensors.values()))
    if first.dim() != 3 or any(t.shape != first.shape for t in tensors.values()):
        raise ValueError("expected " + " = ".join(tensors) + " [B,L,W]; got "
                         + ", ".join(str(tuple(t.shape)) for t in tensors.values()))
    kind = variant(first.shape[2])
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} must be on {next(iter(tensors))}'s CUDA device; "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if kind == "vec4" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the "
                             "vec4 variant")
    return kind


def rglru_scan_fwd(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b: [B,L,W] fp32 on the card → h [B,L,W] fp32."""
    kind = _check(log_a=log_a, b=b)
    bt, l, w = log_a.shape
    h = torch.empty_like(log_a)
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream(log_a.device).cuda_stream
        err = _lib()(log_a.data_ptr(), b.data_ptr(), h.data_ptr(), bt, l, w,
                     _VARIANT_CODE[kind], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan ({kind}) launch failed: cudaError {err}")
    return h


def rglru_scan_bwd(log_a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward: log_a, the forward's h and the cotangent dh, [B,L,W] fp32
    on the card → (dlog_a, db) [B,L,W] fp32."""
    kind = _check(log_a=log_a, h=h, dh=dh)
    bt, l, w = log_a.shape
    dlog_a, db = torch.empty_like(log_a), torch.empty_like(log_a)
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream(log_a.device).cuda_stream
        err = _lib("rglru_scan_bwd", _BWD_ARGTYPES)(
            log_a.data_ptr(), h.data_ptr(), dh.data_ptr(), dlog_a.data_ptr(), db.data_ptr(),
            bt, l, w, _VARIANT_CODE[kind], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd ({kind}) launch failed: cudaError {err}")
    return dlog_a, db
