"""Launch of the hand-written Hopper SSD chunked-scan kernels (Mamba2).

The kernels replace the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``, in two variants that
:func:`variant` picks by shape and dtype:

* ``"mma"`` (``csrc/ssd_scan_sm90.cuh``): bf16 x/B/C at P in
  :data:`HEAD_DIMS`, N a multiple of 16 up to 128 and a chunk Q a multiple of
  16 up to 256; chunks in parallel, products on the tensor cores, in three
  launches through fp32 and bf16 scratch that this module allocates;
* ``"fma"`` (``csrc/ssd_scan.cu``): every other call, one block per (batch,
  head) walking the chunks, fp32 FMAs on the CUDA cores.

Each source's note says what bounds it on the card and how the design
answers.  This module validates the tensors, allocates the outputs and the
scratch and launches on the calling thread's current stream;
:func:`repro_torch.kernels.ops.ssd_scan` is the public wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 128
MAX_CHUNK = 256
VARIANTS = ("mma", "fma")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"fma": 0, "mma": 1}

_p = ctypes.c_void_p
_i = ctypes.c_int
_ARGTYPES = [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p]


def variant(p: int, n: int, q: int, dtype: torch.dtype) -> str:
    """The kernel a call of head dim ``p``, state ``n`` and chunk ``q`` in
    ``dtype`` runs: ``"mma"`` for bf16 with P in :data:`HEAD_DIMS`, N and Q
    multiples of 16 up to 128 and 256; ``"fma"`` for everything else."""
    if (dtype == torch.bfloat16 and p in HEAD_DIMS and n % 16 == 0
            and 16 <= n <= MAX_STATE and q % 16 == 0 and 16 <= q <= MAX_CHUNK):
        return "mma"
    return "fma"


def _lib():
    fn = build.load("ssd_scan").ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_chunk(l: int, chunk: int) -> int:
    """The reference's contract: q = min(chunk, L) and L % q == 0; returns q."""
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"L={l} must be a multiple of chunk={q}")
    return q


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, q: int, *,
                 return_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x:[Bt,L,H,P] dt:[Bt,L,H] a:[H] B,C:[Bt,L,N] on the card, chunk q.

    Returns (y in x's dtype, the fp32 [Bt,H,P,N] final state or None).  The
    mma variant also needs 16-byte aligned x, B and C (its copies move 16
    bytes at a time).
    """
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bmat.dim() != 3 \
            or bmat.shape != cmat.shape:
        raise ValueError(f"expected x [Bt,L,H,P], dt [Bt,L,H], a [H], B=C [Bt,L,N]; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    bt, l, h, p = x.shape
    n = bmat.shape[-1]
    if tuple(dt.shape) != (bt, l, h) or tuple(a.shape) != (h,) or bmat.shape[:2] != (bt, l):
        raise ValueError(f"incompatible x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, B/C {tuple(bmat.shape)}")
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE or not 1 <= q <= MAX_CHUNK or l % q:
        raise ValueError(f"kernel takes P in {HEAD_DIMS}, N <= {MAX_STATE}, chunk <= "
                         f"{MAX_CHUNK} dividing L; got P={p}, N={n}, chunk={q}, L={l}")
    if x.dtype not in _DTYPE_CODE or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise TypeError(f"x/B/C must share one of {list(_DTYPE_CODE)}; got "
                        f"{x.dtype}, {bmat.dtype}, {cmat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32; got {dt.dtype}, {a.dtype}")
    kind = variant(p, n, q, x.dtype)
    for name, t in (("x", x), ("dt", dt), ("a", a), ("B", bmat), ("C", cmat)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on x's CUDA device; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kind == "mma":
        for name, t in (("x", x), ("B", bmat), ("C", cmat)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary for the "
                                 "mma variant")
    y = torch.empty_like(x)
    h_last = (torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
              if return_state else None)
    scratch = [None, None, None]
    if kind == "mma":       # chunk states S_c, bf16 h_in[c], cumsum(dt·a) per chunk
        nc = l // q
        scratch = [torch.empty((bt, nc, h, p, n), dtype=torch.float32, device=x.device),
                   torch.empty((bt, nc, h, p, n), dtype=torch.bfloat16, device=x.device),
                   torch.empty((bt, nc, h, q), dtype=torch.float32, device=x.device)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                     cmat.data_ptr(), y.data_ptr(),
                     h_last.data_ptr() if return_state else None,
                     *(t.data_ptr() if t is not None else None for t in scratch),
                     bt, l, h, p, n, q, _DTYPE_CODE[x.dtype], _VARIANT_CODE[kind], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan ({kind}) launch failed: cudaError {err}")
    return y, h_last
