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

Its backward, :func:`ssd_scan_bwd` (``csrc/ssd_scan_bwd.cu``), has no TPU
kernel to replace: the JAX package takes autodiff of
``repro/models/ssm.py:99`` ``ssd_chunked``.  One variant for every shape
the forward takes, fp32 FMAs on the CUDA cores.

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
_BWD_ARGTYPES = [_p] * 22 + [_i] * 7 + [_p]


def variant(p: int, n: int, q: int, dtype: torch.dtype) -> str:
    """The kernel a call of head dim ``p``, state ``n`` and chunk ``q`` in
    ``dtype`` runs: ``"mma"`` for bf16 with P in :data:`HEAD_DIMS`, N and Q
    multiples of 16 up to 128 and 256; ``"fma"`` for everything else."""
    if (dtype == torch.bfloat16 and p in HEAD_DIMS and n % 16 == 0
            and 16 <= n <= MAX_STATE and q % 16 == 0 and 16 <= q <= MAX_CHUNK):
        return "mma"
    return "fma"


def _lib(name: str = "ssd_scan", entry: str = "ssd_scan_fwd", argtypes=_ARGTYPES):
    fn = getattr(build.load(name), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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
    kind = _check(x, dt, a, bmat, cmat, q)
    bt, l, h, p = x.shape
    n = bmat.shape[-1]
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


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, q: int, dy: torch.Tensor,
                 dh_last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`ssd_scan_fwd` at the same inputs, for the
    cotangents dy (x's shape and dtype) and dh_last (fp32 [Bt,H,P,N], or
    None for zero).  Returns (dx, ddt, da, dB, dC): dx, dB, dC in x's dtype,
    ddt and da fp32.  The kernel's fp32 scratch (states, per-head dB/dC
    partials) is allocated here."""
    _check(x, dt, a, bmat, cmat, q)
    bt, l, h, p = x.shape
    n, nc = bmat.shape[-1], l // q
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} {tuple(x.shape)} on {x.device}")
    if dh_last is not None and (tuple(dh_last.shape) != (bt, h, p, n)
                                or dh_last.dtype != torch.float32
                                or dh_last.device != x.device or not dh_last.is_contiguous()):
        raise ValueError(f"dh_last must be a contiguous float32 {(bt, h, p, n)} on {x.device}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dbm, dcm = torch.empty_like(x), torch.empty_like(bmat), torch.empty_like(cmat)
    ddt, da = torch.empty_like(dt), torch.empty_like(a)
    scratch = [torch.empty((bt, nc, h, q), **f32),                  # cum
               *(torch.empty((bt, nc, h, p, n), **f32) for _ in range(3)),  # S→dS, U, h_in
               *(torch.empty((bt, l, h, n), **f32) for _ in range(2)),      # dB, dC per head
               *(torch.empty((bt, l, h), **f32) for _ in range(3)),         # drow, dcol, uw
               torch.empty((bt, nc, h), **f32)]                             # da per chunk
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib("ssd_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            dy.data_ptr(), dh_last.data_ptr() if dh_last is not None else None,
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
            *(t.data_ptr() for t in scratch), bt, l, h, p, n, q, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaError {err}")
    return dx, ddt, da, dbm, dcm


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
           cmat: torch.Tensor, q: int) -> str:
    """Validate the forward's inputs; returns the variant they take."""
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
    return kind
