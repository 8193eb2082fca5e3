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

Its backward, :func:`ssd_scan_bwd`, has no TPU kernel to replace: the JAX
package takes autodiff of ``repro/models/ssm.py:99`` ``ssd_chunked``.  It
has the same two variants, picked by :func:`bwd_variant`:

* ``"mma"`` (``csrc/ssd_scan_bwd_sm90.cu``): the forward's mma domain; every
  product on the tensor cores, C·Bᵀ computed once per block for a group of
  :func:`bwd_heads_per_block` heads, dB and dC summed over the group inside
  the block;
* ``"fma"`` (``csrc/ssd_scan_bwd.cu``): every other call, fp32 FMAs on the
  CUDA cores.

Each source's note says what bounds it on the card and how the design
answers.  This module validates the tensors, allocates the outputs and the
scratch and launches on the calling thread's current stream, as the
operators ``repro_torch::ssd_scan_fwd`` and ``repro_torch::ssd_scan_bwd``
(:mod:`repro_torch.kernels.library`: fake implementations that allocate the
same scratch, and the FLOP formulas :func:`flops` and :func:`bwd_flops`);
:func:`repro_torch.kernels.ops.ssd_scan` is the public wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, library

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
#: the mma entry point: two more pointers (the split states) and, as its
#: last int, the heads per block instead of the dtype
_BWD_MMA_ARGTYPES = [_p] * 24 + [_i] * 7 + [_p]
#: heads a block of the mma backward's pair passes takes at most (chosen on
#: the card by ``launch/ssd_bwd_experiments.py heads``: PERF.md §6)
BWD_HEADS_PER_BLOCK = 8


def variant(p: int, n: int, q: int, dtype: torch.dtype) -> str:
    """The kernel a call of head dim ``p``, state ``n`` and chunk ``q`` in
    ``dtype`` runs: ``"mma"`` for bf16 with P in :data:`HEAD_DIMS`, N and Q
    multiples of 16 up to 128 and 256; ``"fma"`` for everything else."""
    if (dtype == torch.bfloat16 and p in HEAD_DIMS and n % 16 == 0
            and 16 <= n <= MAX_STATE and q % 16 == 0 and 16 <= q <= MAX_CHUNK):
        return "mma"
    return "fma"


#: the backward kernel a call takes: the backward's two variants have the
#: forward's domains
bwd_variant = variant


def bwd_heads_per_block(h: int) -> int:
    """Heads that share a block of the mma backward's pair passes: the
    largest divisor of ``h`` that is at most :data:`BWD_HEADS_PER_BLOCK`."""
    return max(g for g in range(1, min(h, BWD_HEADS_PER_BLOCK) + 1) if h % g == 0)


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


def flops(bt: int, l: int, h: int, p: int, n: int, q: int) -> int:
    """Products the forward needs: C·Bᵀ over the causal pairs of each
    (batch, chunk), shared by the heads; per head the masked scores times X,
    C·h_prevᵀ and the state update Xᵀ(B ⊙ w) (the kernel table's bound, and
    the dry run's count)."""
    nc, pairs = l // q, q * (q + 1) // 2
    return 2 * bt * nc * pairs * n + 2 * bt * nc * h * (pairs * p + 2 * q * p * n)


def bwd_flops(bt: int, l: int, h: int, p: int, n: int, q: int) -> int:
    """Products the backward needs: per (batch, chunk) C·Bᵀ over the causal
    pairs (shared by the heads); per head r = dy·xᵀ over the pairs, the three
    pair products into dx, dB, dC, and six [Q,P]×[P,N]-sized state products
    (S_c, U_c, dS·B, dSᵀ·x, h_in·C, h_inᵀ·dy)."""
    nc, pairs = l // q, q * (q + 1) // 2
    return (2 * bt * nc * pairs * n
            + 2 * bt * nc * h * (pairs * (2 * p + 2 * n) + 6 * q * p * n))


def _fwd_buffers(x: torch.Tensor, bmat: torch.Tensor, q: int, return_state: bool, kind: str):
    """What a forward launch allocates, on the card and in a trace: y, the
    final state (or None) and the mma variant's scratch (chunk states S_c,
    bf16 h_in[c], cumsum(dt·a) per chunk; three Nones for fma)."""
    bt, l, h, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty_like(x)
    h_last = (torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
              if return_state else None)
    scratch = [None, None, None]
    if kind == "mma":
        nc = l // q
        scratch = [torch.empty((bt, nc, h, p, n), dtype=torch.float32, device=x.device),
                   torch.empty((bt, nc, h, p, n), dtype=torch.bfloat16, device=x.device),
                   torch.empty((bt, nc, h, q), dtype=torch.float32, device=x.device)]
    return y, h_last, scratch


def _bwd_buffers(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, q: int, kind: str):
    """What a backward launch allocates, on the card and in a trace: (dx,
    ddt, da, dB, dC) and the fp32 scratch (states, dB/dC partials: one per
    head for fma, one per group of :func:`bwd_heads_per_block` heads for
    mma; the mma variant also splits h_in[c] and dS_c into bf16 hi and lo)."""
    bt, l, h, p = x.shape
    n, nc = bmat.shape[-1], l // q
    parts = h // bwd_heads_per_block(h) if kind == "mma" else h
    f32 = dict(dtype=torch.float32, device=x.device)
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a),
             torch.empty_like(bmat), torch.empty_like(cmat))
    scratch = [torch.empty((bt, nc, h, q), **f32),                  # cum
               *(torch.empty((bt, nc, h, p, n), **f32) for _ in range(2)),  # S (→ dS), U
               torch.empty((bt, nc, h, p * n // 128) if kind == "mma"      # dγ by warp
                           else (bt, nc, h, p, n), **f32),                  # h_in
               *(torch.empty((bt, l, parts, n), **f32) for _ in range(2)),  # dB, dC partials
               *(torch.empty((bt, l, h), **f32) for _ in range(3)),         # drow, dcol, uw
               torch.empty((bt, nc, h), **f32)]                             # da per chunk
    if kind == "mma":
        scratch += [torch.empty((2, bt, nc, h, p, n), dtype=torch.bfloat16, device=x.device)
                    for _ in range(2)]
    return grads, scratch


def _check_aligned(kind: str, **tensors: Optional[torch.Tensor]) -> None:
    """The mma variant's copies move 16 bytes at a time."""
    if kind != "mma":
        return
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the mma variant")


def _launch_fwd(x, dt, a, bmat, cmat, q: int, return_state: bool):
    """The forward operator's CUDA implementation: one counted launch."""
    kind = variant(x.shape[3], bmat.shape[-1], q, x.dtype)
    _check_aligned(kind, x=x, B=bmat, C=cmat)
    bt, l, h, p = x.shape
    n = bmat.shape[-1]
    y, h_last, scratch = _fwd_buffers(x, bmat, q, return_state, kind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                     cmat.data_ptr(), y.data_ptr(),
                     h_last.data_ptr() if return_state else None,
                     *(t.data_ptr() if t is not None else None for t in scratch),
                     bt, l, h, p, n, q, _DTYPE_CODE[x.dtype], _VARIANT_CODE[kind], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan ({kind}) launch failed: cudaError {err}")
    library.counted("ssd_scan", kind)
    return y, h_last


def _fake_fwd(x, dt, a, bmat, cmat, q: int, return_state: bool):
    kind = _check(x, dt, a, bmat, cmat, q)
    y, h_last, scratch = _fwd_buffers(x, bmat, q, return_state, kind)
    library.fake_allocated(y, h_last, *scratch)
    return y, h_last


def _flops_fwd(x, dt, a, bmat, cmat, q: int, return_state: bool, **_):
    bt, l, h, p = x
    return flops(bt, l, h, p, bmat[-1], q)


def _launch_bwd(x, dt, a, bmat, cmat, q: int, dy, dh_last):
    """The backward operator's CUDA implementation: one counted launch."""
    kind = bwd_variant(x.shape[3], bmat.shape[-1], q, x.dtype)
    _check_aligned(kind, x=x, B=bmat, C=cmat, dy=dy, dh_last=dh_last)
    bt, l, h, p = x.shape
    n = bmat.shape[-1]
    (dx, ddt, da, dbm, dcm), scratch = _bwd_buffers(x, dt, a, bmat, cmat, q, kind)
    args = [x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            dy.data_ptr(), dh_last.data_ptr() if dh_last is not None else None,
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
            *(t.data_ptr() for t in scratch), bt, l, h, p, n, q]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kind == "mma":
            err = _lib("ssd_scan_bwd_mma", "ssd_scan_bwd_mma", _BWD_MMA_ARGTYPES)(
                *args, bwd_heads_per_block(h), stream)
        else:
            err = _lib("ssd_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)(
                *args, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd ({kind}) launch failed: cudaError {err}")
    library.counted("ssd_scan_bwd", kind)
    return dx, ddt, da, dbm, dcm


def _fake_bwd(x, dt, a, bmat, cmat, q: int, dy, dh_last):
    kind = _check_bwd(x, dt, a, bmat, cmat, q, dy, dh_last)
    grads, scratch = _bwd_buffers(x, dt, a, bmat, cmat, q, kind)
    library.fake_allocated(*grads, *scratch)
    return grads


def _flops_bwd(x, dt, a, bmat, cmat, q: int, dy, dh_last, **_):
    bt, l, h, p = x
    return bwd_flops(bt, l, h, p, bmat[-1], q)


library.counter("ssd_scan", VARIANTS)
library.counter("ssd_scan_bwd", VARIANTS)
#: ``repro_torch::ssd_scan_fwd``
OP = library.register("ssd_scan_fwd(Tensor x, Tensor dt, Tensor a, Tensor B, Tensor C, int q, "
                      "bool return_state) -> (Tensor, Tensor?)", _launch_fwd, _fake_fwd,
                      _flops_fwd)
#: ``repro_torch::ssd_scan_bwd``
BWD_OP = library.register("ssd_scan_bwd(Tensor x, Tensor dt, Tensor a, Tensor B, Tensor C, "
                          "int q, Tensor dy, Tensor? dh_last) -> (Tensor, Tensor, Tensor, "
                          "Tensor, Tensor)", _launch_bwd, _fake_bwd, _flops_bwd)


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, q: int, *,
                 return_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x:[Bt,L,H,P] dt:[Bt,L,H] a:[H] B,C:[Bt,L,N] on the card, chunk q.

    Returns (y in x's dtype, the fp32 [Bt,H,P,N] final state or None).  The
    mma variant also needs 16-byte aligned x, B and C (its copies move 16
    bytes at a time).  Checks the inputs, then calls :data:`OP`.
    """
    _check(x, dt, a, bmat, cmat, q)
    return OP(x, dt, a, bmat, cmat, q, bool(return_state))


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, q: int, dy: torch.Tensor,
                 dh_last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`ssd_scan_fwd` at the same inputs, for the
    cotangents dy (x's shape and dtype) and dh_last (fp32 [Bt,H,P,N], or
    None for zero), on the variant :func:`bwd_variant` picks.  Returns (dx,
    ddt, da, dB, dC): dx, dB, dC in x's dtype, ddt and da fp32.  The
    kernel's scratch is allocated by the operator (:data:`BWD_OP`)."""
    _check_bwd(x, dt, a, bmat, cmat, q, dy, dh_last)
    return BWD_OP(x, dt, a, bmat, cmat, q, dy, dh_last)


def _check_bwd(x, dt, a, bmat, cmat, q: int, dy, dh_last) -> str:
    """The forward's checks and the cotangents'; returns the variant."""
    kind = _check(x, dt, a, bmat, cmat, q)
    bt, _, h, p = x.shape
    n = bmat.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} {tuple(x.shape)} on {x.device}")
    if dh_last is not None and (tuple(dh_last.shape) != (bt, h, p, n)
                                or dh_last.dtype != torch.float32
                                or dh_last.device != x.device or not dh_last.is_contiguous()):
        raise ValueError(f"dh_last must be a contiguous float32 {(bt, h, p, n)} on {x.device}")
    return kind


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
           cmat: torch.Tensor, q: int) -> str:
    """Validate the forward's inputs (everything but the data's address);
    returns the variant they take."""
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
    for name, t in (("x", x), ("dt", dt), ("a", a), ("B", bmat), ("C", cmat)):
        if not library.on_card(t) or t.device != x.device:
            raise ValueError(f"{name} must be on x's CUDA device; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return variant(p, n, q, x.dtype)
