"""Launch of the hand-written Hopper flash-attention kernels: the forward
and its FA2 backward.

The kernels replace the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``, in two variants
that :func:`variant` picks by head dim and dtype:

* ``"wgmma"`` (``csrc/flash_attention_sm90.cuh``): bf16 at head dims 16, 32,
  64, 96, 128 and 256, both products on the tensor cores, K/V loaded by TMA;
* ``"fma"`` (``csrc/flash_attention.cu``): fp32 at every head dim it has and bf16 at
  head dim 8, fp32 FMA products on the CUDA cores.

Each source's note says what bounds it on the card and how the design
answers.

The reference's kernel takes any head dim; these kernels are instantiated
per head dim (:data:`HEAD_DIMS`), so a head dim outside it raises on the card
while the CPU path, the plain version, takes it.  A smoke config runs
narrower heads than its full config (phi-3-vision-4.2b: hd 16 in the smoke
config, 96 at full width), so such a gap shows only at full width; the tests
hold every config's head dim, full and smoke, to :data:`HEAD_DIMS`.

This module validates the tensors, allocates the output (and, for training,
each row's log-sum-exp) and launches on the calling thread's current
stream, as the operator ``repro_torch::flash_attention_fwd``
(:mod:`repro_torch.kernels.library`: a fake implementation for tracing and
the FLOP formula :func:`flops`); :func:`repro_torch.kernels.ops.flash_attention`
is the public wrapper.

The backward (``csrc/flash_attention_bwd.cu``, the operator
``repro_torch::flash_attention_bwd``) replaces no TPU kernel: it is the
counterpart of the reference's jnp backward
``repro/models/flash.py::_flash_bwd_impl``, in two variants that
:func:`bwd_variant` picks as :func:`variant` picks the forward's: ``"wgmma"``
(``csrc/flash_attention_bwd_sm90.cuh``: bf16 at :data:`WGMMA_HEAD_DIMS`,
every product on wgmma, tiles loaded by TMA) and ``"fma"`` (fp32 at every
head dim, bf16 at 8).  It allocates dq, dk, dv, each row's fp32 ``delta =
rowsum(do · out)`` [B,H,L] and, where the wgmma dk/dv sweep shares a kv
tile's heads among blocks (:func:`bwd_kv_splits`),
their fp32 partial sums; :func:`bwd_flops` counts its five products over
the visible pairs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from repro_torch.kernels import build, library

HEAD_DIMS = (8, 16, 32, 64, 96, 128, 256)
WGMMA_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
VARIANTS = ("wgmma", "fma")
BWD_VARIANTS = ("wgmma", "fma")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"fma": 0, "wgmma": 1}
_BWD_VARIANT_CODE = {"fma": 0, "wgmma": 1}

_p = ctypes.c_void_p
_i = ctypes.c_int
_ARGTYPES = [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
             ctypes.c_float, ctypes.c_float, _p]
_BWD_ARGTYPES = [_p] * 10 + [_i] * 10 + [ctypes.c_float, ctypes.c_float, _i, _p, _p]
#: the streaming multiprocessors of the card the port targets, the H100 SXM
#: (fixed, not read from a device: the fake implementation sizes the dk/dv
#: partial sums in a trace that has no card)
H100_SXM_SMS = 132
#: the blocks the backward's dk/dv sweep aims at: four for each SM
#: (:func:`bwd_kv_splits`; one is resident at a time, and smaller shares
#: even out the causal tiles' work: on the card, four beat two and three at
#: recurrentgemma-9b's windowed shape and tied them at yi-9b's)
KV_SWEEP_BLOCKS = 4 * H100_SXM_SMS


def kv_sweep_rows(hd: int) -> int:
    """The kv rows of one block of the wgmma dk/dv sweep: 64 for each of
    its two consumer warpgroups, but 64 in all at head dim 256, where the
    two share the keys and each takes half the head dim
    (``BwdCfg::KV_ROWS`` in ``csrc/flash_attention_bwd_sm90.cuh``)."""
    return 64 if hd == 256 else 128


def variant(hd: int, dtype: torch.dtype) -> str:
    """The kernel a call of head dim ``hd`` in ``dtype`` runs: ``"wgmma"`` for
    bf16 at :data:`WGMMA_HEAD_DIMS`, ``"fma"`` for everything else
    :data:`HEAD_DIMS` allows."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; kernel has {HEAD_DIMS}")
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "fma"


def bwd_variant(hd: int, dtype: torch.dtype) -> str:
    """The backward kernel a call of head dim ``hd`` in ``dtype`` runs:
    ``"wgmma"`` for bf16 at :data:`WGMMA_HEAD_DIMS`, ``"fma"`` for
    everything else :data:`HEAD_DIMS` allows (every head dim the forward
    takes has a backward, on the forward's variant)."""
    return variant(hd, dtype)


def bwd_kv_splits(b: int, s_len: int, h: int, hkv: int, hd: int, kind: str) -> int:
    """The blocks among which the wgmma backward's dk/dv sweep shares a
    (batch, kv head, kv tile)'s G query heads: 1 where B·Hkv·⌈S/rows⌉
    blocks (rows: :func:`kv_sweep_rows`) reach :data:`KV_SWEEP_BLOCKS`,
    else as many as reach it, at most G (each share sums its heads into
    fp32 partials that a second pass adds in a fixed order); the fma
    variant takes 1."""
    if kind != "wgmma":
        return 1
    base = b * hkv * -(-s_len // kv_sweep_rows(hd))
    return max(1, min(h // hkv, -(-KV_SWEEP_BLOCKS // base)))


def _lib(name: str = "flash_attention", entry: str = "flash_attention_fwd",
         argtypes=_ARGTYPES):
    fn = getattr(build.load(name), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_tiles(l: int, s_len: int, block_q: int, block_k: int) -> None:
    """The reference's ragged-shape contract: L and S must tile by the blocks."""
    bq, bk = min(block_q, l), min(block_k, s_len)
    if l % bq or s_len % bk:
        raise ValueError(f"L={l}, S={s_len} must tile by ({bq},{bk})")


def pairs(l: int, s_len: int, *, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs the kernel's mask keeps over one head: causal,
    key j ≤ query i (and j > i − window with a window); without causal, j >
    i − window with a window and every key without one."""
    if causal:
        c = min(s_len, window) if window else s_len
        return l * (l + 1) // 2 if l <= c else c * (c + 1) // 2 + (l - c) * c
    if not window:
        return l * s_len
    return sum(max(0, s_len - max(0, i - window + 1)) for i in range(l))


def flops(b: int, l: int, s_len: int, h: int, hd: int, *, causal: bool = True,
          window: int = 0) -> int:
    """Products of one forward: q·kᵀ and p·v, 2·hd each per kept pair and
    head (the kernel table's bound, and the dry run's count)."""
    return 4 * b * h * hd * pairs(l, s_len, causal=causal, window=window)


def bwd_flops(b: int, l: int, s_len: int, h: int, hd: int, *, causal: bool = True,
              window: int = 0) -> int:
    """Products of one backward, counted as the reference's FA2 has them:
    q·kᵀ, do·vᵀ, pᵀ·do, dsᵀ·q and ds·k, 2·hd each per kept pair and head
    (the kernel's two sweeps recompute q·kᵀ and do·vᵀ: 7 products done)."""
    return 10 * b * h * hd * pairs(l, s_len, causal=causal, window=window)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Shapes, dtypes, device and layout (everything but the data's
    address); returns the variant the call takes."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,L,H,hd], k=v [B,S,Hkv,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, h, hd = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    kind = variant(hd, q.dtype)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPE_CODE)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not library.on_card(t) or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return kind


def _buffers(q: torch.Tensor, return_lse: bool):
    """What a launch allocates, on the card and in a trace: the output and,
    with ``return_lse``, each row's fp32 log-sum-exp [B,H,L]."""
    b, l, h, _ = q.shape
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device) if return_lse else None
    return torch.empty_like(q), lse


def _launch(q, k, v, causal: bool, window: int, softcap: float, return_lse: bool):
    """The operator's CUDA implementation: one counted launch."""
    kind = variant(q.shape[3], q.dtype)
    if kind == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary for TMA")
    b, l, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    out, lse = _buffers(q, return_lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if return_lse else None, b, l, s_len, h, hkv, hd,
                     _DTYPE_CODE[q.dtype], _VARIANT_CODE[kind], int(causal), int(window),
                     float(softcap), 1.0 / (hd ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({kind}) launch failed: cudaError {err}")
    library.counted("flash_attention", kind)
    return out, lse


def _fake(q, k, v, causal: bool, window: int, softcap: float, return_lse: bool):
    _check(q, k, v)
    out, lse = _buffers(q, return_lse)
    library.fake_allocated(out, lse)
    return out, lse


def _flops(q, k, v, causal: bool, window: int, softcap: float, return_lse: bool, **_):
    b, l, h, hd = q
    return flops(b, l, k[1], h, hd, causal=causal, window=window)


def _check_bwd(q, k, v, out, lse, do) -> str:
    """The forward's checks, and the forward's output, its lse and the
    cotangent's; returns the backward's variant."""
    _check(q, k, v)
    b, l, h, hd = q.shape
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}")
    if tuple(lse.shape) != (b, h, l) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, l)} on {q.device}")
    return bwd_variant(hd, q.dtype)


def _bwd_buffers(q, k, v, kind: str):
    """What a backward launch allocates, on the card and in a trace: dq, dk,
    dv, the fp32 delta [B,H,L] the two sweeps read and, where the dk/dv
    sweep splits the heads (:func:`bwd_kv_splits`), its fp32 partial sums
    of dk and dv [2, splits, B,S,Hkv,hd] (else None)."""
    b, l, h, hd = q.shape
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    splits = bwd_kv_splits(b, k.shape[1], h, k.shape[2], hd, kind)
    part = (torch.empty((2, splits, *k.shape), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)), delta, part


def _launch_bwd(q, k, v, out, lse, do, causal: bool, window: int, softcap: float):
    """The backward operator's CUDA implementation: one counted launch (the
    delta pass and the two sweeps, on the current stream)."""
    kind = bwd_variant(q.shape[3], q.dtype)
    if kind == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary for TMA")
    b, l, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    (dq, dk, dv), delta, part = _bwd_buffers(q, k, v, kind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, l, s_len, h, hkv, hd, _DTYPE_CODE[q.dtype], _BWD_VARIANT_CODE[kind],
            int(causal), int(window), float(softcap), 1.0 / (hd ** 0.5),
            1 if part is None else part.shape[1], None if part is None else part.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd ({kind}) launch failed: cudaError {err}")
    library.counted("flash_attention_bwd", kind)
    return dq, dk, dv


def _fake_bwd(q, k, v, out, lse, do, causal: bool, window: int, softcap: float):
    grads, delta, part = _bwd_buffers(q, k, v, _check_bwd(q, k, v, out, lse, do))
    library.fake_allocated(*grads, delta, part)
    return grads


def _flops_bwd(q, k, v, out, lse, do, causal: bool, window: int, softcap: float, **_):
    b, l, h, hd = q
    return bwd_flops(b, l, k[1], h, hd, causal=causal, window=window)


library.counter("flash_attention", VARIANTS)
library.counter("flash_attention_bwd", BWD_VARIANTS)
#: ``repro_torch::flash_attention_fwd``
OP = library.register("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
                      "int window, float softcap, bool return_lse) -> (Tensor, Tensor?)",
                      _launch, _fake, _flops)
#: ``repro_torch::flash_attention_bwd``
BWD_OP = library.register("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
                          "Tensor lse, Tensor do, bool causal, int window, float softcap) -> "
                          "(Tensor, Tensor, Tensor)", _launch_bwd, _fake_bwd, _flops_bwd)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, softcap: float = 0.0,
                        return_lse: bool = False
                        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q: [B,L,H,hd]; k,v: [B,S,Hkv,hd] on the card → [B,L,H,hd] in q's dtype.

    With ``return_lse`` also each row's fp32 log-sum-exp, [B,H,L], of its
    scaled, capped, masked logits (the backward's input); without it the
    kernel is passed a null pointer and stores nothing more.  Checks the
    inputs, then calls :data:`OP`.
    """
    _check(q, k, v)
    out, lse = OP(q, k, v, bool(causal), int(window), float(softcap), bool(return_lse))
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention_fwd` on the card: q, out, do
    [B,L,H,hd], k, v [B,S,Hkv,hd], the forward's fp32 lse [B,H,L] → (dq, dk,
    dv) in q's, k's and v's dtypes, on the variant :func:`bwd_variant` picks.
    Checks the inputs, then calls :data:`BWD_OP`."""
    _check_bwd(q, k, v, out, lse, do)
    return BWD_OP(q, k, v, out, lse, do, bool(causal), int(window), float(softcap))
