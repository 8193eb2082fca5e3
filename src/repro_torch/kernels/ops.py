"""Public wrappers for the port's kernels.

A wrapper picks its path by the device of the tensors it is given: on the
CPU it runs the plain version in :mod:`repro_torch.kernels.ref`; on the card
it launches the hand-written kernel or raises.  There is no switch that sends
a CUDA tensor to the plain version.

Each kernel is a ``torch.library`` operator (:mod:`repro_torch.kernels.library`)
whose CUDA implementation counts its launches in :data:`launches` and by
variant; a fake tensor reaches the operator's fake implementation, which
allocates what the launch would and counts nothing.  On the card the two
scans are ``torch.autograd.Function``s (:data:`RGLRUScan`, :data:`SSDScan`)
whose backward is a kernel too (``rglru_scan_bwd``, ``ssd_scan_bwd``); on the
CPU autograd differentiates their plain versions.  Flash attention's
backward is a kernel too (:func:`flash_attention_bwd`, ``flash_attention_bwd``),
which :mod:`repro_torch.models.flash`'s Function calls.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import library, ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd

#: kernel name → launches since the last :func:`reset_launches`
launches = library.launches
#: flash-attention variant (:func:`flash_attention.variant`) → its share of
#: ``launches["flash_attention"]``
flash_variant_launches = library.variant_launches["flash_attention"]
#: flash-attention backward variant (:func:`flash_attention.bwd_variant`) →
#: its share of ``launches["flash_attention_bwd"]``
flash_bwd_variant_launches = library.variant_launches["flash_attention_bwd"]
#: SSD-scan variant (:func:`ssd_scan.variant`) → its share of
#: ``launches["ssd_scan"]``
ssd_variant_launches = library.variant_launches["ssd_scan"]
#: SSD backward variant (:func:`ssd_scan.bwd_variant`) → its share of
#: ``launches["ssd_scan_bwd"]``
ssd_bwd_variant_launches = library.variant_launches["ssd_scan_bwd"]
#: RG-LRU-scan variant (:func:`rglru_scan.variant`) → its share of
#: ``launches["rglru_scan"]``
rglru_variant_launches = library.variant_launches["rglru_scan"]
#: RG-LRU backward variant (the forward's, by width) → its share of
#: ``launches["rglru_scan_bwd"]``
rglru_bwd_variant_launches = library.variant_launches["rglru_scan_bwd"]
reset_launches = library.reset


def _check_device(name: str, t: torch.Tensor) -> None:
    if not library.on_card(t):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    block_q: int = 512, block_k: int = 512, return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash-attention forward. q: [B,L,H,hd]; k,v: [B,S,Hkv,hd].

    ``block_q``/``block_k`` keep the reference's signature and its contract
    (L and S must tile by them, else ``ValueError``); the CUDA kernel picks
    its own tile shape inside that contract.  ``window`` applies with or
    without ``causal``, as in the reference's kernel.  With ``return_lse``
    it returns ``(out, lse)``, lse fp32 [B,H,L] (the backward's input).

    The kernel's output carries no autograd history, so on the card an
    input that needs a gradient is refused (:func:`refuse_grad`): training
    goes through :func:`repro_torch.models.flash.flash_attention`, whose
    backward is :func:`flash_attention_bwd`.
    """
    _fa.check_tiles(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        plain = ref.flash_attention_plain_lse if return_lse else ref.flash_attention_plain
        return plain(q, k, v, causal=causal, window=window, softcap=softcap)
    _check_device("flash_attention", q)
    refuse_grad("flash_attention", q, k, v,
                instead="differentiate through repro_torch.models.flash.flash_attention")
    return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap,
                                   return_lse=return_lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0, block_q: int = 512,
                        block_k: int = 512) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward (FA2). q, out, do: [B,L,H,hd]; k, v:
    [B,S,Hkv,hd]; lse: the forward's fp32 [B,H,L] → (dq, dk, dv) in q's,
    k's and v's dtypes.

    The reference's contract (L and S must tile by ``block_q``/``block_k``,
    else ``ValueError``).  On the CPU the plain version,
    :func:`repro_torch.models.flash.flash_bwd_plain` on ``(min(block_q, L),
    min(block_k, S))`` tiles; on the card the backward kernel, which picks
    its own tiles.
    """
    _fa.check_tiles(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        from repro_torch.models import flash   # the Function's module imports this one
        return flash.flash_bwd_plain(q, k, v, out, lse, do, causal=causal, window=window,
                                     softcap=softcap, bq=min(block_q, q.shape[1]),
                                     bk=min(block_k, k.shape[1]))
    _check_device("flash_attention_bwd", q)
    return _fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window,
                                   softcap=softcap)


def refuse_grad(name: str, *inputs: torch.Tensor, instead: str) -> None:
    """Raise ``NotImplementedError`` where a kernel would be handed an input
    that needs a gradient outside an ``autograd.Function``: its ``ctypes``
    launch returns a tensor with no autograd history, and the gradient would
    be lost without a word.  ``instead`` says what to do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(f"{name} on the card returns no autograd history: {instead}")


# ==========================================================================
# The scans: autograd.Functions whose forward and backward are kernels
# ==========================================================================


def rglru_function(fwd: Callable, bwd: Callable) -> type:
    """An ``autograd.Function`` for h = scan(log_a, b): ``fwd(log_a, b) → h``
    and ``bwd(log_a, h, dh) → (dlog_a, db)``.  It saves log_a and the
    forward's h (b is not needed: db = g).  :data:`RGLRUScan` is built from
    the kernels; a test builds one from the plain formulas to check the
    plumbing."""

    class _RGLRUScan(torch.autograd.Function):

        @staticmethod
        def forward(ctx, log_a, b):
            h = fwd(log_a, b)
            ctx.save_for_backward(log_a, h)
            ctx.dtypes = (log_a.dtype, b.dtype)
            return h

        @staticmethod
        def backward(ctx, dh):
            log_a, h = ctx.saved_tensors
            dlog_a, db = bwd(log_a, h, dh.to(h.dtype).contiguous())
            return dlog_a.to(ctx.dtypes[0]), db.to(ctx.dtypes[1])

    return _RGLRUScan


def ssd_function(fwd: Callable, bwd: Callable) -> type:
    """An ``autograd.Function`` for the SSD scan: ``fwd(x, dt, a, B, C, q,
    return_state) → (y, h_last or None)`` and ``bwd(x, dt, a, B, C, q, dy,
    dh_last or None) → (dx, ddt, da, dB, dC)``.  It saves the five inputs.
    With ``return_state`` it returns (y, h_last) and the gradient of h_last
    goes into the backward's reverse state pass; a dropped h_last (as in
    training) comes as None, i.e. zero."""

    class _SSDScan(torch.autograd.Function):

        @staticmethod
        def forward(ctx, x, dt, a, bmat, cmat, q, return_state):
            ctx.set_materialize_grads(False)
            y, h_last = fwd(x, dt, a, bmat, cmat, q, return_state)
            ctx.save_for_backward(x, dt, a, bmat, cmat)
            ctx.q = q
            return (y, h_last) if return_state else y

        @staticmethod
        def backward(ctx, dy, dh_last=None):
            x, dt, a, bmat, cmat = ctx.saved_tensors
            dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
            if dh_last is not None:
                dh_last = dh_last.contiguous()
            grads = bwd(x, dt, a, bmat, cmat, ctx.q, dy, dh_last)
            return (*(g.to(t.dtype) for g, t in zip(grads, (x, dt, a, bmat, cmat))),
                    None, None)

    return _SSDScan


def _rglru_fwd(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward kernel's launch: what :data:`RGLRUScan` runs."""
    return _rg.rglru_scan_fwd(log_a.float(), b.float())


def rglru_scan_bwd(log_a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU backward kernel's launch: (dlog_a, db) fp32 from log_a, the
    forward's h and dh, all [B,L,W] on the card.  What :data:`RGLRUScan`'s
    backward runs; callable alone to time it."""
    return _rg.rglru_scan_bwd(log_a.float().contiguous(), h, dh.float())


def _ssd_fwd(x, dt, a, bmat, cmat, q, return_state):
    """The forward kernel's launch: what :data:`SSDScan` runs."""
    return _ssd.ssd_scan_fwd(x, dt, a, bmat, cmat, q, return_state=return_state)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, q: int, dy: torch.Tensor,
                 dh_last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The SSD backward kernel's launch: (dx, ddt, da, dB, dC) at chunk q
    for the cotangents dy and dh_last (None: zero), on the card.  What
    :data:`SSDScan`'s backward runs; callable alone to time it."""
    return _ssd.ssd_scan_bwd(x, dt, a, bmat, cmat, q, dy,
                             None if dh_last is None else dh_last.float())


#: the scans on the card: kernel forward, kernel backward
RGLRUScan = rglru_function(_rglru_fwd, rglru_scan_bwd)
SSDScan = ssd_function(_ssd_fwd, ssd_scan_bwd)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, chunk: int = 256, return_state: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Mamba2 SSD. x:[Bt,L,H,P] dt:[Bt,L,H] a:[H] B,C:[Bt,L,N] → y.

    The reference's contract: q = min(chunk, L), ``ValueError`` unless L % q
    == 0.  With ``return_state`` it also returns the fp32 [Bt,H,P,N] state
    after the last chunk (the reference's kernel drops it; serving seeds
    decode with it).  Differentiable on both devices: on the card through
    :data:`SSDScan` (the backward kernel, which also takes the gradient of
    the final state), on the CPU through the plain version.
    """
    q = _ssd.check_chunk(x.shape[1], chunk)
    if x.device.type == "cpu":
        y, h_last = ref.ssd_chunked(x, dt, a, bmat, cmat, q)
        return (y, h_last) if return_state else y
    _check_device("ssd_scan", x)
    return SSDScan.apply(x, dt, a, bmat, cmat, q, bool(return_state))


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor, *, block_l: int = 256,
               block_w: int = 256) -> torch.Tensor:
    """RG-LRU recurrence over axis 1. log_a, b: [B,L,W] → h (fp32).

    ``block_l``/``block_w`` keep the reference's signature and its contract
    (L and W must tile by them, else ``ValueError``); the CUDA kernel picks
    its own tiles: a block per (batch, 32 lanes) walks L in tiles of 256
    steps, its threads splitting each tile into segments of 8 (8 lanes with
    the ``"scalar"`` variant).  Inputs are taken in fp32.  Differentiable on
    both devices: on the card through :data:`RGLRUScan` (the backward
    kernel), on the CPU through the plain version.
    """
    _rg.check_tiles(log_a.shape[1], log_a.shape[2], block_l, block_w)
    if log_a.device.type == "cpu":
        return ref.rglru_scan_ref(log_a, b)
    _check_device("rglru_scan", log_a)
    return RGLRUScan.apply(log_a, b)
