"""Public wrappers for the port's kernels.

A wrapper picks its path by the device of the tensors it is given: on the
CPU it runs the plain version in :mod:`repro_torch.kernels.ref`; on the card
it launches the hand-written kernel or raises.  There is no switch that sends
a CUDA tensor to the plain version.

Each wrapper counts its kernel launches in :data:`launches` so that a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd

#: kernel name → launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"flash_attention": 0, "ssd_scan": 0, "rglru_scan": 0}
#: flash-attention variant (:func:`flash_attention.variant`) → its share of
#: ``launches["flash_attention"]``
flash_variant_launches: Dict[str, int] = dict.fromkeys(_fa.VARIANTS, 0)
#: SSD-scan variant (:func:`ssd_scan.variant`) → its share of
#: ``launches["ssd_scan"]``
ssd_variant_launches: Dict[str, int] = dict.fromkeys(_ssd.VARIANTS, 0)
#: RG-LRU-scan variant (:func:`rglru_scan.variant`) → its share of
#: ``launches["rglru_scan"]``
rglru_variant_launches: Dict[str, int] = dict.fromkeys(_rg.VARIANTS, 0)
_BY_VARIANT = {"flash_attention": flash_variant_launches, "ssd_scan": ssd_variant_launches,
               "rglru_scan": rglru_variant_launches}
_count_lock = threading.Lock()      # decode replicas launch from worker threads


def reset_launches() -> None:
    with _count_lock:
        for counts in (launches, *_BY_VARIANT.values()):
            for name in counts:
                counts[name] = 0


def _counted(name: str, variant: str = "") -> None:
    with _count_lock:
        launches[name] += 1
        if variant:
            _BY_VARIANT[name][variant] += 1


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
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
    backward is the reference's FA2.
    """
    _fa.check_tiles(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        plain = ref.flash_attention_plain_lse if return_lse else ref.flash_attention_plain
        return plain(q, k, v, causal=causal, window=window, softcap=softcap)
    _check_device("flash_attention", q)
    refuse_grad("flash_attention", q, k, v,
                instead="differentiate through repro_torch.models.flash.flash_attention")
    out = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  softcap=softcap, return_lse=return_lse)
    _counted("flash_attention", _fa.variant(q.shape[3], q.dtype))
    return out


_SCAN_BACKWARD = ("it has no backward yet (ROADMAP Queue 1 item 5: recurrent training on "
                  "the card); train recurrent archs on the CPU, or call it under "
                  "torch.no_grad()")


def refuse_grad(name: str, *inputs: torch.Tensor, instead: str = _SCAN_BACKWARD) -> None:
    """Raise ``NotImplementedError`` where a kernel would be handed an input
    that needs a gradient outside an ``autograd.Function``: its ``ctypes``
    launch returns a tensor with no autograd history, and the gradient would
    be lost without a word.  ``instead`` says what to do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(f"{name} on the card returns no autograd history: {instead}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, chunk: int = 256, return_state: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Mamba2 SSD. x:[Bt,L,H,P] dt:[Bt,L,H] a:[H] B,C:[Bt,L,N] → y.

    The reference's contract: q = min(chunk, L), ``ValueError`` unless L % q
    == 0.  With ``return_state`` it also returns the fp32 [Bt,H,P,N] state
    after the last chunk (the reference's kernel drops it; serving seeds
    decode with it).
    """
    q = _ssd.check_chunk(x.shape[1], chunk)
    if x.device.type == "cpu":
        y, h_last = ref.ssd_chunked(x, dt, a, bmat, cmat, q)
        return (y, h_last) if return_state else y
    _check_device("ssd_scan", x)
    refuse_grad("ssd_scan", x, dt, a, bmat, cmat)
    y, h_last = _ssd.ssd_scan_fwd(x, dt, a, bmat, cmat, q, return_state=return_state)
    _counted("ssd_scan", _ssd.variant(x.shape[3], bmat.shape[-1], q, x.dtype))
    return (y, h_last) if return_state else y


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor, *, block_l: int = 256,
               block_w: int = 256) -> torch.Tensor:
    """RG-LRU recurrence over axis 1. log_a, b: [B,L,W] → h (fp32).

    ``block_l``/``block_w`` keep the reference's signature and its contract
    (L and W must tile by them, else ``ValueError``); the CUDA kernel picks
    its own tiles: a block per (batch, 32 lanes) walks L in tiles of 256
    steps, its threads splitting each tile into segments of 8 (8 lanes with
    the ``"scalar"`` variant).  Inputs are taken in fp32.
    """
    _rg.check_tiles(log_a.shape[1], log_a.shape[2], block_l, block_w)
    if log_a.device.type == "cpu":
        return ref.rglru_scan_ref(log_a, b)
    _check_device("rglru_scan", log_a)
    refuse_grad("rglru_scan", log_a, b)
    h = _rg.rglru_scan_fwd(log_a.float(), b.float())
    _counted("rglru_scan", _rg.variant(log_a.shape[2]))
    return h
