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
from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref

#: kernel name → launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"flash_attention": 0}
_count_lock = threading.Lock()      # decode replicas launch from worker threads


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _counted(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Flash-attention forward. q: [B,L,H,hd]; k,v: [B,S,Hkv,hd].

    ``block_q``/``block_k`` keep the reference's signature and its contract
    (L and S must tile by them, else ``ValueError``); the CUDA kernel picks
    its own tile shape inside that contract.
    """
    _fa.check_tiles(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    out = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    _counted("flash_attention")
    return out
