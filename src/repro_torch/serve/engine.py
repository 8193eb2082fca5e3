"""Prefill/decode serving engine (the port of :mod:`repro.serve.engine`)."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


def make_prefill_step(cfg: ModelConfig, *, max_len: int):
    def prefill_step(params, inputs: Dict[str, torch.Tensor]):
        return lm.prefill(params, cfg, inputs["tokens"], max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token: torch.Tensor, cache):
        return lm.decode_step(params, cfg, token, cache)
    return decode_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor, steps: int, *,
                    max_len: Optional[int] = None,
                    stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Greedy decoding: prompt [B, L] → generated tokens [B, steps].

    If ``stats`` is given it receives ``prefill_s`` and ``decode_s``, host
    clock around work that ends in a device synchronise.
    """
    b, l = prompt.shape
    max_len = max_len or (l + steps)
    if stats is not None:
        _sync(prompt.device)
    t0 = time.perf_counter()
    cache, logits = lm.prefill(params, cfg, prompt, max_len=max_len)
    toks = [torch.argmax(logits, dim=-1)[:, None]]
    if stats is not None:
        _sync(prompt.device)
        t1 = time.perf_counter()
    for _ in range(steps - 1):
        logits, cache = lm.decode_step(params, cfg, toks[-1], cache)
        toks.append(torch.argmax(logits, dim=-1)[:, None])
    out = torch.cat(toks, dim=1)
    if stats is not None:
        _sync(prompt.device)
        t2 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = t2 - t1
    return out
