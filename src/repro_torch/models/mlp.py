"""Gated-SiLU MLP (llama/gemma/mistral-family FFN)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import ModelConfig, dense_init


def init(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0, *, device,
         lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    d_ff = d_ff or cfg.d_ff
    pd = cfg.pdtype
    return {
        "w_gate": dense_init(gen, cfg.d_model, d_ff, pd, device=device, lead=lead),
        "w_up": dense_init(gen, cfg.d_model, d_ff, pd, device=device, lead=lead),
        "w_down": dense_init(gen, d_ff, cfg.d_model, pd, device=device, lead=lead),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op by op: x · 1/(1 + exp(−x)), each op rounding in
    x's dtype, so bf16 rounds where the JAX package rounds (``F.silu``
    rounds once and differs by an ulp on many bf16 inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def apply(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    ct = cfg.cdtype
    g = silu(x @ params["w_gate"].to(ct))
    u = x @ params["w_up"].to(ct)
    return (g * u) @ params["w_down"].to(ct)
