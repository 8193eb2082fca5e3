"""Gated-SiLU MLP (llama/gemma/mistral-family FFN).

Under local blocks (the sharded train step) it is Megatron's tensor-parallel
MLP: ``w_gate``/``w_up`` column-parallel and ``w_down`` row-parallel over
the model axis, as the rule table splits them, the input entering through
:func:`~repro_torch.parallel.mesh_ctx.tp_input` and the rank's partial sum
leaving through :func:`~repro_torch.parallel.mesh_ctx.tp_output`.  Where
the model axis does not divide ``d_ff``, the rule table's guard leaves the
three weights whole over it and every model rank computes the whole MLP.
Otherwise these are identities and the MLP is the plain one.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.parallel.mesh_ctx import tp_input, tp_output
from repro_torch.parallel.sharding import model_split, use_param


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


def apply(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
          d_ff: int = 0) -> torch.Tensor:
    """The MLP of width ``d_ff`` (default ``cfg.d_ff``; the MoE shared
    experts' is wider, as :func:`init` was given it)."""
    ct = cfg.cdtype
    d, f = cfg.d_model, d_ff or cfg.d_ff
    split = model_split("w_gate", (d, f))

    def w(name, shape):
        return use_param(params[name], name, shape, model_partial=split).to(ct)

    x = tp_input(x, split)
    g = silu(x @ w("w_gate", (d, f)))
    u = x @ w("w_up", (d, f))
    return tp_output((g * u) @ w("w_down", (f, d)), split)
