"""The model's FLOPs, counted by the benchmark from a configuration file.

Two FLOPs per multiply-add of every product parameter per token it meets
(the embedding lookup does none; the head meets only the positions whose
logits are computed: the last one of each prompt in a prefill, every token
in training), plus causal attention's q·kᵀ and p·v over the kept pairs, or
the chunked SSD scan's products.  Training counts the forward three times
(forward and backward); activation checkpointing's recompute is not work
the model needs and is not counted.  Norms, activations, the depthwise
convolution and the optimizer are not products.
"""

from __future__ import annotations

from typing import Any, Dict


def causal_pairs(l: int) -> int:
    """Kept (query, key) pairs of one head of causal self-attention."""
    return l * (l + 1) // 2


def ssd_flops(bt: int, l: int, h: int, p: int, n: int, q: int) -> int:
    """Products of the chunked SSD scan's forward (C·Bᵀ over each chunk's
    causal pairs, shared by the heads; per head the masked scores times X,
    C·h_prevᵀ and the state update)."""
    nc, pairs = l // q, q * (q + 1) // 2
    return 2 * bt * nc * pairs * n + 2 * bt * nc * h * (pairs * p + 2 * q * p * n)


def _dense(c: Dict[str, Any], b: int, l: int) -> int:
    d, h, hkv, f = (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                    c["intermediate_size"])
    hd = c.get("head_dim") or d // h
    params = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f
    return 2 * params * b * l + 4 * b * h * hd * causal_pairs(l)


def _mamba2(c: Dict[str, Any], b: int, l: int) -> int:
    d, n, p, q = c["d_model"], c["d_state"], c["headdim"], c["chunk_size"]
    di = c["expand"] * d
    h = di // p
    params = 2 * d * di + 2 * d * n + d * h + di * d
    return 2 * params * b * l + ssd_flops(b, l, h, p, n, q)


BLOCKS = {"dense": _dense, "mamba2": _mamba2}


def _width(c: Dict[str, Any]) -> int:
    return c.get("hidden_size") or c["d_model"]


def forward_flops(c: Dict[str, Any], layers: int, b: int, l: int, logit_rows: int) -> int:
    """One forward of ``b`` rows of ``l`` tokens through ``layers`` blocks,
    the head on ``logit_rows`` positions."""
    return layers * BLOCKS[c["family"]](c, b, l) + 2 * _width(c) * c["vocab_size"] * logit_rows


def prefill_flops(c: Dict[str, Any], layers: int, b: int, l: int) -> int:
    return forward_flops(c, layers, b, l, b)


def train_flops(c: Dict[str, Any], layers: int, b: int, l: int) -> int:
    return 3 * forward_flops(c, layers, b, l, b * l)
