"""The dense GQA decoder (Llama's block layout, as Yi uses it), in plain fp32.

Parameters come in the port's tree, which the benchmark fills from the seed:
``embed`` [V, D]; ``blocks/s0`` stacked over the layers with ``ln1``,
``attn/{wq, wk, wv, wo}``, ``ln2``, ``mlp/{w_gate, w_up, w_down}``;
``final_norm``; ``lm_head`` [D, V].  Each block: ``x += wo(attn(rope(q),
rope(k), v))`` on ``rms_norm(x, ln1)``, causal softmax attention scaled by
``1/sqrt(hd)``, query head ``h`` reading kv head ``h // (H / Hkv)``; then
``x += w_down(silu(w_gate h) · w_up h)`` on ``rms_norm(x, ln2)``.  Logits
are ``rms_norm(x, final_norm) @ lm_head``.  No kernel, no cache, no batching
tricks: attention is a softmax over a dense score matrix, one prompt at a
time.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench.reference import common
from perfbench.reference.common import (F32, exact_fp32, mm, rms_norm, rope, run_steps, silu,
                                        token_loss_sum)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, precision: str) -> torch.Tensor:
    """Causal attention of one prompt: q [L, H, hd], k/v [L, Hkv, hd]."""
    l, h, hd = q.shape
    group = h // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).transpose(0, 1)          # [H, L, hd]
    vv = v.repeat_interleave(group, dim=1).transpose(0, 1)
    scores = mm(q.transpose(0, 1), kk.transpose(1, 2), precision) / math.sqrt(hd)
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return mm(probs, vv, precision).transpose(0, 1)                 # [L, H, hd]


def _block(p: Dict[str, Any], g: int, x: torch.Tensor, dims: Dict[str, Any], precision: str
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer on one prompt x [L, D]; returns (x, k, v) with k post-RoPE."""
    h, hkv = dims["num_attention_heads"], dims["num_key_value_heads"]
    hd = dims["hidden_size"] // h
    a, f = p["attn"], p["mlp"]
    eps, theta = dims["rms_norm_eps"], dims["rope_theta"]
    l = x.shape[0]
    y = rms_norm(x, p["ln1"][g], eps)
    q = rope(mm(y, a["wq"][g], precision).view(l, h, hd), theta)
    k = rope(mm(y, a["wk"][g], precision).view(l, hkv, hd), theta)
    v = mm(y, a["wv"][g], precision).view(l, hkv, hd)
    x = x + mm(_attend(q, k, v, precision).reshape(l, h * hd), a["wo"][g], precision)
    y = rms_norm(x, p["ln2"][g], eps)
    gate = silu(mm(y, f["w_gate"][g], precision))
    x = x + mm(gate * mm(y, f["w_up"][g], precision), f["w_down"][g], precision)
    return x, k, v


def _logits(params: Dict[str, Any], x: torch.Tensor, dims: Dict[str, Any], precision: str
            ) -> torch.Tensor:
    return mm(rms_norm(x, params["final_norm"], dims["rms_norm_eps"]), params["lm_head"],
              precision)


@torch.no_grad()
def prefill(params: Dict[str, Any], dims: Dict[str, Any], tokens: torch.Tensor,
            precision: str = "fp32") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B, L] → (the last position's logits [B, V], the cache a
    prefill leaves: ``k``, ``v`` [layers, B, L, Hkv, hd])."""
    blocks = params["blocks"]["s0"]
    logits, ks, vs = [], [], []
    with exact_fp32():
        for row in tokens:
            x = params["embed"][row.long()].to(F32)
            kr, vr = [], []
            for g in range(dims["num_layers"]):
                x, k, v = _block(blocks, g, x, dims, precision)
                kr.append(k)
                vr.append(v)
            logits.append(_logits(params, x[-1:], dims, precision)[0])
            ks.append(torch.stack(kr))
            vs.append(torch.stack(vr))
    return torch.stack(logits), {"k": torch.stack(ks, 1), "v": torch.stack(vs, 1)}


def _loss_of_row(params: Dict[str, Any], dims: Dict[str, Any], tokens: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor, precision: str) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(F32)
    for g in range(dims["num_layers"]):
        x = _block(params["blocks"]["s0"], g, x, dims, precision)[0]
    return token_loss_sum(_logits(params, x, dims, precision), labels, mask)


def train_steps(params: Dict[str, Any], dims: Dict[str, Any],
                batches: List[Dict[str, torch.Tensor]], opt_settings: Dict[str, float],
                precision: str = "fp32") -> Dict[str, Any]:
    """The first ``len(batches)`` training steps from ``params``
    (:func:`perfbench.reference.common.run_steps`)."""
    return run_steps(_loss_of_row, params, dims, batches, opt_settings, precision)


def train_step(params: Dict[str, Any], opt: Optional[Dict[str, Any]], step: int,
               dims: Dict[str, Any], batch: Dict[str, torch.Tensor],
               opt_settings: Dict[str, float], precision: str = "fp32"):
    """One training step (:func:`perfbench.reference.common.train_step`)."""
    return common.train_step(_loss_of_row, params, opt, step, dims, batch, opt_settings,
                             precision)
