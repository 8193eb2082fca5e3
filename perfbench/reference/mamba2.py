"""The Mamba2 (SSD) language model, in plain fp32.

Parameters come in the port's tree, which the benchmark fills from the seed:
``embed`` [V, D] (tied: the head is its transpose); ``blocks/s0`` stacked over
the layers with ``ln1`` and ``ssm/{wz, wx, wb, wc, wdt, conv_{x,b,c}_{w,b},
A_log, D, dt_bias, w_out}``; ``final_norm``.  Each block, on ``u =
rms_norm(x, ln1)``: ``z, x_raw, B_raw, C_raw, dt_raw`` are products of ``u``;
``x, B, C`` are SiLU of a depthwise causal convolution (4 taps, bias) of
their raw streams; ``dt = softplus(dt_raw + dt_bias)``, ``A = −exp(A_log)``;
the state ``h_t = exp(dt_t A) h_{t−1} + dt_t B_t ⊗ x_t`` (one group, a
scalar A a head) gives ``y_t = C_t · h_t + D x_t``; ``x += w_out(y ·
silu(z))``.  This is the model as the JAX package defines it (and as the
port holds it), which departs from the published block: separate
projections in place of one ``in_proj``, and no gated RMSNorm before
``out_proj``.

The scan is the chunked SSD algorithm written from the paper (arXiv
2405.21060, its minimal listing): within a chunk the masked decays
``exp(segsum(dt A))`` times ``C Bᵀ``; across chunks the states passed on by
their decays.  The cache a prefill leaves is the last state ``h`` [B, H, P,
N] and the last three positions of each raw stream before the convolution.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import common
from perfbench.reference.common import (F32, exact_fp32, mm, rms_norm, run_steps, silu,
                                        softplus, token_loss_sum)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] → [..., T, T]: Σ x[j+1..i] for j ≤ i, −inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [L, H, P], dt [L, H], a [H], b/c [L, N] → (y [L, H, P], last state [H, P, N])."""
    l, h, p = x.shape
    nc = l // chunk
    xs = (x * dt[..., None]).view(nc, chunk, h, p)
    adt = (a * dt).view(nc, chunk, h).permute(2, 0, 1)               # [H, C, Q]
    bs, cs = b.view(nc, chunk, -1), c.view(nc, chunk, -1)
    cum = torch.cumsum(adt, dim=-1)
    scores = torch.einsum("cln,csn->cls", cs, bs)                      # [C, Q, Q]
    m = scores[None] * torch.exp(segsum(adt))                          # [H, C, Q, Q]
    y_in = torch.einsum("hcls,cshp->clhp", m, xs)
    decay = torch.exp(cum[..., -1:] - cum)                            # [H, C, Q]
    states = torch.einsum("cln,hcl,clhp->chpn", bs, decay, xs)
    states = torch.cat([torch.zeros_like(states[:1]), states])        # [C+1, H, P, N]
    carry = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))           # [H, C+1, C+1]
    states = torch.einsum("hzc,chpn->zhpn", carry, states)
    y_out = torch.einsum("cln,chpn,hcl->clhp", cs, states[:-1], torch.exp(cum))
    return (y_in + y_out).reshape(l, h, p), states[-1]


def _conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of x [L, C] by taps w [K, C]."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[i:i + x.shape[0]] * w[i] for i in range(k)) + bias


def _block(p: Dict[str, Any], g: int, x: torch.Tensor, dims: Dict[str, Any], precision: str
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer on one prompt x [L, D]; returns (x, its decode state)."""
    s = {k: v[g].to(F32) for k, v in p["ssm"].items()}
    hd, k = dims["headdim"], dims["d_conv"]
    u = rms_norm(x, p["ln1"][g], dims["rms_norm_eps"])
    z = mm(u, s["wz"], precision)
    x_raw, b_raw, c_raw = (mm(u, s[w], precision) for w in ("wx", "wb", "wc"))
    dt = softplus(mm(u, s["wdt"], precision) + s["dt_bias"])
    xs = silu(_conv(x_raw, s["conv_x_w"], s["conv_x_b"]))
    b = silu(_conv(b_raw, s["conv_b_w"], s["conv_b_b"]))
    c = silu(_conv(c_raw, s["conv_c_w"], s["conv_c_b"]))
    l = x.shape[0]
    xh = xs.view(l, -1, hd)
    y, h_last = ssd(xh, dt, -torch.exp(s["A_log"]), b, c, min(dims["chunk_size"], l))
    y = (y + xh * s["D"][:, None]).reshape(l, -1) * silu(z)
    state = {"h": h_last, "conv_x": x_raw[-(k - 1):], "conv_b": b_raw[-(k - 1):],
             "conv_c": c_raw[-(k - 1):]}
    return x + mm(y, s["w_out"], precision), state


def _logits(params: Dict[str, Any], x: torch.Tensor, dims: Dict[str, Any], precision: str
            ) -> torch.Tensor:
    return mm(rms_norm(x, params["final_norm"], dims["rms_norm_eps"]), params["embed"].T,
              precision)


@torch.no_grad()
def prefill(params: Dict[str, Any], dims: Dict[str, Any], tokens: torch.Tensor,
            precision: str = "fp32") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B, L] → (the last position's logits [B, V], the cache a
    prefill leaves: ``h`` [layers, B, H, P, N] and the raw streams' last
    three positions ``conv_x``, ``conv_b``, ``conv_c`` [layers, B, 3, ·])."""
    logits, rows = [], []
    with exact_fp32():
        for row in tokens:
            x = params["embed"][row.long()].to(F32)
            states = []
            for g in range(dims["num_layers"]):
                x, st = _block(params["blocks"]["s0"], g, x, dims, precision)
                states.append(st)
            logits.append(_logits(params, x[-1:], dims, precision)[0])
            rows.append({k: torch.stack([st[k] for st in states]) for k in states[0]})
    cache = {k: torch.stack([r[k] for r in rows], 1) for k in rows[0]}
    return torch.stack(logits), cache


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
