"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of :mod:`repro.models.rglru`.

Recurrent block:  x → [branch1: linear → causal conv → RG-LRU] ⊙
                      [branch2: linear → GeLU]  → out linear.

RG-LRU:  r_t = σ(W_r ξ_t),  i_t = σ(W_i ξ_t),
         a_t = exp(-c · softplus(Λ) · r_t)            (c = 8)
         h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ ξ_t)

Prefill runs the recurrence through :func:`repro_torch.kernels.ops.rglru_scan`
— the hand-written CUDA kernel on the card, the log-depth plain version on
the CPU.  Decode carries an O(1) [B,W] state in plain PyTorch.

On local blocks (the sharded train step, and sharded serving's prefill
and decode) the block is tensor-parallel over the lru width W: the input
enters through ``tp_input``; ``w_x`` and ``w_gate`` are column-parallel
(the rank's W block), the causal conv and Λ are the rank's channels, and
the scan runs on ``[B/batch, L, W/model]``.  The gate products
``w_r``/``w_i`` are (None, model) by the rule table: they contract the
whole width, so ξ is gathered over the model axis (backward: a
reduce-scatter) before their fp32 products; gathering ξ in the compute
dtype and then casting is the same as casting first.  ``w_out`` is
row-parallel and its partial sum leaves through ``tp_output``.  The decode
state, ``h`` [B, W] and the conv tail [B, K-1, W], is the rank's W block,
as ``cache_shardings`` places it.  Where the model axis does not divide W,
the rule table's guard leaves every leaf of the block whole and every
model rank computes the whole block (ξ needs no gather), its state whole
too.  Off local blocks these are identities.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.common import ModelConfig, dense_init, softplus
from repro_torch.parallel.mesh_ctx import blocks_ctx, gather, tp_input, tp_output
from repro_torch.parallel.sharding import model_split, use_param

C_FACTOR = 8.0
SCAN_BLOCK = 256          # prefill pads L > SCAN_BLOCK up to a multiple of it


def width(cfg: ModelConfig) -> int:
    if cfg.rglru is None:
        raise ValueError(f"{cfg.name} has no RG-LRU config")
    return cfg.rglru.lru_width or cfg.d_model


def init(gen: torch.Generator, cfg: ModelConfig, *, device,
         lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    g = cfg.rglru
    w = width(cfg)
    pd, d = cfg.pdtype, cfg.d_model
    lead = tuple(lead)

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, pd, device=device, lead=lead)

    conv_w = torch.randn(lead + (g.conv_kernel, w), generator=gen, dtype=torch.float32,
                         device=device).mul_(0.1).to(pd)
    # Λ init so that a^c ∈ ~(0.9, 0.999) at r=1 (the paper's init range)
    lam = torch.linspace(2.0, 6.0, w, device=device).to(pd).expand(lead + (w,)).clone()
    return {
        "w_x": dense(d, w),
        "w_gate": dense(d, w),
        "conv_w": conv_w,
        "conv_b": torch.zeros(lead + (w,), dtype=pd, device=device),
        "w_r": dense(w, w),
        "w_i": dense(w, w),
        "lam": lam,
        "w_out": dense(w, d),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form, op by op in x's dtype with
    its constants in x's dtype (``F.gelu`` defaults to the exact erf form,
    and its tanh form rounds once and keeps 0.044715 in fp32)."""
    def k(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(k(math.sqrt(2 / math.pi)) * (x + k(0.044715) * (x ** 3))))
    return x * cdf


def _split(cfg: ModelConfig) -> bool:
    """Whether the rule table splits the lru width over the model axis on
    local blocks (``w_x`` and the rest of the block alike)."""
    return model_split(("rec", "w_x"), (cfg.d_model, width(cfg)))


def _param(params, name: str, shape, split: bool) -> torch.Tensor:
    """The value of ``params[name]`` this rank's computation uses (the
    rule table's spec of ``rec/<name>``) in a block that is ``split`` over
    the model axis or whole (:func:`_split`): whole off local blocks."""
    return use_param(params[name], ("rec", name), shape, model_partial=split)


def _gates(params, cfg: ModelConfig, xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_a [.., W] ≤ 0, gated input multiplier).

    The w_r / w_i products run in fp32, as in the reference, whatever the
    compute dtype.  On local blocks ``xi`` is the rank's W block: the
    products take it gathered over the model axis and give the rank's
    columns.
    """
    f32 = torch.float32
    w, split = width(cfg), _split(cfg)
    ctx = blocks_ctx()
    xw = xi if ctx is None or not split else gather(xi, -1, ctx.model_axis, ctx)
    r = torch.sigmoid(xw.to(f32) @ _param(params, "w_r", (w, w), split).to(f32))
    i = torch.sigmoid(xw.to(f32) @ _param(params, "w_i", (w, w), split).to(f32))
    log_a = -C_FACTOR * softplus(_param(params, "lam", (w,), split).to(f32)) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i * xi.to(f32)


def scan_ref(log_a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """Linear recurrence h_t = exp(log_a_t)·h_{t-1} + b_t over axis 1 (fp32)."""
    return ref.rglru_scan_ref(log_a, b, h0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv; taps summed from 0 in tap order, as the
    reference's Python ``sum``, so bf16 rounds at the same points."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b


def _scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The prefill recurrence through the kernel wrapper.

    A length above :data:`SCAN_BLOCK` that it does not divide is padded at
    the end and the padding sliced off: trailing rows cannot change earlier
    ones.
    """
    l = log_a.shape[1]
    pad = (-l) % SCAN_BLOCK if l > SCAN_BLOCK else 0
    if pad:
        log_a, b = (F.pad(t, (0, 0, 0, pad)) for t in (log_a, b))
    h = ops.rglru_scan(log_a, b, block_l=SCAN_BLOCK, block_w=SCAN_BLOCK)
    return h[:, :l] if pad else h


def apply(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B,L,D] → [B,L,D] (prefill)."""
    y, _ = _apply_impl(params, cfg, x, collect_state=False)
    return y


def apply_with_state(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill variant: also returns the decode state (h_last + conv tail)."""
    return _apply_impl(params, cfg, x, collect_state=True)


def _apply_impl(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                collect_state: bool):
    ct = cfg.cdtype
    d, w, k = cfg.d_model, width(cfg), cfg.rglru.conv_kernel
    split = _split(cfg)
    x = tp_input(x, split)
    xi_raw = x @ _param(params, "w_x", (d, w), split).to(ct)
    xi = _causal_conv(xi_raw, _param(params, "conv_w", (k, w), split).to(ct),
                      _param(params, "conv_b", (w,), split).to(ct))
    log_a, b = _gates(params, cfg, xi)
    h = _scan(log_a, b)
    gate = gelu(x @ _param(params, "w_gate", (d, w), split).to(ct))
    out = tp_output((h.to(ct) * gate) @ _param(params, "w_out", (w, d), split).to(ct), split)
    if not collect_state:
        return out, None
    km1 = cfg.rglru.conv_kernel - 1
    tail = xi_raw[:, -km1:, :]
    tail = F.pad(tail, (0, 0, km1 - tail.shape[1], 0))
    # the state owns its memory: decode writes into it in place
    return out, {"h": h[:, -1].clone(), "conv": tail.to(ct).clone()}


# ==========================================================================
# Decode
# ==========================================================================


def init_state(cfg: ModelConfig, batch: int, *, device,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    w = width(cfg)
    lead = tuple(lead)
    return {
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.rglru.conv_kernel - 1, w),
                            dtype=cfg.cdtype, device=device),
    }


def decode_step(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,1,D] → ([B,1,D], new state).  The state passed in is not
    modified; the returned tensors are new.  On local blocks ``state`` is
    this rank's W block (the module's docstring)."""
    ct = cfg.cdtype
    d, w, k = cfg.d_model, width(cfg), cfg.rglru.conv_kernel
    split = _split(cfg)
    x0 = tp_input(x, split)[:, 0, :]
    xi = x0 @ _param(params, "w_x", (d, w), split).to(ct)          # [B,W]
    hist = torch.cat([state["conv"], xi[:, None, :]], dim=1)
    xi = torch.einsum("bkc,kc->bc", hist, _param(params, "conv_w", (k, w), split).to(ct)) \
        + _param(params, "conv_b", (w,), split).to(ct)
    log_a, b = _gates(params, cfg, xi)
    h = torch.exp(log_a) * state["h"] + b
    gate = gelu(x0 @ _param(params, "w_gate", (d, w), split).to(ct))
    out = tp_output(((h.to(ct) * gate) @ _param(params, "w_out", (w, d), split).to(ct)
                     )[:, None, :], split)
    return out, {"h": h, "conv": hist[:, 1:, :]}
