"""Mamba2 block — SSD (state-space duality) with the chunked algorithm.

The port of :mod:`repro.models.ssm` (single group, scalar-per-head A):
  projections → [z | x | B | C | dt], causal depthwise conv over (x,B,C),
  SSD recurrence  h_t = exp(dt_t·A) h_{t-1} + dt_t · (B_t ⊗ x_t),
  y_t = C_t · h_t + D ⊙ x_t,  out = out_proj(y ⊙ silu(z)).

The projections stay separate matrices with per-stream convs, as in the
reference's parameter tree.  Prefill runs the chunked scan through
:func:`repro_torch.kernels.ops.ssd_scan` — the hand-written CUDA kernel on the
card, its plain version (:func:`repro_torch.kernels.ref.ssd_chunked`) on the
CPU — which also returns the final state that seeds decode.  Decode is plain
PyTorch: the reference has no decode kernel.

On local blocks (the sharded train step, and sharded serving's prefill
and decode) the block is tensor-parallel over the heads: the input enters
through ``tp_input``; ``wz``, ``wx`` and ``wdt`` are column-parallel (the
rank's heads), ``conv_x_*`` the rank's channels, and ``A_log``, ``D`` and
``dt_bias``, which the rule table replicates, are cut to the rank's heads
by ``use_param_block``.  ``wb``, ``wc`` and ``conv_b_*``/``conv_c_*`` are
whole over the model axis, and B and C feed only the rank's heads, so
their gradients are partial sums, summed over the model axis by
``use_param(..., model_partial=True)``.  The scan runs on ``[B/batch, L,
H/model, P]``; ``w_out`` is row-parallel and its partial sum leaves
through ``tp_output``.  Where the model axis divides the inner width but
not the heads, the rank's channels are gathered over it after the conv,
the scan runs on every head (``A_log``, ``D``, ``dt_bias`` and ``wdt``
read whole, their gradients the rank's partials, summed over the model
axis), and its output is cut back to the rank's channels before the gate
and ``w_out``.  Where it divides neither, the rule table's guard leaves
the block's leaves whole and every model rank computes the whole block.
The reference's layout hints (``_constrain``,
``_batch_model``) move nothing there: the column-parallel outputs are
already (batch, ·, model), and ``tp_input`` has gathered the sequence
under ``seq_shard_activations``; they are not called.  The decode state
lies as ``cache_shardings`` places it: ``h`` the rank's heads,
``conv_x`` its channels, and ``conv_b``/``conv_c`` its block of the N
channels where the model axis divides N (every rank computes B and C
whole, so the prefill cuts their tails, and a decode step convolves the
rank's channels and joins the N channels' outputs over the model axis,
one all-reduce for both).  Off local blocks the parameter reads and the
tensor-parallel entry and exit are identities.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, dense_init, softplus
from repro_torch.models.mlp import silu
from repro_torch.parallel.mesh_ctx import blocks_ctx, gather, tp_input, tp_output
from repro_torch.parallel.sharding import model_split, use_param, use_param_block


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    if s is None:
        raise ValueError(f"{cfg.name} has no SSM config")
    return s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.head_dim, s.d_state


def init(gen: torch.Generator, cfg: ModelConfig, *, device,
         lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    s = cfg.ssm
    di, nh, _, n = dims(cfg)
    pd, d = cfg.pdtype, cfg.d_model
    lead = tuple(lead)

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, pd, device=device, lead=lead)

    def conv(ch):
        w = torch.randn(lead + (s.d_conv, ch), generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(0.1).to(pd)

    def vec(values: torch.Tensor) -> torch.Tensor:
        return values.to(device=device, dtype=pd).expand(lead + values.shape).clone()

    def zeros(ch):
        return torch.zeros(lead + (ch,), dtype=pd, device=device)

    return {
        "wz": dense(d, di), "wx": dense(d, di), "wb": dense(d, n), "wc": dense(d, n),
        "wdt": dense(d, nh),
        "conv_x_w": conv(di), "conv_x_b": zeros(di),
        "conv_b_w": conv(n), "conv_b_b": zeros(n),
        "conv_c_w": conv(n), "conv_c_b": zeros(n),
        "A_log": vec(torch.log(torch.linspace(1.0, 16.0, nh))),      # A = -exp
        "D": vec(torch.ones(nh)),
        "dt_bias": vec(torch.full((nh,), math.log(math.expm1(0.01)))),
        "w_out": dense(di, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: [B,L,C], w: [K,C].

    The taps are summed from 0 in tap order, as the reference's Python
    ``sum`` does, so bf16 rounds at the same points.
    """
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


# ==========================================================================
# Block forward (prefill)
# ==========================================================================


def apply(params: Dict[str, Any], cfg: ModelConfig, xin: torch.Tensor) -> torch.Tensor:
    y, _ = _apply_impl(params, cfg, xin, collect_state=False)
    return y


def apply_with_state(params: Dict[str, Any], cfg: ModelConfig, xin: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill variant: also returns the decode state (h_last + conv tails)."""
    return _apply_impl(params, cfg, xin, collect_state=True)


def _splits(cfg: ModelConfig) -> Tuple[bool, bool]:
    """(inner, heads): whether the rule table splits the inner width
    (``wx``) and the heads (``wdt``) over the model axis on local blocks.
    The heads split only where the inner width does."""
    d, (di, nh, _, _) = cfg.d_model, dims(cfg)
    return model_split("wx", (d, di)), model_split("wdt", (d, nh))


def _readers(params: Dict[str, Any], cfg: ModelConfig):
    """(w, heads): a parameter as this rank's computation uses it, in the
    compute dtype, and a per-head vector cut to the rank's heads (every
    head where the heads are whole); whole off local blocks.  A leaf the
    rule table leaves whole has the rank's partial gradient in a block the
    model axis splits (it meets only the rank's channels), its whole
    gradient in a whole block."""
    nh = dims(cfg)[1]
    inner, split_heads = _splits(cfg)

    def w(name, shape):
        return use_param(params[name], name, shape, model_partial=inner).to(cfg.cdtype)

    def heads(name):
        if split_heads:
            return use_param_block(params[name], name, (nh,), 0)
        return use_param(params[name], name, (nh,), model_partial=inner)

    return w, heads


def _all_heads(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x [..., di/model] → [..., di]: the rank's channels joined over the
    model axis where it splits the inner width and not the heads (the scan
    needs whole heads); else ``x``."""
    inner, split_heads = _splits(cfg)
    ctx = blocks_ctx()
    if ctx is None or not inner or split_heads:
        return x
    return gather(x, -1, ctx.model_axis, ctx)


def _my_channels(y: torch.Tensor, x_loc: torch.Tensor) -> torch.Tensor:
    """The rank's channels of y [..., di] where ``x_loc`` [..., di/model]
    holds fewer than all (:func:`_all_heads` joined them); else ``y``."""
    c = x_loc.shape[-1]
    if y.shape[-1] == c:
        return y
    ctx = blocks_ctx()
    return y.narrow(-1, ctx.coord(ctx.model_axis) * c, c)


def _channels(n: int) -> slice:
    """The N channels of B and C that this rank's decode state holds: its
    block over the model axis where the model axis divides N (the rule of
    ``cache_shardings``), else all of them."""
    ctx = blocks_ctx()
    if ctx is None or n % ctx.model_size:
        return slice(0, n)
    nl = n // ctx.model_size
    return slice(ctx.coord(ctx.model_axis) * nl, (ctx.coord(ctx.model_axis) + 1) * nl)


def _apply_impl(params: Dict[str, Any], cfg: ModelConfig, xin: torch.Tensor,
                collect_state: bool):
    s = cfg.ssm
    di, nh, p, n = dims(cfg)
    ct = cfg.cdtype
    d, k = cfg.d_model, s.d_conv
    w, heads = _readers(params, cfg)
    inner = _splits(cfg)[0]
    xin = tp_input(xin, inner)
    bt, l, _ = xin.shape
    z = xin @ w("wz", (d, di))                                     # [B,L,di]
    x_raw = xin @ w("wx", (d, di))                                 # [B,L,di]
    b_raw = xin @ w("wb", (d, n))                                  # [B,L,N]
    c_raw = xin @ w("wc", (d, n))
    dt_raw = xin @ w("wdt", (d, nh))                               # [B,L,H]

    x_loc = silu(_causal_conv(x_raw, w("conv_x_w", (k, di)), w("conv_x_b", (di,))))
    x = _all_heads(x_loc, cfg)
    b = silu(_causal_conv(b_raw, w("conv_b_w", (k, n)), w("conv_b_b", (n,))))
    c = silu(_causal_conv(c_raw, w("conv_c_w", (k, n)), w("conv_c_b", (n,))))
    dt = softplus(dt_raw.float() + heads("dt_bias").float())       # [B,L,H]
    A = -torch.exp(heads("A_log").float())
    hl = dt.shape[-1]                                              # this rank's heads
    xh = x.reshape(bt, l, hl, p)
    # pad to a chunk multiple; dt=0 on padding ⇒ identity state updates, so
    # the padded scan's final state is the true h_last
    q = min(s.chunk, l)
    pad = (-l) % q
    if pad:
        y, h_last = ops.ssd_scan(F.pad(xh, (0, 0, 0, 0, 0, pad)).to(ct),
                                 F.pad(dt, (0, 0, 0, pad)), A,
                                 F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad)),
                                 chunk=q, return_state=True)
        y = y[:, :l]
    else:
        y, h_last = ops.ssd_scan(xh.to(ct), dt, A, b, c, chunk=q, return_state=True)
    y = y + xh * heads("D").to(ct)[None, None, :, None]
    y = _my_channels(y.reshape(bt, l, hl * p), x_loc) * silu(z)
    out = tp_output(y @ w("w_out", (di, d)), inner)
    if not collect_state:
        return out, None

    def tail(a):        # owns its memory: decode writes into it in place
        t = a[:, -(s.d_conv - 1):, :]
        return F.pad(t, (0, 0, s.d_conv - 1 - t.shape[1], 0)).clone()

    ch = _channels(n)
    return out, {"h": h_last,
                 "conv_x": tail(x_raw).to(ct),
                 "conv_b": tail(b_raw[..., ch]).to(ct),
                 "conv_c": tail(c_raw[..., ch]).to(ct)}


# ==========================================================================
# Decode (O(1) state per token)
# ==========================================================================


def init_state(cfg: ModelConfig, batch: int, *, device,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    di, nh, p, n = dims(cfg)
    lead = tuple(lead)

    def zeros(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return {
        "h": zeros((batch, nh, p, n), torch.float32),
        "conv_x": zeros((batch, s.d_conv - 1, di), cfg.cdtype),
        "conv_b": zeros((batch, s.d_conv - 1, n), cfg.cdtype),
        "conv_c": zeros((batch, s.d_conv - 1, n), cfg.cdtype),
    }


def _conv_step(hist: torch.Tensor, new: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal-conv step. hist: [B,K-1,C], new: [B,C] → (out [B,C], hist)."""
    h = torch.cat([hist, new[:, None, :]], dim=1)
    out = torch.einsum("bkc,kc->bc", h, w) + b
    return out, h[:, 1:, :]


def decode_step(params: Dict[str, Any], cfg: ModelConfig, xin: torch.Tensor,
                state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """xin: [B,1,D] → ([B,1,D], new state).  The state passed in is not
    modified; the returned tensors are new.  On local blocks ``state`` is
    this rank's block of the cache's (the module's docstring)."""
    s = cfg.ssm
    di, nh, p, n = dims(cfg)
    ct = cfg.cdtype
    f32 = torch.float32
    d, k = cfg.d_model, s.d_conv
    w, heads = _readers(params, cfg)
    inner = _splits(cfg)[0]
    x0 = tp_input(xin, inner)[:, 0, :]
    bt = x0.shape[0]
    z = x0 @ w("wz", (d, di))
    x_raw = x0 @ w("wx", (d, di))
    b_raw = x0 @ w("wb", (d, n))
    c_raw = x0 @ w("wc", (d, n))
    dt_raw = x0 @ w("wdt", (d, nh))

    x, cx = _conv_step(state["conv_x"], x_raw, w("conv_x_w", (k, di)), w("conv_x_b", (di,)))
    ch = _channels(n)
    b, cb = _conv_step(state["conv_b"], b_raw[:, ch], w("conv_b_w", (k, n))[:, ch],
                       w("conv_b_b", (n,))[ch])
    c, cc = _conv_step(state["conv_c"], c_raw[:, ch], w("conv_c_w", (k, n))[:, ch],
                       w("conv_c_b", (n,))[ch])
    if ch.stop - ch.start < n:                 # the rank's channels: join all N
        ctx = blocks_ctx()
        b, c = gather(torch.stack([b, c]), -1, ctx.model_axis, ctx)
    x_loc, b, c = silu(x), silu(b), silu(c)
    x = _all_heads(x_loc, cfg)

    dt = softplus(dt_raw.float() + heads("dt_bias").float())      # [B,H]
    A = -torch.exp(heads("A_log").float())
    hl = dt.shape[-1]                                              # this rank's heads
    xh = x.reshape(bt, hl, p).to(f32)
    dA = torch.exp(dt * A)                                         # [B,H]
    h = state["h"] * dA[:, :, None, None] \
        + torch.einsum("bh,bn,bhp->bhpn", dt, b.to(f32), xh)
    y = torch.einsum("bn,bhpn->bhp", c.to(f32), h)
    y = y + xh * heads("D").to(f32)[None, :, None]
    y = _my_channels(y.reshape(bt, hl * p).to(ct), x_loc) * silu(z)
    out = tp_output((y @ w("w_out", (di, d)))[:, None, :], inner)
    return out, {"h": h, "conv_x": cx, "conv_b": cb, "conv_c": cc}
