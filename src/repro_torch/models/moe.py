"""Mixture-of-Experts layer (DeepSeek-MoE fine-grained + DBRX-style).

The port of :mod:`repro.models.moe`, same design:
  * Router: fp32 logits → top-k expert ids + renormalised weights.
  * Dispatch: sort-based with static capacity.  Assignments are sorted by
    expert id and scattered into an ``[E, C, D]`` buffer; an assignment past
    an expert's capacity is dropped.  Every shape is static, and nothing on
    the path reads a value back to the host (no ``.item()``, ``.nonzero()``
    or boolean-mask indexing), so the host never waits on the card.
  * Experts: one batched product per projection, ``[E,C,D]×[E,D,F]``.
  * Combine: gather back per assignment, weighted sum over k.
  * Shared experts (DeepSeek): a dense gated MLP applied to every token.
  * Expert parallel, under a mesh context whose model axis divides the
    experts: each rank routes its token block to its own experts, with the
    capacity on its local token count, and a sum over the model axis
    combines the ranks' partial outputs.  Serving on global values
    (:func:`apply_ep`) takes the blocks from them and combines with an
    all-reduce; on local blocks (the sharded train step, sharded serving:
    :func:`apply_blocks`) each rank holds its blocks and combines with the
    differentiable ``tp_output``.  On local blocks whose model axis does not
    divide the experts, every rank runs the reference's global dispatch on
    the gathered tokens (:func:`apply_gathered`).

``jax.numpy``'s ``.at[...].set(mode="drop")`` drops out-of-range updates;
``index_put`` raises on them instead.  So the buffer has one more expert
row, ``[E+1, C, D]``, that takes the dropped assignments and is sliced off
before the products, as the reference's ``apply_ep`` does.

When ``torch.profiler`` records, the route, dispatch, expert and combine
steps are marked with :func:`torch.profiler.record_function` ranges named
``moe.*`` (:data:`SCOPES`), which ``launch/profile_serve`` uses to class
their kernels.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Tuple

import torch
from torch.profiler import record_function

from repro_torch.models import mlp
from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.parallel.mesh_ctx import (all_reduce, blocks_ctx, current_ctx, gather,
                                           gather_dim0, reduce, tp_input, tp_output)
from repro_torch.parallel.sharding import use_param

#: the ``record_function`` ranges of one MoE layer
SCOPES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def _scope(name: str):
    """A profiler range while the profiler records, else nothing (a range
    costs host time on every call)."""
    return record_function(name) if torch.autograd._profiler_enabled() \
        else contextlib.nullcontext()


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert: ⌈T·k·cf/E⌉, at least 8, rounded up to a multiple
    of 128 (the reference's MXU-aligned rows; 128 at decode)."""
    m = cfg.moe
    assert m is not None
    cap = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.num_experts))
    return max(8, ((cap + 127) // 128) * 128)


def init(gen: torch.Generator, cfg: ModelConfig, *, device,
         lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    """``router [D,E]``, ``w_gate``/``w_up [E,D,F]``, ``w_down [E,F,D]`` and
    the shared experts' MLP (width F·num_shared), each behind ``lead``.

    ``w_down`` is drawn as ``[E,F,D]`` with the reference's scale 1/√D (it
    draws ``[E,D,F]`` and swaps the last two axes), so no transposed copy of
    the largest tensor is ever made.
    """
    m = cfg.moe
    assert m is not None
    d, f, e, pd = cfg.d_model, m.d_expert, m.num_experts, cfg.pdtype
    lead = tuple(lead)
    p: Dict[str, Any] = {
        "router": dense_init(gen, d, e, pd, device=device, lead=lead),
        "w_gate": dense_init(gen, d, f, pd, device=device, lead=lead + (e,)),
        "w_up": dense_init(gen, d, f, pd, device=device, lead=lead + (e,)),
        "w_down": torch.randn(lead + (e, f, d), generator=gen, dtype=torch.float32,
                              device=device).mul_(1.0 / math.sqrt(d)).to(pd),
    }
    if m.num_shared:
        p["shared"] = mlp.init(gen, cfg, d_ff=f * m.num_shared, device=device, lead=lead)
    return p


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: (values, indices), largest
    first, equal values in index order.  ``torch.topk`` promises no order
    among ties; a stable descending sort does."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def _router_probs(router: torch.Tensor, x2d: torch.Tensor) -> torch.Tensor:
    logits = x2d.float() @ router.float()
    return torch.softmax(logits, dim=-1)


def route(params: Dict[str, Any], cfg: ModelConfig, x2d: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: [T, D] → (expert_ids [T,k] int64, weights [T,k] fp32); router
    math in fp32."""
    weights, ids = _top_k(_router_probs(params["router"], x2d), cfg.moe.top_k)
    return ids, weights / weights.sum(dim=-1, keepdim=True)


def dispatch(ids: torch.Tensor, num_experts: int, cap: int
             ) -> Dict[str, torch.Tensor]:
    """Where each assignment goes, in expert order.

    ids: [T, k] expert ids.  Returns, each over the T·k assignments sorted
    stably by expert: ``order`` (the sort permutation of the flat ids),
    ``expert`` (the sorted ids), ``pos`` (the rank within the expert's
    block), ``kept`` (``pos < cap``) and ``row`` (the buffer row: the
    expert, or ``num_experts``, the trash row, for a dropped assignment).
    """
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    expert = flat[order]
    start = torch.searchsorted(expert, torch.arange(num_experts, device=ids.device,
                                                    dtype=expert.dtype), right=False)
    pos = torch.arange(flat.numel(), device=ids.device) - start[expert]
    kept = pos < cap
    row = torch.where(kept, expert, num_experts)
    return {"order": order, "expert": expert, "pos": pos, "kept": kept, "row": row}


def apply(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, L, D] → [B, L, D].  On local blocks (the sharded train step,
    sharded serving) the expert-parallel :func:`apply_blocks` where the
    model axis divides the experts, else :func:`apply_gathered`, the
    reference's global dispatch on every rank's tokens; under a mesh
    context of ranks whose model axis divides the experts, on global values
    (serving), the expert-parallel :func:`apply_ep`, whose all-reduce
    refuses a tensor that needs a gradient; otherwise (no context, or a
    context of axis sizes alone, which has no ranks) the single-device
    :func:`apply_ref`, which doubles as the oracle."""
    ctx = current_ctx()
    m = cfg.moe
    assert m is not None
    if blocks_ctx() is not None:
        if m.num_experts % ctx.model_size == 0:
            return apply_blocks(params, cfg, x, ctx)
        return apply_gathered(params, cfg, x, ctx)
    if ctx is not None and ctx.on_ranks and m.num_experts % ctx.model_size == 0:
        return apply_ep(params, cfg, x, ctx)
    return apply_ref(params, cfg, x)


def apply_ref(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Single-device reference: global sort-based dispatch."""
    b, l, d = x.shape
    x2d = x.reshape(b * l, d)
    y = routed(params, cfg, x2d)
    if cfg.moe.num_shared:
        y = y + mlp.apply(params["shared"], cfg, x2d, d_ff=shared_width(cfg))
    return y.reshape(b, l, d)


def routed(params: Dict[str, Any], cfg: ModelConfig, x2d: torch.Tensor) -> torch.Tensor:
    """The routed experts' output [T, D] of every token of x2d [T, D] (the
    MoE layer without its shared experts), at :func:`capacity` of T: the
    router ``params["router"]`` and the experts ``w_gate``, ``w_up``,
    ``w_down``, all E of them."""
    m = cfg.moe
    assert m is not None
    t, d = x2d.shape
    k, e = m.top_k, m.num_experts
    ct = cfg.cdtype
    cap = capacity(t, cfg)

    with _scope("moe.route"):
        ids, weights = route(params, cfg, x2d)                   # [T,k]
    with _scope("moe.dispatch"):
        s = dispatch(ids, e, cap)
        src = x2d[s["order"] // k].to(ct)                        # [A, D]
        slot = torch.where(s["kept"], s["pos"], 0)
        buf = torch.zeros((e + 1, cap, d), dtype=ct, device=x2d.device)
        buf = buf.index_put((s["row"], slot), src)[:e]           # row e: dropped

    # batched products have a batch dim: remat "dots" recomputes them, as the
    # reference's checkpoint_dots_with_no_batch_dims does
    with _scope("moe.experts"):
        g = mlp.silu(torch.bmm(buf, params["w_gate"].to(ct)))
        u = torch.bmm(buf, params["w_up"].to(ct))
        out_buf = torch.bmm(g * u, params["w_down"].to(ct))     # [E, C, D]

    with _scope("moe.combine"):
        gathered = out_buf[s["expert"], torch.clamp(s["pos"], max=cap - 1)]
        gathered = gathered.masked_fill(~s["kept"][:, None], 0.0)      # dropped: 0
        unsort = torch.argsort(s["order"])                       # inverse permutation
        per_assign = gathered[unsort].reshape(t, k, d)
        # one contraction over k with one rounding, as the reference's einsum
        return torch.bmm(weights.to(ct)[:, None, :], per_assign)[:, 0, :]


# ==========================================================================
# Expert-parallel paths
# ==========================================================================
#
# Token activations are sharded over the batch axes and replicated over the
# model axis; experts are sharded over the model axis.  Dispatch is
# collective-free — each model rank selects, from its copy of the batch
# block, the assignments that target its own experts — and the combine is
# one sum over the model axis.  The reference's shard_map body is
# :func:`ep_partial` on the rank's blocks.  Serving (:func:`apply_ep`):
# every rank holds the global batch and returns the global result.  The
# sharded train step (:func:`apply_blocks`): every rank holds its batch
# block and its experts, and returns its block of the output.


def shared_width(cfg: ModelConfig) -> int:
    """The shared experts' MLP width: F · num_shared (not ``cfg.d_ff``, a
    flag in MoE configs)."""
    return cfg.moe.d_expert * cfg.moe.num_shared


def ep_capacity(t_loc: int, cfg: ModelConfig) -> int:
    """Rows per expert on a rank: ⌈t_loc·k·cf/E⌉ on the *local* token count,
    at least 8, rounded up to a multiple of 8 (not 128 as in
    :func:`capacity`: which tokens drop depends on the path and on the size
    of the batch axes)."""
    m = cfg.moe
    cap = int(math.ceil(t_loc * m.top_k * m.capacity_factor / m.num_experts))
    return max(8, ((cap + 7) // 8) * 8)


def expert_block(params: Dict[str, Any], lo: int, e_loc: int) -> Dict[str, Any]:
    """The router and experts ``lo … lo+e_loc−1`` of global MoE parameters,
    as :func:`ep_partial` takes them."""
    return {"router": params["router"],
            **{n: params[n][lo:lo + e_loc] for n in ("w_gate", "w_up", "w_down")}}


def ep_partial(params: Dict[str, Any], cfg: ModelConfig, x_loc: torch.Tensor,
               lo: int) -> torch.Tensor:
    """One rank's share of the MoE output on its token block ``x_loc``
    [t_loc, D]: the weighted outputs of its experts only, [t_loc, D] in the
    compute dtype.  ``params`` holds the router [D, E] and the rank's block
    of the experts, ``w_gate``/``w_up`` [e_loc, D, F] and ``w_down`` [e_loc,
    F, D], global experts ``lo … lo+e_loc−1``.  Summed over the model ranks
    it is the layer's output without the shared experts."""
    m = cfg.moe
    t_loc, d = x_loc.shape
    k, e, ct = m.top_k, m.num_experts, cfg.cdtype
    e_loc = params["w_gate"].shape[0]
    cap = ep_capacity(t_loc, cfg)
    with _scope("moe.route"):
        ids, weights = route(params, cfg, x_loc)
    with _scope("moe.dispatch"):
        s = dispatch(ids, e, cap)
        local_e = s["expert"] - lo
        valid = s["kept"] & (local_e >= 0) & (local_e < e_loc)
        idx_e = torch.where(valid, local_e, e_loc)               # row e_loc = trash
        idx_c = torch.where(valid, s["pos"], 0)
        buf = torch.zeros((e_loc + 1, cap, d), dtype=ct, device=x_loc.device)
        buf = buf.index_put((idx_e, idx_c), x_loc[s["order"] // k].to(ct))[:e_loc]
    with _scope("moe.experts"):
        g = mlp.silu(torch.bmm(buf, params["w_gate"].to(ct)))
        u = torch.bmm(buf, params["w_up"].to(ct))
        out_buf = torch.bmm(g * u, params["w_down"].to(ct))    # [e_loc, C, D]
    with _scope("moe.combine"):
        gathered = out_buf[torch.clamp(idx_e, max=e_loc - 1), idx_c]
        gathered = gathered.masked_fill(~valid[:, None], 0.0)
        per_assign = gathered[torch.argsort(s["order"])].reshape(t_loc, k, d)
        return torch.bmm(weights.to(ct)[:, None, :], per_assign)[:, 0, :]


def apply_ep(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor, ctx) -> torch.Tensor:
    """Expert-parallel MoE for serving on this rank of ``ctx``'s mesh; x [B,
    L, D] is the global batch, which every rank holds, and so is the result.

    The rank takes its token block by its coordinate on the batch axes
    (the B·L tokens split evenly over them) and its experts by its
    coordinate on the model axis; the partial outputs are summed by one
    all-reduce over the model axis in the compute dtype, and the blocks
    gathered back over the batch axes.  The all-reduces are not
    differentiable: the sharded train step takes :func:`apply_blocks`.  The
    shared experts run on the whole batch outside, as in the reference.
    """
    m = cfg.moe
    b, l, d = x.shape
    t, ct = b * l, cfg.cdtype
    batch = tuple(ctx.batch_axes)
    if t % ctx.batch_size:
        raise ValueError(f"{t} tokens do not split over the batch axes {batch} "
                         f"({ctx.batch_size} blocks)")
    t_loc = t // ctx.batch_size
    e_loc = m.num_experts // ctx.model_size
    x2d = x.reshape(t, d)
    i = ctx.linear_coord(batch)
    lo = ctx.coord(ctx.model_axis) * e_loc
    y = ep_partial(expert_block(params, lo, e_loc), cfg, x2d[i * t_loc:(i + 1) * t_loc],
                   lo).to(ct)
    with _scope("moe.combine"):
        all_reduce(y, ctx.group(ctx.model_axis))
        y = gather_dim0(y, t, ctx, batch)
    if m.num_shared:
        y = y + mlp.apply(params["shared"], cfg, x2d.to(ct), d_ff=shared_width(cfg))
    return y.reshape(b, l, d)


def _read_experts(params: Dict[str, Any], cfg: ModelConfig, model_partial) -> Dict[str, Any]:
    """The router and the experts as this rank's computation on local
    blocks reads them (:func:`~repro_torch.parallel.sharding.use_param` by
    the rule table); ``model_partial(name)``: whether that leaf's gradient
    is summed over the model axis."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.num_experts
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    return {n: use_param(params[n], ("moe", n), shape, model_partial=model_partial(n))
            for n, shape in shapes.items()}


def apply_blocks(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                 ctx) -> torch.Tensor:
    """Expert-parallel MoE on this rank's blocks (the sharded train step,
    sharded serving): x [B_loc, L, D] (or [B_loc, L/model, D] with ``seq_shard_activations``)
    → the same block of the output.

    The counterpart of the reference's ``shard_map`` body, differentiable.
    The input enters through ``tp_input`` (the sequence gathered under
    ``seq_shard_activations``, so the rank's t_loc = B_loc·L tokens are the
    reference's block of ``x2d`` rows, in its order), the capacity is
    :func:`ep_capacity` of t_loc, and the experts are the rank's block by
    the rule table (E over the model axis, D gathered over the FSDP axes).
    The partial output leaves through ``tp_output``, a sum over the model
    axis whose backward is the identity.  The router is read with its
    gradient summed over the model axis: each model rank's routing weights
    meet only its own experts' outputs.  The shared experts are the
    tensor-parallel MLP on the same block (whole on every model rank where
    the model axis does not divide their width).  The model axis must divide
    the experts (:func:`apply` takes :func:`apply_gathered` otherwise)."""
    m, d = cfg.moe, cfg.d_model
    w = _read_experts(params, cfg, lambda n: n == "router")
    xin = tp_input(x)
    b, l, _ = xin.shape
    lo = ctx.coord(ctx.model_axis) * w["w_gate"].shape[0]
    y = ep_partial(w, cfg, xin.reshape(b * l, d), lo).to(cfg.cdtype)
    with _scope("moe.combine"):
        y = tp_output(y.reshape(b, l, d))
    if m.num_shared:
        y = y + mlp.apply(params["shared"], cfg, x, d_ff=shared_width(cfg))
    return y


def apply_gathered(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                   ctx) -> torch.Tensor:
    """The MoE layer on this rank's blocks where the model axis does not
    divide the experts: the counterpart of the reference's :func:`apply_ref`
    under GSPMD, which it falls back to there.  x [B_loc, L, D] (or [B_loc,
    L/model, D] with ``seq_shard_activations``) → the same block of the
    output.

    Every rank gathers the tokens of all ranks in the reference's global
    ``x2d`` row order (its batch block over the batch axes, its sequence
    block over the model axis under ``seq_shard_activations``), reads the
    router and all E experts (the rule table's guard keeps E whole; D is
    gathered over the FSDP axes), runs the global dispatch at
    :func:`capacity` of the global token count and keeps its own rows.
    The gather's backward sums the ranks' partial input gradients and cuts
    the rank's block.  Each rank's experts and router meet only its own
    rows' output gradients, so their gradients are summed over the axes
    whose ranks hold other rows: the batch axes, and the model axis only
    under ``seq_shard_activations`` (otherwise the model axis's ranks hold
    the same rows, each with their whole gradient).  The shared experts
    are the tensor-parallel MLP on the rank's block."""
    m, d = cfg.moe, cfg.d_model
    seq = ctx.seq_shard_activations
    w = _read_experts(params, cfg, lambda n: seq)
    b, l, _ = x.shape
    xg = gather(x, 0, ctx.batch_axes, ctx)
    if seq:
        xg = gather(xg, 1, ctx.model_axis, ctx)
    y = routed(w, cfg, xg.reshape(-1, d)).reshape(xg.shape)
    with _scope("moe.combine"):
        y = y.narrow(0, ctx.linear_coord(tuple(ctx.batch_axes)) * b, b)
        if seq:
            y = y.narrow(1, ctx.coord(ctx.model_axis) * l, l)
    if m.num_shared:
        y = y + mlp.apply(params["shared"], cfg, x, d_ff=shared_width(cfg))
    return y


def aux_loss(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E · Σ_e f_e · p_e, with
    f_e the share of top-k assignments to expert e and p_e its mean router
    probability, over every token.

    On local blocks x is the rank's block of the tokens: the counts and the
    probability sums are summed over the batch axes (and the model axis,
    which splits the sequence under ``seq_shard_activations``) before they
    are divided, since a product of two means does not split over blocks.
    The sum's backward is the identity, so the router's gradient through
    this loss is partial over the axes that split the tokens: summed over
    the model axis only under ``seq_shard_activations`` (otherwise every
    model rank computes it whole, on the same tokens)."""
    m = cfg.moe
    ctx = blocks_ctx()
    router = params["router"]
    if ctx is not None:
        router = use_param(router, ("moe", "router"), (cfg.d_model, m.num_experts),
                           model_partial=ctx.seq_shard_activations)
    with _scope("moe.route"):
        x2d = x.reshape(-1, x.shape[-1])
        probs = _router_probs(router, x2d)                               # [T, E]
        _, ids = _top_k(probs, m.top_k)
        experts = torch.arange(m.num_experts, device=x.device)
        counts = (ids[..., None] == experts).float().sum(dim=(0, 1))
        if ctx is None:
            imp = probs.mean(dim=0)
        else:
            axes = tuple(ctx.batch_axes) + ((ctx.model_axis,) if ctx.seq_shard_activations
                                            else ())
            sums = reduce(torch.cat([counts, probs.sum(dim=0)]), axes, ctx)
            tokens = x2d.shape[0] * math.prod(ctx.axis_size(a) for a in axes)
            counts, imp = sums[:m.num_experts], sums[m.num_experts:] / tokens
        frac = counts / counts.sum()
        return m.num_experts * (frac * imp).sum()
