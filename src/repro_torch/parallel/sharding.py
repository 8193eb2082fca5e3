"""Sharding rules: one rule table serving all 10 architectures.

The port of :mod:`repro.parallel.sharding`, with its tables as they stand.
Parameters are FSDP-sharded over ``fsdp_axes`` on their "depth" dimension
and TP/EP-sharded over ``model_axis`` on their parallel dimension (heads /
ffn / experts / vocab / lru width).  Every rule is *divisibility-guarded* —
an axis that does not divide the dim is dropped, never errored — so the
same table covers kv-head counts from 1 to 32 and vocabs from 32k to 256k.

Rules address the **trailing** dims of a leaf: scan-stacked parameters carry
a leading ``[G, ...]`` group dim that always stays unsharded.

A spec is a tuple with one entry per dim: None (replicated), an axis name,
or a tuple of axis names (major first), as the reference's
``PartitionSpec`` entries; the trees of specs returned here equal the
reference's ``NamedSharding`` specs leaf by leaf.  :func:`placements` turns
a spec into DTensor placements, :func:`distribute_tree` places a tree of
global tensors as DTensors by slicing, with no collective, and
:func:`gather_rows` and :func:`gather_tree` join such tensors back into
global values.

Under local blocks (``MeshCtx.local_blocks``, the sharded train step) the
model code reads each parameter through :func:`use_param`, which looks its
spec up in the same table: the FSDP dims are gathered for the use, the
model axis's split stays, and the gradient comes back as the rank's block.
:func:`model_split` says whether the table splits a leaf over the model
axis: where its guard leaves the leaf whole, the rank computes the whole
product.  A parameter the table replicates over the model axis that feeds only the
rank's block of a split dim (the SSM's per-head vectors) is read through
:func:`use_param_block`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.parallel.mesh_ctx import (MeshCtx, all_reduce, axes_size, blocks_ctx,
                                           gather, is_distributed, mesh_shape, replicate,
                                           scatter, spec_axes, tally_collective)

Spec = Tuple[Any, ...]

# rule tokens
_F = "__fsdp__"      # substitute ctx.fsdp_axes
_M = "__model__"     # substitute ctx.model_axis
_B = "__batch__"     # substitute ctx.batch_axes


# Trailing-dim specs per parameter name.  ``None`` = replicated dim.
_RULES: Dict[str, Tuple] = {
    # top level
    "embed": (_M, _F),            # [Vp, D]
    "lm_head": (_F, _M),          # [D, Vp]
    # attention
    "wq": (_F, _M), "wk": (_F, _M), "wv": (_F, _M), "wo": (_M, _F),
    "bq": (_M,), "bk": (_M,), "bv": (_M,),
    # dense mlp
    "w_gate": (_F, _M), "w_up": (_F, _M), "w_down": (_M, _F),
    # ssm (mamba2) — separate projections: z/x/dt streams TP over heads;
    # B/C replicated; out-proj contracts the sharded inner dim, like wo.
    "wz": (_F, _M), "wx": (_F, _M), "wdt": (_F, _M),
    "wb": (_F, None), "wc": (_F, None),
    "w_out": (_M, _F),
    "conv_x_w": (None, _M), "conv_x_b": (_M,),
    # rglru — lru width is the TP dim
    "w_x": (_F, _M), "w_r": (None, _M), "w_i": (None, _M),
    "conv_b": (_M,), "lam": (_M,),
}

# expert-parallel overrides for leaves under a "moe" subtree (not "shared")
_MOE_RULES: Dict[str, Tuple] = {
    "router": (_F, None),             # [D, E] — router math is fp32+replicated
    "w_gate": (_M, _F, None),         # [E, D, F]
    "w_up": (_M, _F, None),
    "w_down": (_M, None, _F),         # [E, F, D]
}

# rglru conv weight [K, W]
_RGLRU_CONV = {"conv_w": (None, _M)}


def _resolve(entry, ctx: MeshCtx):
    if entry == _F:
        return ctx.fsdp_axes if len(ctx.fsdp_axes) > 1 else ctx.fsdp_axes[0]
    if entry == _M:
        return ctx.model_axis
    if entry == _B:
        return ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
    return entry


def safe_spec(shape: Sequence[int], spec: Sequence, mesh: Any) -> Spec:
    """Drop axes that don't divide their dim; keep everything else.  The
    result has one entry per dim of ``shape``."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
            continue
        axes = spec_axes(entry)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if dim % prod != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    out += [None] * (len(shape) - len(spec))
    return tuple(out)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def spec_for(path: Sequence[str], leaf, ctx: MeshCtx) -> Spec:
    """The spec of the leaf at ``path`` (its keys, outermost first)."""
    names = tuple(str(k) for k in path)
    name = names[-1]
    in_moe = "moe" in names and "shared" not in names
    in_rglru = "rec" in names
    rule: Optional[Tuple] = None
    if in_moe and name in _MOE_RULES:
        rule = _MOE_RULES[name]
    elif in_rglru and name in _RGLRU_CONV:
        rule = _RGLRU_CONV[name]
    elif name in _RULES:
        rule = _RULES[name]
    shape = _shape(leaf)
    if rule is None:
        return (None,) * len(shape)     # replicated (norm scales, conv, scalars)
    rule = tuple(_resolve(e, ctx) for e in rule)
    # right-align the rule onto the trailing dims
    lead = len(shape) - len(rule)
    if lead < 0:
        return (None,) * len(shape)
    return safe_spec(shape, (None,) * lead + rule, ctx.mesh)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(params: Any, ctx: MeshCtx):
    """Tree of specs matching ``params`` (works on ``meta`` trees too)."""
    return _map_with_path(lambda path, leaf: spec_for(path, leaf, ctx), params)


def cache_shardings(cache: Any, ctx: MeshCtx):
    """Decode-cache specs.

    KV rings shard batch over the batch axes and then the model axis over
    (in preference order) the slots with ``shard_kv_seq``, else kv-heads,
    else head_dim.  Recurrent states shard heads / width over the model
    axis.  ``pos`` (an int in the port) and 0-d leaves are replicated.
    """
    b_axes = tuple(ctx.batch_axes)
    m = ctx.model_axis
    msize = ctx.model_size

    def rule(path, leaf) -> Spec:
        name = path[-1]
        shape = _shape(leaf)
        rank = len(shape)
        if name == "pos" or rank == 0:
            return (None,) * rank
        spec: list = [None] * rank
        if name in ("k", "v", "mk", "mv"):
            lead = rank - 4                           # (G,)B,S,H,hd
            spec[lead] = b_axes
            if ctx.shard_kv_seq and shape[lead + 1] % msize == 0:
                spec[lead + 1] = m                    # flash-decoding layout
            elif shape[lead + 2] % msize == 0:
                spec[lead + 2] = m
            elif shape[lead + 3] % msize == 0:
                spec[lead + 3] = m
        elif name == "h" and rank >= 4:               # ssm: (G,)B,H,P,N
            lead = rank - 4
            spec[lead] = b_axes
            if shape[lead + 1] % msize == 0:
                spec[lead + 1] = m
        elif name == "h":                             # rglru: (G,)B,W
            lead = rank - 2
            spec[lead] = b_axes
            if shape[lead + 1] % msize == 0:
                spec[lead + 1] = m
        elif name.startswith("conv"):                 # (G,)B,K-1,C
            lead = rank - 3
            spec[lead] = b_axes
            if shape[lead + 2] % msize == 0:
                spec[lead + 2] = m
        else:
            return (None,) * rank
        return safe_spec(shape, spec, ctx.mesh)

    return _map_with_path(rule, cache)


def batch_spec(ctx: MeshCtx, rank: int, *, batch_dim: int = 0) -> Spec:
    """Batch-sharded activation spec: dim0 over batch axes, rest replicated."""
    entries: list = [None] * rank
    entries[batch_dim] = (ctx.batch_axes if len(ctx.batch_axes) > 1
                          else ctx.batch_axes[0])
    return tuple(entries)


def input_shardings(ctx: MeshCtx, tree: Any):
    """Shard every input leaf on its leading (batch) dim, guarded."""
    return _map_with_path(
        lambda _, leaf: safe_spec(_shape(leaf), [tuple(ctx.batch_axes)], ctx.mesh)
        if _shape(leaf) else (), tree)


# ==========================================================================
# Specs as DTensor placements, and placing a tree
# ==========================================================================


def placements(spec: Spec, mesh) -> list:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``.

    A dim sharded over several axes lists them major first, which must be
    the mesh's own order (DTensor's nesting of ``Shard`` on one dim)."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not in the "
                             f"mesh's order {tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


def spec_of(t: DTensor) -> Spec:
    """The spec of a DTensor's placements (the inverse of :func:`placements`)."""
    names = t.device_mesh.mesh_dim_names
    dims: list = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} has no spec")
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a)) for a in dims)


def local_slices(shape: Sequence[int], spec: Spec, ctx: MeshCtx) -> Tuple[slice, ...]:
    """This rank's block of a tensor of global ``shape`` laid out by ``spec``."""
    out = []
    for dim, entry in zip(shape, spec):
        axes = spec_axes(entry)
        n = axes_size(ctx, axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axes}")
        rows = dim // n
        i = ctx.linear_coord(axes) if axes else 0
        out.append(slice(i * rows, (i + 1) * rows))
    return tuple(out)


def local_block(t: Any) -> Any:
    """This rank's block of a DTensor; any other value as it is."""
    return t.to_local() if is_distributed(t) else t


def from_block(local: torch.Tensor, spec: Spec, ctx: MeshCtx) -> DTensor:
    """The DTensor laid out by ``spec`` whose block on this rank is
    ``local`` (every rank passes its own block).  No collective runs."""
    return DTensor.from_local(local, ctx.mesh, placements(spec, ctx.mesh), run_check=False)


def empty_blocks(tree: Any, specs: Any, ctx: MeshCtx, device) -> Any:
    """Every tensor of ``tree`` (its leaves give global shapes and dtypes,
    as a ``meta`` template does) as the DTensor laid out by the matching
    spec of ``specs`` whose block on this rank is an empty tensor on
    ``device``: inside a ``FakeTensorMode``, a rank's fake blocks, which the
    dry run traces.  Leaves that are not tensors pass through."""
    if isinstance(tree, dict):
        return {k: empty_blocks(v, specs[k], ctx, device) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    block = [s.stop - s.start for s in local_slices(tuple(tree.shape), specs, ctx)]
    return from_block(torch.empty(block, dtype=tree.dtype, device=device), specs, ctx)


def distribute(x: torch.Tensor, spec: Spec, ctx: MeshCtx) -> DTensor:
    """A DTensor from the global value ``x`` that every rank holds: each
    rank keeps (a copy of) its own block.  No collective runs."""
    local = x[local_slices(tuple(x.shape), spec, ctx)].clone(
        memory_format=torch.contiguous_format)
    return from_block(local, spec, ctx)


def distribute_tree(tree: Any, specs: Any, ctx: MeshCtx) -> Any:
    """Place every tensor of ``tree`` by the matching spec of ``specs``;
    leaves that are not tensors (a cache's ``pos``) pass through."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], ctx) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or is_distributed(tree):
        return tree
    return distribute(tree, specs, ctx)


def gather_rows(t: DTensor, start: int = 0, stop: Optional[int] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows ``start:stop`` (all by default) of dim 0 of the global value of
    the DTensor ``t``, on every rank of its mesh: a collective, every rank
    calls it with the same rows.  Joined with ``all_reduce`` alone (gloo has
    no ``all_gather`` for CUDA tensors): a zero-filled buffer of those rows
    only (``out``, of their shape and ``t``'s dtype, when given), the part
    of this rank's block that falls in them written in, summed over the
    axes that split ``t`` (adding zeros is exact).  A 0-d ``t`` is
    replicated: its value."""
    local = t.to_local()
    if t.ndim == 0:
        return local
    shape, spec = tuple(t.shape), spec_of(t)
    ctx = MeshCtx(t.device_mesh)
    stop = shape[0] if stop is None else stop
    block = local_slices(shape, spec, ctx)
    if out is None:
        out = local.new_zeros((stop - start,) + shape[1:])
    else:
        out.zero_()
    lo, hi = max(start, block[0].start), min(stop, block[0].stop)
    if lo < hi:
        out[(slice(lo - start, hi - start),) + block[1:]] = \
            local[lo - block[0].start:hi - block[0].start]
    axes = tuple(a for entry in spec for a in spec_axes(entry))
    if axes:
        n = axes_size(ctx, axes)
        tally_collective("all-gather", n, out.numel() * out.element_size() // n)
    for axis in axes:
        all_reduce(out, ctx.group(axis), kind=None)
    return out


def gather_tree(tree: Any) -> Any:
    """The global value of every DTensor of ``tree`` on every rank
    (:func:`gather_rows`); other leaves pass through.  Every rank of the
    DTensors' mesh must call it with the same tree.  Each rank then holds
    the whole tree: :func:`repro_torch.train.checkpoint.save` joins a
    sharded state a piece at a time instead."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    return gather_rows(tree) if is_distributed(tree) else tree


# ==========================================================================
# Parameters and inputs under local blocks
# ==========================================================================


class _Leaf(NamedTuple):
    shape: Tuple[int, ...]


def param_spec(name, shape: Sequence[int], ctx: MeshCtx) -> Spec:
    """The rule table's spec of parameter ``name`` of global ``shape`` (its
    trailing dims: a stacked leaf's ``[G]`` dim is never sharded).
    ``name`` is the leaf's key, or a tuple of the keys of its path where the
    rule depends on the subtree (``("rec", "conv_w")``)."""
    path = tuple(name) if isinstance(name, tuple) else (name,)
    return spec_for(path, _Leaf(tuple(shape)), ctx)


def model_split(name, shape: Sequence[int], dim: int = -1) -> bool:
    """Whether the rule table splits dim ``dim`` of parameter ``name`` (global
    ``shape``; ``name`` as :func:`param_spec` takes it) over the model axis
    on the ambient local blocks: a tensor-parallel region whose leaf it is
    runs on the rank's block of that dim; where the guard drops the axis (it
    does not divide the dim) every model rank computes the region whole.
    True off local blocks, where the entry and exit of a region are
    identities."""
    ctx = blocks_ctx()
    if ctx is None:
        return True
    return ctx.model_axis in spec_axes(param_spec(name, shape, ctx)[dim])


def use_param(w: torch.Tensor, name, shape: Sequence[int], *,
              model_partial: bool = False) -> torch.Tensor:
    """The value of parameter ``name`` (global ``shape``; ``name`` as
    :func:`param_spec` takes it) that this rank's computation uses, from its
    block ``w``.

    Under local blocks: gathered over the FSDP axes of its spec (the
    gather's backward is a reduce-scatter, so the gradient comes back as
    this rank's block), still split over the model axis where the rule
    table splits it.  Its gradient is also summed over the axes that split
    the data it meets and do not split the parameter: the batch axes, and
    the model axis when ``model_partial`` (the sequence is split over it, or
    a tensor-parallel product takes the rank's partial from it).
    Otherwise ``w`` is returned."""
    ctx = blocks_ctx()
    if ctx is None:
        return w
    spec = param_spec(name, shape, ctx)
    local = tuple(n // axes_size(ctx, e) for n, e in zip(shape, spec))
    if tuple(w.shape) != local:
        raise ValueError(f"parameter {name}: block {tuple(w.shape)}, the rule table's "
                         f"{local} of {tuple(shape)} by {spec}")
    split = {a for e in spec for a in spec_axes(e)}
    need = set(ctx.batch_axes) | ({ctx.model_axis} if model_partial else set())
    w = replicate(w, tuple(a for a in ctx.all_axes if a in need and a not in split), ctx)
    for dim, entry in enumerate(spec):
        fsdp = tuple(a for a in spec_axes(entry) if a != ctx.model_axis)
        if fsdp:
            w = gather(w, dim, fsdp, ctx)
    return w


def use_param_block(w: torch.Tensor, name, shape: Sequence[int], dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` over the model axis of parameter
    ``name``, which the rule table does not split over it but whose use
    meets only the rank's block of a split dim (the SSM's ``A_log``, ``D``
    and ``dt_bias`` [H] against the rank's heads).  The rank's gradient of
    the whole is the blocks' gradients joined over the model axis (the
    backward of :func:`~repro_torch.parallel.mesh_ctx.scatter`), so each
    rank holds the same gradient, as for any replicated parameter.  Off
    local blocks: :func:`use_param`'s value, whole."""
    w = use_param(w, name, shape)
    ctx = blocks_ctx()
    return w if ctx is None else scatter(w, dim, ctx.model_axis, ctx)


def local_batch(batch: Dict[str, torch.Tensor], ctx: MeshCtx) -> Dict[str, torch.Tensor]:
    """This rank's block of every input: a DTensor's local block, or the
    slice of a global tensor by :func:`input_shardings`.  The batch must
    split over the batch axes: a replicated batch would count each example
    once a batch rank."""
    specs = input_shardings(ctx, batch)
    out = {}
    for k, x in batch.items():
        if is_distributed(x):
            out[k] = x.to_local()
            continue
        if x.ndim and spec_axes(specs[k][0]) != tuple(ctx.batch_axes):
            raise ValueError(f"input {k} {tuple(x.shape)}: dim 0 does not split over the "
                             f"batch axes {ctx.batch_axes}")
        out[k] = x[local_slices(tuple(x.shape), specs[k], ctx)] if x.ndim else x
    return out
