"""Mesh context: which mesh and axes the model code runs under.

The port of :mod:`repro.parallel.mesh_ctx`.  Model code (attention, mlp,
moe, lm) is mesh-agnostic; where a distribution decision matters it
consults the ambient :class:`MeshCtx`.  Smoke tests and the plain oracles
run with no context set, and every mesh-aware branch is then the plain
single-process code.

Execution model.  Each rank is one process.  There is no ``shard_map`` and
no GSPMD: the reference's jitted programs become explicit per-rank code
that combines through :func:`all_reduce` over the mesh's per-axis process
groups (gloo runs ``all_reduce`` on CUDA tensors as well as CPU ones; its
``all_gather`` and DTensor's redistributions run on CPU tensors only).
Two modes:

* global values (serving on global parameters).  A rank holds the global
  value of every plain tensor, which is what the reference's jit sees.  The two ``shard_map``
  bodies (``moe.apply_ep`` and ``attention._decode_seqshard``) are plain
  functions on the rank's own block, taken by its mesh coordinate, that
  return the global result on every rank.  Only a decode cache placed as
  DTensors takes ``_decode_seqshard``.  :func:`all_reduce` is not
  differentiable and refuses a tensor that needs a gradient.
* local blocks (``MeshCtx.local_blocks``, set by the sharded train step,
  :mod:`repro_torch.train.step`, and by serving on parameters placed as
  DTensors, :mod:`repro_torch.serve.engine`).  A rank holds its own block of every
  parameter (placed by the rule table) and of every activation, and the
  layout changes are the differentiable collectives below (:func:`gather`,
  :func:`scatter`, :func:`reduce`, :func:`replicate`).  The layout hints
  (:func:`constrain`, :func:`constrain_batch`) move a local block from the
  layout it is in (``src``) to the hinted one; in the other mode, or without
  a ``DeviceMesh``, they return their input.  The MoE layer takes its
  expert-parallel ``moe.apply_blocks`` here, combining through
  :func:`tp_output`.  The model code calls them
  only where the layouts differ: the embedding's output and an enc-dec
  encoder's frame projection (sequence-split under
  ``seq_shard_activations``) and the heads hint before attention.  The
  residual stream stays in the block boundary's layout by construction
  (:func:`tp_output`), and the logits leave the head in the reference's
  hinted layout (split on the vocab, or whole where the guard leaves it).

Gradients under local blocks follow Megatron's convention: a value the
model axis holds whole (the residual stream, the logits' reductions) has
its whole gradient on each rank; inside a tensor-parallel product the
input's gradient is the rank's partial, summed by the backward of the
collective that entered the product (:func:`replicate` over the model
axis, or the sequence :func:`gather` under ``seq_shard_activations``).
Where the rule table's guard leaves a region whole over the model axis (the
axis does not divide its split dim), every model rank computes the whole
product on the same input and holds the same gradients, as GSPMD runs the
reference there: nothing is summed over the model axis, and under
``seq_shard_activations`` the sequence enters through :func:`gather_alike`
and leaves through :func:`scatter`.

``MeshCtx.mesh`` is a :class:`~torch.distributed.device_mesh.DeviceMesh`
or, for the rule table alone, a mapping from axis name to size: a rule
needs only the sizes, and no distributed branch runs under such a context.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` (with ``mesh_dim_names``) or of a
    mapping of sizes."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class MeshCtx:
    """The distribution environment of the current call.

    ``batch_axes`` — mesh axes the global batch shards over (``("pod","data")``
    on the multi-pod mesh, ``("data",)`` single-pod).
    ``model_axis`` — the TP/EP axis.
    ``fsdp_axes`` — axes parameters shard over.
    ``seq_shard_activations`` — block boundaries are also sequence-sharded
    over the model axis (Megatron's sequence parallelism): norms and the
    residual run on ``[B/batch, L/model, D]`` blocks.
    ``shard_kv_seq`` — flash-decoding: a decode cache placed as DTensors with
    its slot dim over the model axis decodes through
    ``attention._decode_seqshard``.
    ``local_blocks`` — the model code runs on this rank's blocks of the
    parameters and activations (the sharded train step and sharded serving
    set it).
    """

    mesh: Any
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ("data",)
    seq_shard_activations: bool = False
    shard_kv_seq: bool = False
    local_blocks: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)

    @property
    def model_size(self) -> int:
        return self.shape[self.model_axis]

    @property
    def batch_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.shape[a]
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    # -- this rank's place on a DeviceMesh ---------------------------------

    @property
    def on_ranks(self) -> bool:
        """Whether the context is a mesh of ranks (a ``DeviceMesh``), on
        which the distributed branches can run; a mapping of sizes serves
        the rule table alone."""
        return isinstance(self.mesh, DeviceMesh)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.mesh.get_group(axis)

    def linear_coord(self, axes: Tuple[str, ...]) -> int:
        """This rank's index among the blocks of a dim sharded over ``axes``
        (the first axis is the major one, as in a PartitionSpec tuple)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord(a)
        return i


_CTX: contextvars.ContextVar[Optional[MeshCtx]] = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None)


def current_ctx() -> Optional[MeshCtx]:
    return _CTX.get()


@contextlib.contextmanager
def mesh_context(ctx: Optional[MeshCtx]):
    """Enter a mesh context for the calls inside the block."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis name or a tuple of
    them), major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def live_axes(ctx: MeshCtx, entry) -> Tuple[str, ...]:
    """The axes of the spec entry ``entry`` that have more than one rank:
    a collective over an axis of size 1 moves nothing, and is not run."""
    return tuple(a for a in spec_axes(entry) if ctx.axis_size(a) > 1)


def is_distributed(x: Any) -> bool:
    """Whether ``x`` is a ``DTensor`` (a tensor placed on a mesh)."""
    return isinstance(x, DTensor)


# ==========================================================================
# Collectives
# ==========================================================================

#: the collectives of the distributed branches since the last
#: :func:`reset_collective_stats`: calls, the bytes of the tensors they
#: reduced, the largest of those, and host seconds when ``timed``
collective_stats: Dict[str, Any] = {"calls": 0, "bytes": 0, "largest": 0, "seconds": 0.0,
                                    "timed": False}

#: the open tallies of collectives by their logical kind (the dry run's
#: :func:`repro_torch.launch.op_cost.count` opens one while it traces):
#: each maps (kind, group size) to [calls, the operand's bytes on one
#: device], where kind is ``"all-gather"`` (:func:`gather_block`, the
#: forward of :func:`gather` and the backward of :func:`scatter`),
#: ``"reduce-scatter"`` (the backward of :func:`gather`) or
#: ``"all-reduce"`` (every other :func:`all_reduce`).  Each is one
#: collective of the reference's HLO, however many gloo all-reduces
#: emulate it.
collective_tallies: List[Dict[Tuple[str, int], List[int]]] = []


def tally_collective(kind: str, n: int, nbytes: int) -> None:
    """One collective of ``kind`` over a group of ``n`` ranks on an operand
    of ``nbytes`` bytes a rank, into every open tally."""
    for t in collective_tallies:
        c = t.setdefault((kind, n), [0, 0])
        c[0] += 1
        c[1] += nbytes


def reset_collective_stats(*, timed: bool = False) -> None:
    """Zero the counts.  With ``timed`` every collective is timed on the
    host clock, after a synchronise of the card so that the time is the
    collective's own (this serialises the card's work with the host)."""
    collective_stats.update(calls=0, bytes=0, largest=0, seconds=0.0, timed=timed)


def all_reduce(x: torch.Tensor, group, op: str = "sum", *,
               kind: Optional[str] = "all-reduce") -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group`` (``op`` "sum" or "max").
    Uses only ``all_reduce``, which gloo implements for CUDA tensors as
    well as CPU ones.  Autograd does not see it, so a tensor that would
    carry a gradient is refused: the serving branches call it directly, and
    the local-blocks paths (the sharded train step, ``moe.apply_blocks``
    included) through the differentiable collectives below.  ``kind``: the
    logical collective it is tallied as (:data:`collective_tallies`), or
    None where its caller tallies the collective it emulates."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "the serving branches (moe.apply_ep, attention._decode_seqshard) do not "
            "differentiate their all-reduces: run them under torch.no_grad(), or train on "
            "local blocks (the sharded train step: moe.apply_blocks)")
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    nbytes = x.numel() * x.element_size()
    if kind is not None:
        tally_collective(kind, dist.get_world_size(group), nbytes)
    collective_stats["calls"] += 1
    collective_stats["bytes"] += nbytes
    collective_stats["largest"] = max(collective_stats["largest"], nbytes)
    if not collective_stats["timed"]:
        dist.all_reduce(x, op=red, group=group)
        return x
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    dist.all_reduce(x, op=red, group=group)
    collective_stats["seconds"] += time.perf_counter() - t0
    return x


def all_reduce_axes(x: torch.Tensor, axes, ctx: MeshCtx) -> torch.Tensor:
    """In-place sum of ``x`` over the ranks of ``axes`` (an axis name or a
    tuple of them): one all-reduce over each axis's group in turn, tallied
    as one all-reduce over them all (axes of one rank skipped)."""
    axes = live_axes(ctx, axes)
    if axes:
        tally_collective("all-reduce", axes_size(ctx, axes), x.numel() * x.element_size())
    for a in axes:
        all_reduce(x, ctx.group(a), kind=None)
    return x


def axes_size(ctx: MeshCtx, entry) -> int:
    """The number of blocks a spec entry (an axis name, a tuple of them or
    None) splits a dim into."""
    n = 1
    for a in spec_axes(entry):
        n *= ctx.axis_size(a)
    return n


def gather_block(local: torch.Tensor, dim: int, ctx: MeshCtx, entry) -> torch.Tensor:
    """The tensor whose ``dim`` blocks over the axes of the spec entry
    ``entry`` are each rank's ``local``, on every rank: a zero-filled buffer
    with the rank's block written in, summed over each axis's group in turn
    (``all_reduce`` only; adding zeros is exact).  ``entry`` None (or axes
    of one rank): the dim is not sharded and ``local`` is returned."""
    axes = live_axes(ctx, entry)
    if not axes:
        return local
    dim = dim % local.ndim
    rows = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = rows * axes_size(ctx, axes)
    full = local.new_zeros(shape)
    i = ctx.linear_coord(axes)
    full.narrow(dim, i * rows, rows).copy_(local)
    tally_collective("all-gather", axes_size(ctx, axes), local.numel() * local.element_size())
    for a in axes:
        all_reduce(full, ctx.group(a), kind=None)
    return full


def gather_dim0(local: torch.Tensor, n: int, ctx: MeshCtx, entry) -> torch.Tensor:
    """The global ``[n, ...]`` tensor whose dim-0 blocks over the axes of the
    spec entry ``entry`` are each rank's ``local``, on every rank."""
    full = gather_block(local, 0, ctx, entry)
    if full.shape[0] != n:
        raise ValueError(f"dim 0 blocks of {local.shape[0]} rows do not make {n}")
    return full


def _my_block(full: torch.Tensor, dim: int, ctx: MeshCtx, axes: Tuple[str, ...]):
    n = axes_size(ctx, axes)
    if full.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over {axes}")
    rows = full.shape[dim] // n
    return full.narrow(dim, ctx.linear_coord(axes) * rows, rows).contiguous()


# ==========================================================================
# Differentiable collectives (local blocks)
# ==========================================================================
#
# Each is an ``autograd.Function`` built on :func:`all_reduce` alone.  Their
# backwards pair up as in Megatron's tensor and sequence parallelism:
# gather ↔ reduce-scatter, scatter ↔ gather, reduce (the row-parallel
# product's sum) ↔ identity, replicate (the column-parallel product's
# input) ↔ all-reduce.


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, axes, ctx):
        fctx.dim, fctx.axes, fctx.ctx = dim, axes, ctx
        return gather_block(x, dim, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        g = g.contiguous().clone()
        tally_collective("reduce-scatter", axes_size(fctx.ctx, fctx.axes),
                         g.numel() * g.element_size())
        for a in fctx.axes:
            all_reduce(g, fctx.ctx.group(a), kind=None)
        return _my_block(g, fctx.dim, fctx.ctx, fctx.axes), None, None, None


class _GatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, axes, ctx):
        fctx.dim, fctx.axes, fctx.ctx = dim, axes, ctx
        return gather_block(x, dim, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return _my_block(g, fctx.dim, fctx.ctx, fctx.axes), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, axes, ctx):
        fctx.dim, fctx.axes, fctx.ctx = dim, axes, ctx
        return _my_block(x, dim, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return gather_block(g.contiguous(), fctx.dim, fctx.ctx, fctx.axes), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axes, ctx):
        return all_reduce_axes(x.contiguous().clone(), axes, ctx)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axes, ctx):
        fctx.axes, fctx.ctx = axes, ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce_axes(g.contiguous().clone(), fctx.axes, fctx.ctx), None, None


def gather(x: torch.Tensor, dim: int, axes, ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` over ``axes`` (an axis name or a
    tuple, major first) joined on every rank; backward: the gradient summed
    over ``axes`` and cut to this rank's block (a reduce-scatter)."""
    ctx = ctx or current_ctx()
    axes = live_axes(ctx, axes)
    if not axes:
        return x
    return _Gather.apply(x, dim % x.ndim, axes, ctx)


def scatter(x: torch.Tensor, dim: int, axes, ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """This rank's block of ``x`` (held whole on every rank) along ``dim``
    over ``axes``; backward: the blocks' gradients joined (a gather)."""
    ctx = ctx or current_ctx()
    axes = live_axes(ctx, axes)
    if not axes:
        return x
    return _Scatter.apply(x, dim % x.ndim, axes, ctx)


def reduce(x: torch.Tensor, axes, ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (forward ``all_reduce``);
    backward: the identity."""
    ctx = ctx or current_ctx()
    axes = live_axes(ctx, axes)
    if not axes:
        return x
    return _Reduce.apply(x, axes, ctx)


def replicate(x: torch.Tensor, axes, ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """``x`` itself; backward: the gradient summed over the ranks of
    ``axes`` (``all_reduce``): the ranks' partial gradients of a value they
    hold alike, such as a parameter replicated along the axes that split
    the batch or the sequence."""
    ctx = ctx or current_ctx()
    axes = live_axes(ctx, axes)
    if not axes:
        return x
    return _Replicate.apply(x, axes, ctx)


# ==========================================================================
# Layout hints
# ==========================================================================


def blocks_ctx() -> Optional[MeshCtx]:
    """The ambient context if the model code runs on local blocks on a
    ``DeviceMesh``, else None."""
    ctx = current_ctx()
    if ctx is None or not ctx.local_blocks or not ctx.on_ranks:
        return None
    return ctx


def relayout(x: torch.Tensor, src, dst, ctx: MeshCtx) -> torch.Tensor:
    """Move a local block from layout ``src`` to ``dst`` (specs with one
    entry per dim): a dim sharded in ``src`` and not in ``dst`` is gathered,
    then one sharded in ``dst`` and not in ``src`` is scattered.  Gathers go
    first: an axis that moves from one dim to another (the kv heads' model
    axis to the memory's rows) must join the blocks while every rank still
    holds the same rows of the other dim."""
    moves = [(dim, spec_axes(a), spec_axes(b)) for dim, (a, b) in enumerate(zip(src, dst))]
    for dim, a, b in moves:
        if a != b and a and b:
            raise ValueError(f"dim {dim}: no move from {a} to {b}")
    for dim, a, b in moves:
        if a and not b:
            x = gather(x, dim, a, ctx)
    for dim, a, b in moves:
        if b and not a:
            x = scatter(x, dim, b, ctx)
    return x


def _pad(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def constrain(x: torch.Tensor, *spec, src=None) -> torch.Tensor:
    """The counterpart of ``with_sharding_constraint`` against the ambient
    mesh, with the reference's divisibility guard: an axis that does not
    divide its dim is dropped.

    On local blocks, ``x`` is moved from its current layout ``src`` (a spec;
    None: ``x`` is in the hinted layout already, as the residual stream is at
    every block boundary) to the hinted one.  Without a context, on a
    mapping of sizes or on global values, ``x`` is returned."""
    ctx = blocks_ctx()
    if ctx is None or src is None:
        return x
    from repro_torch.parallel.sharding import safe_spec
    src = _pad(src, x.ndim)
    shape = [n * axes_size(ctx, e) for n, e in zip(x.shape, src)]
    return relayout(x, src, safe_spec(shape, _pad(spec, x.ndim), ctx.mesh), ctx)


def constrain_batch(x: torch.Tensor, src=None) -> torch.Tensor:
    """Block-boundary activation layout: batch-sharded on dim 0; with
    ``seq_shard_activations`` also sequence-sharded on dim 1 over the model
    axis (for ``ndim >= 3``), which divides the activations a rank keeps
    between blocks by the model axis's size.  ``src``: as :func:`constrain`."""
    ctx = blocks_ctx()
    if ctx is None:
        return x
    spec: list = [tuple(ctx.batch_axes)] + [None] * (x.ndim - 1)
    if ctx.seq_shard_activations and x.ndim >= 3:
        spec[1] = ctx.model_axis
    return constrain(x, *spec, src=src)


def gather_alike(x: torch.Tensor, dim: int, axes, ctx: Optional[MeshCtx] = None
                 ) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` over ``axes`` joined on every rank,
    as :func:`gather`, for a value that every rank of ``axes`` then uses
    alike (a product the rule table leaves whole over them): the gradient
    that comes back is the same on each of those ranks, so the backward cuts
    this rank's block of it without a sum."""
    ctx = ctx or current_ctx()
    axes = live_axes(ctx, axes)
    if not axes:
        return x
    return _GatherAlike.apply(x, dim % x.ndim, axes, ctx)


def tp_input(x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """A block-boundary activation [B, L, D] as the input of the products
    of a tensor-parallel region: with ``seq_shard_activations`` the
    sequence gathered over the model axis, else the block itself.  With
    ``split`` (the rule table splits the region over the model axis: its
    column-parallel products take the rank's columns) each rank's input
    gradient is its partial: the gather's backward is a reduce-scatter, and
    without the gather :func:`replicate` sums it.  Without (the rule
    table's guard leaves the region whole) every model rank computes the
    same whole product and holds the same gradient: :func:`gather_alike`,
    or nothing.  Identity unless on local blocks."""
    ctx = blocks_ctx()
    if ctx is None:
        return x
    if ctx.seq_shard_activations:
        return (gather if split else gather_alike)(x, 1, ctx.model_axis, ctx)
    return replicate(x, ctx.model_axis, ctx) if split else x


def tp_output(z: torch.Tensor, split: bool = True) -> torch.Tensor:
    """A tensor-parallel region's output [B, L, D] back to the block
    boundary's layout: where the region is ``split`` the row-parallel
    product's partial sum is summed over the model axis (whole, it is the
    output already), and with ``seq_shard_activations`` it is cut to this
    rank's sequence block (after the sum, a reduce-scatter).  Identity
    unless on local blocks."""
    ctx = blocks_ctx()
    if ctx is None:
        return z
    if split:
        z = reduce(z, ctx.model_axis, ctx)
    if ctx.seq_shard_activations:
        return scatter(z, 1, ctx.model_axis, ctx)
    return z
