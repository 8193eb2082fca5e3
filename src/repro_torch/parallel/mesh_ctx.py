"""Mesh context: which mesh and axes the model code runs under.

The port of :mod:`repro.parallel.mesh_ctx`.  Model code (attention, moe)
is mesh-agnostic; where a distribution decision matters (the
expert-parallel MoE, the sequence-sharded decode) it consults the ambient
:class:`MeshCtx`.  Smoke tests and the plain oracles run with no context
set, and every mesh-aware branch is then the plain single-process code.

Execution model.  Each rank is one process holding the global value of
every plain tensor, which is what the reference's jit sees: a global array
whose layout is only a hint.  The reference's two ``shard_map`` bodies
(``moe.apply_ep`` and ``attention._decode_seqshard``) are plain functions
on the rank's own block, taken by its mesh coordinate, that combine with
:func:`all_reduce` over the mesh's per-axis process groups and return the
global result on every rank, as ``shard_map``'s ``out_specs`` do.  There
is no ``shard_map`` here, and no layout hint (the reference's
``constrain``): the port places no activation as a DTensor, so a hint
would change nothing.  Only a decode cache is placed as DTensors
(:func:`repro_torch.parallel.sharding.distribute_tree`).  The collectives
are not differentiable: the distributed branches serve, they do not train.

``MeshCtx.mesh`` is a :class:`~torch.distributed.device_mesh.DeviceMesh`
or, for the rule table alone, a mapping from axis name to size: a rule
needs only the sizes, and no distributed branch runs under such a context.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

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
    ``shard_kv_seq`` — flash-decoding: a decode cache placed as DTensors with
    its slot dim over the model axis decodes through
    ``attention._decode_seqshard``.
    """

    mesh: Any
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ("data",)
    shard_kv_seq: bool = False

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


def is_distributed(x: Any) -> bool:
    """Whether ``x`` is a ``DTensor`` (a tensor placed on a mesh)."""
    return isinstance(x, DTensor)


# ==========================================================================
# Collectives
# ==========================================================================

#: the collectives of the distributed branches since the last
#: :func:`reset_collective_stats`: calls, and host seconds when ``timed``
collective_stats: Dict[str, Any] = {"calls": 0, "seconds": 0.0, "timed": False}


def reset_collective_stats(*, timed: bool = False) -> None:
    """Zero the counts.  With ``timed`` every collective is timed on the
    host clock, after a synchronise of the card so that the time is the
    collective's own (this serialises the card's work with the host)."""
    collective_stats.update(calls=0, seconds=0.0, timed=timed)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group`` (``op`` "sum" or "max").
    Uses only ``all_reduce``, which gloo implements for CUDA tensors as
    well as CPU ones.  Autograd does not see it, so a tensor that would
    carry a gradient is refused: the reference's psum is differentiable,
    this is not."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "the distributed branches (moe.apply_ep, attention._decode_seqshard) do not "
            "differentiate their all-reduces: run them under torch.no_grad(), or "
            "without a mesh context")
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    collective_stats["calls"] += 1
    if not collective_stats["timed"]:
        dist.all_reduce(x, op=red, group=group)
        return x
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    dist.all_reduce(x, op=red, group=group)
    collective_stats["seconds"] += time.perf_counter() - t0
    return x


def gather_dim0(local: torch.Tensor, n: int, ctx: MeshCtx, entry) -> torch.Tensor:
    """The global ``[n, ...]`` tensor whose dim-0 blocks over the axes of the
    spec entry ``entry`` are each rank's ``local``, on every rank: a
    zero-filled global buffer with the rank's block written in, summed over
    each axis's group in turn (``all_reduce`` only; adding zeros is exact).
    ``entry`` None: dim 0 is not sharded and ``local`` is already global."""
    axes = spec_axes(entry)
    if not axes:
        return local
    rows = local.shape[0]
    i = ctx.linear_coord(axes)
    full = local.new_zeros((n,) + tuple(local.shape[1:]))
    full[i * rows:(i + 1) * rows] = local
    for a in axes:
        all_reduce(full, ctx.group(a))
    return full
