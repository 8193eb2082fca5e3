"""Meshes and the ranks that form them.

The port of :mod:`repro.launch.mesh` on ``torch.distributed``.  A mesh is
a ``DeviceMesh`` with named dims over the ranks of the default process
group, which :func:`init_ranks` starts (each rank is one process; nothing
on the machine tells a program of a cluster, so the caller gives the
rendezvous, the world size and the rank).  Importing this module starts
nothing.

Like every entry point of the port, these default to ``device_type="cuda"``
and raise without a card unless given ``"cpu"``.  The default backend is
gloo: it runs on CPU and CUDA tensors alike, and several ranks may share
one card (NCCL refuses two ranks on one device).  The distributed branches
use only its ``all_reduce``.

:func:`traced_mesh` is the dry run's mesh: one rank of a mesh of any size
over torch's fake process group, whose collectives return at once and move
nothing (``repro_torch.launch.dryrun`` traces that rank's step on fake
tensors).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device
from repro_torch.parallel.mesh_ctx import MeshCtx, mesh_shape


def init_ranks(rank: int, world_size: int, init_method: str, *,
               device_type: str = "cuda", backend: str = "gloo") -> None:
    """Start this process's rank of the default process group.

    ``init_method`` is a rendezvous URL (``tcp://localhost:<port>`` or
    ``file://<path>``).  On the card, rank r selects card
    ``r % device_count()`` before the group forms, so that ranks share the
    cards round-robin.
    """
    dev = resolve_device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group's ranks (:func:`init_ranks` first); its per-axis
    groups take the default group's backend."""
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call init_ranks first")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``, over the
    default group's ranks, which must be that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    if dist.is_initialized() and dist.get_world_size() != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; the default "
                         f"process group has {dist.get_world_size()}")
    return make_mesh(shape, axes, device_type=device_type)


def make_ctx(mesh, *, fsdp_over_pod: bool = False, **knobs) -> MeshCtx:
    """MeshCtx with the batch and FSDP axes derived from the mesh's axis
    names (``mesh`` a ``DeviceMesh`` or a mapping of axis sizes): the batch
    over ``pod`` and ``data``, parameters FSDP-sharded over ``data``, or
    over the batch axes with ``fsdp_over_pod`` on a mesh with a ``pod``
    axis."""
    names = tuple(mesh_shape(mesh))
    batch = tuple(a for a in names if a in ("pod", "data"))
    fsdp = batch if (fsdp_over_pod and "pod" in names) else ("data",)
    return MeshCtx(mesh, batch_axes=batch, fsdp_axes=fsdp, **knobs)



@contextlib.contextmanager
def traced_mesh(sizes: Dict[str, int]) -> Iterator[DeviceMesh]:
    """A ``DeviceMesh`` of ``sizes`` (axis name → size, major first) in
    which this process is rank 0, over a fake process group of the mesh's
    world size (torch's ``fake`` backend): every collective returns at once
    and moves no data, so one process can trace one rank of a 16x16 or
    2x16x16 mesh.

    The group is this process's default group for the length of the block
    and is destroyed on leaving it.  A process that already has a default
    group is refused: its ranks would meet fakes.  The mesh's device type
    is ``cuda`` where torch is built with CUDA, else ``cpu``; the fake group
    moves nothing on either."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists: a traced mesh needs a process "
                           "with none")
    from torch.testing._internal.distributed.fake_pg import FakeStore   # registers "fake"
    shape = tuple(sizes.values())
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield init_device_mesh("cuda" if torch.backends.cuda.is_built() else "cpu", shape,
                               mesh_dim_names=tuple(sizes))
    finally:
        dist.destroy_process_group()
