"""Checkpointing: atomic, restartable, in the reference's format.

The port of :mod:`repro.train.checkpoint`: one ``.npz`` per checkpoint,
``<dir>/ckpt_<step:08d>.npz``, whose keys are the tree's paths joined with
``§`` in the order JAX flattens a dict (sorted keys), e.g.
``opt§m§blocks§s0§attn§wq``; ``step`` is a 0-d int32.  Written to a temp file
and renamed into place, so a torn write is never mistaken for a checkpoint
(the commit protocol of :mod:`repro_torch.train.commit` relies on it).  A
checkpoint written by either package restores with the other's ``restore``.

numpy has no bfloat16, so a bf16 leaf is written as fp32; :func:`restore`
casts every leaf to its template's dtype.  With ``shardings`` it restores
onto a mesh, possibly another than the one that saved it (the elastic
failover path): every rank reads the file and keeps its own block of each
leaf as a DTensor.  :func:`save` of a state of DTensors (the sharded train
step's) writes the same file as an unsharded save, so either package
restores it sharded or whole: it joins each leaf a piece of whole dim-0
rows at a time (:data:`SAVE_PIECE_BYTES`) into one buffer that the whole
save reuses, so no rank ever holds a leaf's global value, let alone the
state's, and rank 0 streams each piece into the file as it comes.
"""

from __future__ import annotations

import math
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.parallel.mesh_ctx import current_ctx, is_distributed
from repro_torch.parallel.sharding import gather_rows, local_slices, placements

_SEP = "§"

#: the most bytes of a DTensor leaf's global value that :func:`save` joins
#: on a rank at once: a piece of whole dim-0 rows, at least one row
SAVE_PIECE_BYTES = 256 << 20


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, leaf) in the file's order: the paths joined with ``§``, dict
    keys sorted, as JAX flattens a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{_SEP}{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _piece_rows(t: torch.Tensor) -> int:
    """The dim-0 rows of a piece of the DTensor leaf ``t``: at most
    :data:`SAVE_PIECE_BYTES`, at least one row."""
    return max(1, SAVE_PIECE_BYTES // max(1, math.prod(t.shape[1:]) * t.element_size()))


def _piece_buffer(state) -> Optional[torch.Tensor]:
    """The one buffer of bytes that a sharded save joins every piece into:
    as large as its largest piece, on the leaves' device; None without a
    DTensor leaf of rows."""
    sizes = [min(_piece_rows(t), t.shape[0]) * math.prod(t.shape[1:]) * t.element_size()
             for _, t in _leaves(state) if is_distributed(t) and t.ndim]
    if not sizes:
        return None
    device = next(t.to_local().device for t in tree_leaves(state) if is_distributed(t))
    return torch.empty(max(sizes), dtype=torch.uint8, device=device)


def _pieces(t: torch.Tensor, buffer: Optional[torch.Tensor] = None) -> Iterator[np.ndarray]:
    """The global value of leaf ``t`` on the host, in order: a plain tensor
    whole, a DTensor in pieces of whole dim-0 rows (:func:`_piece_rows`),
    each joined on every rank (:func:`~repro_torch.parallel.sharding.gather_rows`)
    into ``buffer`` (:func:`_piece_buffer`).  A piece is valid until the
    next is asked for: the save writes each before it joins the next, so it
    allocates one piece's bytes, however late gloo's worker thread lets go
    of the pieces it reduced.  A bf16 leaf comes out as fp32 (numpy has no
    bfloat16)."""
    if not is_distributed(t) or t.ndim == 0:
        pieces = iter([gather_rows(t) if is_distributed(t) else t])
    else:
        n, rows = t.shape[0], _piece_rows(t)

        def piece(r):
            shape = (min(r + rows, n) - r,) + tuple(t.shape[1:])
            out = buffer[:math.prod(shape) * t.element_size()].view(t.dtype).view(shape)
            return gather_rows(t, r, r + shape[0], out=out)

        pieces = (piece(r) for r in range(0, max(n, 1), rows))
    for p in pieces:
        p = p.detach().cpu()
        yield (p.float() if p.dtype == torch.bfloat16 else p).numpy()


def _unflatten(template, flat: Dict[str, np.ndarray], device: torch.device, prefix: str = "",
               specs=None, ctx=None):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, device, f"{prefix}{_SEP}{k}" if prefix else str(k),
                              None if specs is None else specs[k], ctx)
                for k, v in template.items()}
    a = flat[prefix]
    if tuple(a.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {prefix} has shape {a.shape}, template "
                         f"{tuple(template.shape)}")
    if specs is None:
        return torch.from_numpy(np.array(a)).to(device=device, dtype=template.dtype)
    local = torch.from_numpy(np.array(a[local_slices(a.shape, specs, ctx)]))
    return DTensor.from_local(local.to(device=device, dtype=template.dtype), ctx.mesh,
                              placements(specs, ctx.mesh), run_check=False)


def save(state, directory: str, step: int, *, keep: int = 3) -> str:
    """Atomically write ``<dir>/ckpt_<step>.npz``; prune to ``keep`` newest.

    A state with DTensor leaves is a collective: every rank calls ``save``,
    each leaf is joined a piece at a time (:func:`_pieces`), rank 0 writes,
    and every rank returns once the file is in place."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if not any(is_distributed(t) for t in tree_leaves(state)):
        return _write(state, directory, path, keep)
    buffer = _piece_buffer(state)
    if dist.get_rank() == 0:
        _write(state, directory, path, keep, buffer)
    else:
        for _, t in _leaves(state):
            for _ in _pieces(t, buffer):
                pass
    dist.barrier()
    return path


def _write(state, directory: str, path: str, keep: int,
           buffer: Optional[torch.Tensor] = None) -> str:
    """Write ``state`` as ``np.savez`` does (one ``<key>.npy`` member a leaf
    in an uncompressed zip), a leaf's pieces (joined into ``buffer``)
    streamed into its member."""
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f, zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                                                   allowZip64=True) as zf:
        for key, t in _leaves(state):
            with zf.open(key + ".npy", "w", force_zip64=True) as member:
                for i, a in enumerate(_pieces(t, buffer)):
                    if i == 0:
                        np.lib.format.write_array_header_1_0(member, {
                            "descr": np.lib.format.dtype_to_descr(a.dtype),
                            "fortran_order": False, "shape": tuple(t.shape)})
                    member.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    os.replace(tmp, path)
    for old in all_steps(directory)[:-keep]:
        os.remove(os.path.join(directory, f"ckpt_{old:08d}.npz"))
    return path


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(template, directory: str, *, step: Optional[int] = None, device="cuda",
            shardings=None, ctx=None) -> Any:
    """Load a checkpoint into the template's structure and dtypes (a tree of
    tensors, e.g. :func:`repro_torch.train.step.train_state_shapes` on the
    ``meta`` device) on ``device``.

    ``shardings`` (a tree of specs matching the template, e.g.
    :func:`repro_torch.parallel.sharding.param_shardings` of it) restores
    onto ``ctx``'s mesh (default: the ambient context): each leaf becomes a
    DTensor of which this rank holds its own block, sliced from the file
    with no collective.
    """
    dev = resolve_device(device)
    if shardings is not None:
        ctx = ctx or current_ctx()
        if ctx is None:
            raise ValueError("restore(shardings=...) needs a mesh context")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(template, flat, dev, specs=shardings, ctx=ctx)
