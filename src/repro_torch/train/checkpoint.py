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
leaf as a DTensor.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.parallel.mesh_ctx import current_ctx
from repro_torch.parallel.sharding import local_slices, placements

_SEP = "§"


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        flat: Dict[str, np.ndarray] = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix else str(k)))
        return flat
    t = tree.detach().cpu()
    return {prefix: (t.float() if t.dtype == torch.bfloat16 else t).numpy()}


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
    """Atomically write ``<dir>/ckpt_<step>.npz``; prune to ``keep`` newest."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(state)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
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
