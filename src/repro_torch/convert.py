"""Parameter-tree conversion between the JAX package and the port.

Both packages hold parameters as nested dicts with the same keys and shapes,
so conversion is a tree map by path.  Leaves cross as numpy arrays (a JAX
array converts with ``np.asarray`` on the caller's side; this module never
imports JAX).  numpy has no bfloat16 of its own, so bf16 goes through fp32 in
both directions: a bf16 leaf arrives as fp32 numpy and is cast back on the
receiving side.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":              # ml_dtypes bf16 from JAX
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy: JAX's are read-only
    return t.to(device)


def to_torch(tree: Any, *, device="cuda") -> Any:
    """numpy/JAX-array tree → torch tensor tree on ``device`` (same keys and dtypes)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device=dev) for v in tree)
    return _leaf_to_torch(tree, dev)


def to_numpy(tree: Any) -> Any:
    """torch tensor tree → numpy tree on the host (same keys).

    bf16 leaves come back as fp32 arrays; the JAX side casts them with
    ``.astype(jnp.bfloat16)`` where it needs the narrow type.
    """
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a tree to ``device`` (e.g. CPU weights → card)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
