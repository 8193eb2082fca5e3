"""Seeded weights, made on the device in a few large generator calls.

The benchmark owns the numbers: one ``normal_`` pass and one ``uniform_``
pass over flat fp32 buffers from a generator on the card (in chunks of at
most 2**30 elements), each leaf a view of its buffer scaled in place.  The
tree's layout (names, shapes) is the port's, read from its parameter shapes;
the same seed gives the same tensors, so the reference gets the very
numbers the port served or trained from.

Each leaf is drawn by its name: products ``N(0, 1/d_in)``, the embedding
``N(0, 0.02²)``, norm scales (applied as ``1 + scale``) and biases small
and nonzero, so that a fault in them shows; Mamba2's ``A_log`` as
``log U(1, 16)``, ``dt_bias`` as the inverse softplus of ``exp U(log 1e-3,
log 1e-1)`` and ``D`` as ``U(0.5, 1.5)``, the published initialisation's
ranges.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Tuple

import torch

CHUNK = 1 << 30
UNIFORM = {"A_log", "dt_bias", "D"}


def subseed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one stream of draws, from the run's ``--seed``."""
    digest = hashlib.sha256(f"{seed}:{stream}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device: torch.device, seed: int, stream: str, index: int = 0
              ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, stream, index))


def leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in a fixed order: keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _std(name: str, shape: Tuple[int, ...]) -> float:
    if name == "embed":
        return 0.02
    if name.startswith("ln") or name in ("final_norm", "norm"):
        return 0.1
    if name.startswith("conv_") and name.endswith("_w"):
        return 0.25
    if name.startswith("conv_") or name in ("bq", "bk", "bv"):
        return 0.1
    return 1.0 / math.sqrt(shape[-2])


def _uniform(name: str, u: torch.Tensor) -> torch.Tensor:
    if name == "A_log":
        return torch.log(1.0 + 15.0 * u)
    if name == "dt_bias":
        dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u)
        return dt + torch.log(-torch.expm1(-dt))
    return 0.5 + u                                        # D


def _fill(buf: torch.Tensor, gen: torch.Generator, normal: bool) -> None:
    for a in range(0, buf.numel(), CHUNK):
        part = buf[a:a + CHUNK]
        if normal:
            part.normal_(generator=gen)
        else:
            part.uniform_(generator=gen)


def make(shapes: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    """fp32 parameters in ``shapes``' layout (a tree of tensors or meta
    tensors), drawn from ``seed``."""
    items = leaves(shapes)
    n_normal = sum(t.numel() for p, t in items if p[-1] not in UNIFORM)
    n_uniform = sum(t.numel() for p, t in items if p[-1] in UNIFORM)
    normal = torch.empty(n_normal, dtype=torch.float32, device=device)
    uniform = torch.empty(n_uniform, dtype=torch.float32, device=device)
    _fill(normal, generator(device, seed, "weights"), True)
    _fill(uniform, generator(device, seed, "weights-uniform"), False)
    out: Dict[str, Any] = {}
    offs = {True: 0, False: 0}
    for path, t in items:
        name, shape = path[-1], tuple(t.shape)
        is_u = name in UNIFORM
        buf = uniform if is_u else normal
        a = offs[is_u]
        offs[is_u] = a + t.numel()
        view = buf[a:a + t.numel()].view(shape)
        leaf = _uniform(name, view) if is_u else view.mul_(_std(name, shape))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = leaf
    return out
