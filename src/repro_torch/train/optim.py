"""AdamW with global-norm clipping, on nested dicts of tensors.

The port of :mod:`repro.train.optim`: m and v mirror the parameter tree in
fp32, b2 is 0.95, eps is added after the square root, bias correction uses
step + 1, and weight decay applies only to leaves with ``ndim >= 2`` (the
stacked ``[G, d]`` norm scales included, as in the reference).  Plain
functions under ``torch.no_grad``, not ``torch.optim``: its AdamW puts eps
and the decay elsewhere.  Each returns new trees and leaves its inputs as
they were, as the reference's pure functions do.  On a rank's blocks of a
sharded tree AdamW is the same elementwise update; only the global norm
sums over the ranks.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.parallel.mesh_ctx import all_reduce_axes, spec_axes

_F32 = torch.float32


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


@torch.no_grad()
def global_norm(tree, specs=None, ctx=None) -> torch.Tensor:
    """The L2 norm over every leaf.  With ``specs`` (a tree of specs
    matching ``tree``, whose leaves are this rank's blocks on ``ctx``'s
    mesh) the norm of the global tree: each leaf's sum of squares is summed
    over exactly the axes its spec shards it on, so a leaf replicated along
    an axis counts once; leaves sharded alike share one all-reduce."""
    sq = lambda x: torch.sum(torch.square(x.to(_F32)))  # noqa: E731
    if specs is None:
        return torch.sqrt(sum(sq(x) for x in tree_leaves(tree)))
    names = ctx.all_axes
    by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        axes = tuple(a for a in names if any(a in spec_axes(e) for e in spec))
        by_axes[axes] = by_axes[axes] + sq(x) if axes in by_axes else sq(x)
    for axes, s in by_axes.items():
        all_reduce_axes(s, axes, ctx)
    return torch.sqrt(sum(by_axes.values()))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, specs=None, ctx=None
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` so that their global norm is at most ``max_norm``;
    ``specs``/``ctx`` as :func:`global_norm`."""
    gnorm = global_norm(grads, specs, ctx)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, opt, step: torch.Tensor, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step. ``step`` is the 0-based step counter (a 0-d int
    tensor; bias correction uses step+1).  Returns (new_params, new_opt)."""
    t = (step + 1).to(_F32)
    c1 = 1.0 - torch.pow(torch.full((), b1, dtype=_F32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.full((), b2, dtype=_F32, device=t.device), t)

    def upd(p, g, m, v):
        g = g.to(_F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay and p.dim() >= 2:           # no decay on norms/scalars
            step_ = step_ + weight_decay * p.to(_F32)
        return (p.to(_F32) - lr * step_).to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt["m"], opt["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2)}


def cosine_lr(step: torch.Tensor, *, base_lr: float, warmup: int, total: int,
              min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay (the standard pretraining schedule)."""
    step = step.to(_F32)
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, base_lr * cos)
