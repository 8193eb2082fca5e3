"""The numbers that decide ``correct``: how far what the timed path produced
lies from the plain reference.

Serving (per checked request): ``token_gap``, by how much the served
token's logit lies below the reference's best, in logits; ``logits_err``
and ``cache_err``, the relative error ‖program − reference‖ / ‖reference‖
of the last position's logits and of each layer's cache leaf.

Training: ``loss_gap``, the widest gap between the program's and the
reference's loss over the first steps; ``grad_gap`` and ``update_gap``, by
the worst leaf (a layer's slice of a stacked leaf counts as its own leaf),
the gap between the norms of the first step's clipped gradient, and of the
parameters' change over the first steps, each over the reference's norm of
that leaf or the median leaf's, whichever is larger; ``grad_gap_median``,
the same gap of the first step's gradient at the median leaf, which the
noise of one small leaf does not move.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of both: AdamW moves them by round-off alone.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Tuple

import torch

EXCLUDE_BELOW = 1e-3


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float(torch.linalg.vector_norm(got.double() - ref)
                 / torch.linalg.vector_norm(ref).clamp(min=1e-300))


def token_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """max over rows of ref.max() − ref[served]; ref [B, V], served [B]."""
    ref = ref_logits.double()
    return float((ref.max(-1).values - ref.gather(-1, served.long()[:, None])[:, 0]).max())


def cache_err(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The worst layer's relative error over every cache leaf [layers, ...]."""
    worst = 0.0
    for key, r in ref.items():
        g = got[key]
        if g.shape != r.shape:
            return float("inf")
        for layer in range(r.shape[0]):
            worst = max(worst, rel_err(g[layer], r[layer]))
    return worst


def slices(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterable[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, a stacked block leaf by its layers."""
    for k in sorted(tree):
        v, path = tree[k], prefix + (k,)
        if isinstance(v, dict):
            yield from slices(v, path)
        elif path[0] == "blocks":
            for g in range(v.shape[0]):
                yield f"{'/'.join(path)}[{g}]", v[g]
        else:
            yield "/".join(path), v


def norms(tree: Dict) -> Dict[str, float]:
    return {name: float(torch.linalg.vector_norm(t.double())) for name, t in slices(tree)}


def diff_norms(after: Dict, before: Dict) -> Dict[str, float]:
    b = dict(slices(before))
    return {name: float(torch.linalg.vector_norm(t.double() - b[name].double()))
            for name, t in slices(after)}


def kept_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= EXCLUDE_BELOW * med]


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> Dict[str, float]:
    """|got − ref| / max(ref, the median of ref) for each leaf of ``keep``."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in keep}


def leaf_gap(got: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(got, ref, keep).values())


def median_leaf_gap(got: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    """The median leaf's gap (:func:`leaf_gaps`)."""
    return statistics.median(leaf_gaps(got, ref, keep).values())


def worst_leaf(got: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> str:
    """The leaf that sets :func:`leaf_gap`."""
    gaps = leaf_gaps(got, ref, keep)
    return max(gaps, key=gaps.get)
