"""Data pre-fetching planner pass (GeoFF-style speculative transfers).

Every cross-cloud edge in the runtime normally pays its full wire time
*after* the upstream stage finishes — serialized onto the critical path.
GeoFF (arXiv 2405.13594) shows federated serverless workflows win big by
pre-fetching function inputs concurrently with upstream compute.  This
module is the *decision* layer of that optimization: given a workflow spec
and (optionally) trace-learned :class:`~repro_torch.core.costmodel.EdgeProfiles`,
it decides per edge whether the transfer can be overlapped and annotates
the compiled sub-graph with prefetch directives.

An edge qualifies when its payload is **early-bound** and **predictable**:

* *early-bound* — the consumer's input is a datastore read of a key that
  exists (and is immutable — §4.1 conditional creates) before the consumer
  is even invoked: grouped transfers (Parallel / Map / FanIn always move
  data through the majority-rule datastore) and sequence/choice edges that
  are indirect (explicit ``TransferByDs`` or a payload over the async
  quota, the ByGet path).  Direct (ByPayload) edges ride the invoke body
  itself and cannot be pushed ahead; ByBatch accumulates across workflow
  instances, so its membership is not knowable in advance.
* *predictable* — the producer's output size is known with confidence:
  a static ``Workload.out_bytes`` hint (optionally with a declared
  ``out_bytes_std``), or a learned :class:`NodeProfile` whose coefficient
  of variation (std/mean) stays under ``max_cv``.  Speculating on a
  high-variance size risks pushing the wrong byte count — the residual
  fallback keeps that *correct*, but not *fast*, so the planner simply
  declines.  Values under ``min_bytes`` are also declined: their wire time
  is smaller than the push's own bookkeeping.

The *mechanism* lives in the backends (the ``prefetch`` capability,
:class:`repro_torch.backends.shim.Prefetch`): SimCloud opens a real flow through
the contention-aware topology, the local runner pushes on worker threads.
:func:`annotate_views` arms the compiled views; the orchestrator then
yields ``Prefetch`` right after the producing checkpoint commits.  The
placement planner prices the same decisions analytically
(``plan_workflow(prefetch=True)``) so placement and prefetch are
co-optimized, not bolted together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim

# Confidence gate: decline speculation when the predicted size's coefficient
# of variation (std / mean) exceeds this — a mis-predicted push is only a
# residual-fallback away from correct, but it wasted bandwidth and fooled
# the placement model.
DEFAULT_MAX_CV = 0.5
# Floor under which a push cannot beat its own cost (mirrors
# traffic.DriftThresholds.min_out_bytes: wire time of smaller values rounds
# to nothing, even on a contended 0.1 Gbit/s flow).
DEFAULT_MIN_BYTES = 16_384

# Invocation-mode names, mirrored from core.subgraph (stable string contract
# — importing subgraph here would be circular through placement).
_GROUPED = ("Parallel", "Map", "FanIn")
_INDIRECT_CAPABLE = ("Sequence", "Choice")


@dataclass(frozen=True)
class PrefetchDecision:
    """Outcome of the planner pass for one edge ``src -> dst``."""

    src: str
    dst: str
    enabled: bool
    nbytes: int           # predicted wire size of the pushed value
    std: float            # prediction uncertainty (std-dev, bytes)
    reason: str           # human-readable why (for reports and tests)


def predict_out_bytes(spec: Any, name: str,
                      profiles: Any = None) -> Optional[Tuple[int, float]]:
    """(predicted bytes, std) of node ``name``'s output, or ``None`` when
    nothing predicts it.  Trace-learned profiles win over static hints
    (the pilot-run loop); a bare static hint counts as exact (std 0)
    unless the workload declares ``out_bytes_std``."""
    if profiles is not None:
        nb = profiles.out_bytes(name)
        if nb is not None:
            return int(nb), float(profiles.out_bytes_std(name) or 0.0)
    w = spec.functions[name].workload
    nb = getattr(w, "out_bytes", None)
    if nb is None:
        return None
    std = getattr(w, "out_bytes_std", None)
    return int(nb), float(std or 0.0)


def is_early_bound(mode: str, transfer_by_ds: Optional[bool],
                   nbytes: int, quota: int) -> bool:
    """True iff an edge of ``mode`` moving ``nbytes`` is an indirect
    (datastore-mediated) transfer whose key is derivable before the
    consumer runs — the precondition for pushing it ahead of demand."""
    if mode in _GROUPED:
        return True
    if mode not in _INDIRECT_CAPABLE:
        return False            # ByBatch / ByRedundant / Cycle: declined
    if transfer_by_ds is not None:
        return bool(transfer_by_ds)
    return nbytes > quota       # the runtime's ByGet auto-switch


def decide_edge(spec: Any, src: str, dst: str, mode: str,
                transfer_by_ds: Optional[bool], quota: int, *,
                profiles: Any = None, max_cv: float = DEFAULT_MAX_CV,
                min_bytes: int = DEFAULT_MIN_BYTES,
                ds_cloud: Optional[str] = None,
                dst_cloud: Optional[str] = None) -> PrefetchDecision:
    """The shared per-edge decision — used by :func:`annotate_views` (the
    runtime directives) *and* ``placement._Planner`` (the analytic cost),
    so the two can never diverge.

    ``ds_cloud`` / ``dst_cloud``: where the indirect-transfer store and the
    consumer live.  When both are known and equal there is no cross-cloud
    read leg to hide (the majority-rule §4.3.1 placement co-locates the
    store with the consumer side whenever it can — the wire cost is then
    on the producer's *write*, which already happens at the earliest
    possible moment) and the edge is declined."""
    pred = predict_out_bytes(spec, src, profiles)
    if pred is None:
        return PrefetchDecision(src, dst, False, 0, 0.0, "unpredictable size")
    nbytes, std = pred
    if not is_early_bound(mode, transfer_by_ds, nbytes, quota):
        return PrefetchDecision(src, dst, False, nbytes, std,
                                f"not early-bound ({mode}/direct)")
    if ds_cloud is not None and dst_cloud is not None and ds_cloud == dst_cloud:
        return PrefetchDecision(src, dst, False, nbytes, std,
                                "store co-located with consumer (no read leg)")
    if nbytes < min_bytes:
        return PrefetchDecision(src, dst, False, nbytes, std,
                                f"too small ({nbytes}B < {min_bytes}B)")
    if nbytes > 0 and std / nbytes > max_cv:
        return PrefetchDecision(
            src, dst, False, nbytes, std,
            f"low confidence (cv {std / nbytes:.2f} > {max_cv})")
    return PrefetchDecision(src, dst, True, nbytes, std, "overlap")


def plan_prefetch(spec: Any, *, profiles: Any = None,
                  quotas: Optional[Mapping[str, int]] = None,
                  max_cv: float = DEFAULT_MAX_CV,
                  min_bytes: int = DEFAULT_MIN_BYTES
                  ) -> Dict[Tuple[str, str], PrefetchDecision]:
    """Run the planner pass over every forward edge of ``spec``.

    ``quotas`` maps cloud -> async payload quota (defaults to the
    calibration table) — it decides which sequence edges auto-switch to
    ByGet.  Returns ``{(src, dst): PrefetchDecision}``; feed the result to
    a report, or let :func:`annotate_views` arm compiled views directly.
    """
    q = dict(quotas or cal.PAYLOAD_QUOTA)
    out: Dict[Tuple[str, str], PrefetchDecision] = {}
    for e in spec.edges:
        if getattr(e, "back_edge", False):
            continue
        dst = spec.functions[e.dst]
        quota = q.get(shim.cloud_of(dst.faas), cal.DEFAULT_PAYLOAD_QUOTA)
        out[(e.src, e.dst)] = decide_edge(
            spec, e.src, e.dst, e.mode, e.transfer_by_ds, quota,
            profiles=profiles, max_cv=max_cv, min_bytes=min_bytes)
    return out


def annotate_views(views: Mapping[str, Any], spec: Any, *,
                   profiles: Any = None, max_cv: float = DEFAULT_MAX_CV,
                   min_bytes: int = DEFAULT_MIN_BYTES) -> int:
    """Arm compiled :class:`~repro_torch.core.subgraph.NodeView`s with prefetch
    directives (``NextFunctionInfo.prefetch_bytes`` /
    ``FanInInfo.prefetch_bytes``).  Only edges the planner pass enables are
    armed; everything else keeps the inert default (0), so the orchestrator
    never yields a :class:`~repro_torch.backends.shim.Prefetch` for them.
    Returns the number of directives armed."""
    armed = 0
    for name, view in views.items():
        for info in view.next_funcs:
            if info.back_edge:
                continue
            d = decide_edge(spec, name, info.name, info.mode,
                            info.transfer_by_ds, info.quota,
                            profiles=profiles, max_cv=max_cv,
                            min_bytes=min_bytes,
                            ds_cloud=shim.cloud_of(info.ds) if info.ds else None,
                            dst_cloud=shim.cloud_of(info.faas))
            if d.enabled:
                info.prefetch_bytes = d.nbytes
                armed += 1
        fi = view.fanin
        if fi is not None:
            d = decide_edge(spec, name, fi.agg_name, "FanIn", None,
                            fi.quota, profiles=profiles, max_cv=max_cv,
                            min_bytes=min_bytes,
                            ds_cloud=shim.cloud_of(fi.ds),
                            dst_cloud=shim.cloud_of(fi.agg_faas))
            if d.enabled:
                fi.prefetch_bytes = d.nbytes
                armed += 1
    return armed
