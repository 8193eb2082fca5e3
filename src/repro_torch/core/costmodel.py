"""Unified N-cloud topology & cost model — the single source of truth for
how the repo reasons about the jointcloud substrate.

Both consumers of inter-cloud latency/bandwidth/egress arithmetic live on
top of this module:

  * :mod:`repro_torch.backends.simcloud` — the discrete-event interpreter charges
    wire time and egress through :class:`CostModel`;
  * :mod:`repro_torch.core.placement` — the DAG planner evaluates candidate
    assignments with the *same* :class:`CostModel`, so predicted makespans
    are comparable to simulated timelines by construction.

Paper-symbol mapping (Figs 11 & 16, §4.3, §5.3–5.4)
---------------------------------------------------
=====================  =====================================================
Field / method          Paper quantity
=====================  =====================================================
``Topology.rtt_ms``     inter-cloud round-trip latency: the per-hop term of
                        Fig 11's indirect-transfer cost (both datastore legs)
                        and the cross-cloud invocation term of the ≈78 ms
                        failover overhead (§5.3, Fig 10).
``Topology.bandwidth``  per-flow cross-cloud throughput in **Gbit/s** — the
                        slope of the payload-size term in Fig 11 (left);
                        note the explicit ×8 byte→bit conversion in
                        :meth:`CostModel.wire_ms`.
``egress_price``        $/GB leaving a cloud — the "egress" bar of Fig 16's
                        cost decomposition and the Fig 11 (right) minority
                        penalty of the majority-rule datastore placement.
``invoke_price``        per-request charge (Fig 16 "invocation").
``table prices``        checkpoint W/R tariffs (§5.4, Fig 16 "datastore").
``hop_overhead_ms``     queue dwell + control-plane accept + wrapper
                        bookkeeping + the two §4.1 checkpoint writes that
                        ride every hop (Fig 20's non-user phases).
``fanout_stagger_ms``   §4.1.2 grouped invocation: fan-outs are issued in
                        ``FANOUT_CHUNK``-sized waves, each wave paying one
                        parallel-invoke + checkpoint-append round (Fig 8).
=====================  =====================================================

Unit discipline: ``BANDWIDTH`` values are **Gbit/s**; all ``*_ms`` values
are milliseconds of virtual clock; every byte→ms conversion happens in
:meth:`CostModel.wire_ms` (nowhere else), which multiplies by 8 to convert
bytes to bits.  The pre-refactor code divided bytes by ``Gbit/s × 1e9``,
silently treating Gbit/s as GByte/s — an 8× undercount of wire time.

:class:`EdgeProfiles` closes the trace-feedback loop: it learns per-node
output sizes, reference compute and Map widths from completed SimCloud
executions, replacing the static ``out_bytes`` hints after a pilot run
(GeoFF-style measured transfer profiles, arXiv 2405.13594).
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim


def _pair(a: str, b: str) -> Tuple[str, str]:
    """Canonical unordered cloud pair (RTT/bandwidth are symmetric)."""
    return (a, b) if a <= b else (b, a)


# ==========================================================================
# Topology — who is where, and what the wires between them look like
# ==========================================================================


@dataclass(frozen=True)
class Topology:
    """N-cloud substrate description: RTT matrix, per-pair bandwidth, tariffs.

    Unknown pairs fall back by region: same region ⇒
    ``INTER_CLOUD_SAME_REGION_RTT_MS``, different ⇒
    ``INTER_CLOUD_CROSS_REGION_RTT_MS`` — so an N≥3 config only needs to
    pin the pairs it has measured.

    Contention (opt-in): ``capacity_table`` / ``default_capacity_gbps`` pin
    an *aggregate* Gbit/s per cloud pair.  The topology then also tracks
    in-flight transfers (``open_flow``/``close_flow``, driven by SimCloud)
    and :meth:`contention_factor` reports how much concurrent demand
    oversubscribes the pipe — :meth:`CostModel.wire_ms` stretches by that
    factor, so heavy traffic visibly lengthens transfer tails.  With no
    capacity pinned (the default), the factor is always 1.0 and nothing is
    tracked, which keeps single-workflow timelines bit-identical.
    """

    clouds: Tuple[str, ...]
    regions: Mapping[str, str] = field(default_factory=dict)
    rtt_table: Mapping[Tuple[str, str], float] = field(default_factory=dict)
    bandwidth_table: Mapping[Tuple[str, str], float] = field(default_factory=dict)
    egress_table: Mapping[str, float] = field(default_factory=dict)
    # per-pair RTT jitter amplitude in ms (uniform [0, amp) on top of the
    # deterministic RTT).  Empty by default: interpreters draw zero extra
    # random numbers and timelines stay bit-identical to previous releases.
    rtt_jitter_table: Mapping[Tuple[str, str], float] = field(default_factory=dict)
    intra_rtt_ms: float = cal.INTRA_CLOUD_RTT_MS
    intra_bandwidth_gbps: float = cal.INTRA_CLOUD_BANDWIDTH_GBPS
    default_bandwidth_gbps: float = cal.BANDWIDTH_GBPS
    default_egress_price: float = cal.EGRESS_PRICE_PER_GB
    capacity_table: Mapping[Tuple[str, str], float] = field(default_factory=dict)
    default_capacity_gbps: Optional[float] = None
    # runtime flow tracking (mutable on purpose: the *description* is frozen,
    # the load on it is not)
    _flows: Dict[Tuple[str, str], int] = field(default_factory=dict,
                                               repr=False, compare=False)
    _flow_bytes: Dict[Tuple[str, str], int] = field(default_factory=dict,
                                                    repr=False, compare=False)

    @classmethod
    def from_config(cls, config: Optional[dict] = None) -> "Topology":
        """Build from a jointcloud config dict (``calibration.*_jointcloud``)."""
        config = config or cal.default_jointcloud()
        clouds = tuple(sorted(config["clouds"]))
        regions = {c: v.get("region", c) for c, v in config["clouds"].items()}
        rtt = {_pair(a, b): float(ms)
               for (a, b), ms in config.get("rtt_ms", {}).items()}
        bw = {_pair(a, b): float(g)
              for (a, b), g in config.get("bandwidth_gbps", {}).items()}
        egress = {c: float(p)
                  for c, p in config.get("egress_price_per_gb", {}).items()}
        jitter = {_pair(a, b): float(ms)
                  for (a, b), ms in config.get("rtt_jitter_ms", {}).items()}
        capacity = {_pair(a, b): float(g)
                    for (a, b), g in config.get("link_capacity_gbps", {}).items()}
        default_cap = config.get("default_link_capacity_gbps")
        return cls(clouds=clouds, regions=regions, rtt_table=rtt,
                   bandwidth_table=bw, egress_table=egress,
                   rtt_jitter_table=jitter,
                   capacity_table=capacity,
                   default_capacity_gbps=(None if default_cap is None
                                          else float(default_cap)))

    # ---- lookups (symmetric, with N≥3 fallback rules) ---------------------

    def rtt_ms(self, a: str, b: str) -> float:
        """Round-trip latency a↔b (symmetric; region-based fallback for
        pairs the config did not pin)."""
        if a == b:
            return self.intra_rtt_ms
        base = self.rtt_table.get(_pair(a, b))
        if base is None:
            base = (cal.INTER_CLOUD_SAME_REGION_RTT_MS
                    if self.regions.get(a, a) == self.regions.get(b, b)
                    else cal.INTER_CLOUD_CROSS_REGION_RTT_MS)
        return base

    def rtt_jitter_ms(self, a: str, b: str) -> float:
        """Jitter amplitude of the a↔b RTT in ms (0.0 for intra-cloud links
        and any pair the config did not pin — jitter is strictly opt-in)."""
        if a == b:
            return 0.0
        return self.rtt_jitter_table.get(_pair(a, b), 0.0)

    def bandwidth_gbps(self, a: str, b: str) -> float:
        """Per-flow a↔b throughput in **Gbit/s** (VPC-class intra-cloud)."""
        if a == b:
            return self.intra_bandwidth_gbps
        return self.bandwidth_table.get(_pair(a, b), self.default_bandwidth_gbps)

    def egress_price_per_gb(self, cloud: str) -> float:
        """$/GB billed for bytes leaving ``cloud``."""
        return self.egress_table.get(cloud, self.default_egress_price)

    # ---- contention-aware bandwidth sharing --------------------------------

    def capacity_gbps(self, a: str, b: str) -> Optional[float]:
        """Aggregate Gbit/s of the a↔b pipe, or None when uncapped.
        Intra-cloud (VPC-class) links are never capped."""
        if a == b:
            return None
        cap = self.capacity_table.get(_pair(a, b))
        return cap if cap is not None else self.default_capacity_gbps

    def tracks_contention(self, a: str, b: str) -> bool:
        """True iff the a↔b pair has an aggregate capacity pinned."""
        return self.capacity_gbps(a, b) is not None

    def open_flow(self, a: str, b: str, nbytes: int = 0) -> None:
        """Record a transfer starting on a↔b (driven by the interpreter)."""
        p = _pair(a, b)
        self._flows[p] = self._flows.get(p, 0) + 1
        self._flow_bytes[p] = self._flow_bytes.get(p, 0) + nbytes

    def close_flow(self, a: str, b: str, nbytes: int = 0) -> None:
        """Record a transfer finishing on a↔b (clamped at zero)."""
        p = _pair(a, b)
        n = self._flows.get(p, 0) - 1
        self._flows[p] = n if n > 0 else 0
        left = self._flow_bytes.get(p, 0) - nbytes
        self._flow_bytes[p] = left if left > 0 else 0

    def concurrent_flows(self, a: str, b: str) -> int:
        """Transfers currently in flight on the a↔b pair."""
        return self._flows.get(_pair(a, b), 0)

    def inflight_bytes(self, a: str, b: str) -> int:
        """Bytes currently on the a↔b wire — a telemetry gauge (load
        dashboards, future byte-weighted sharing / online re-planning);
        :meth:`contention_factor` itself is flow-count-based."""
        return self._flow_bytes.get(_pair(a, b), 0)

    def contention_factor(self, a: str, b: str) -> float:
        """≥1.0 slowdown of a transfer starting now: concurrent per-flow
        demand over the pair's aggregate capacity (fair-share TCP model) —
        1.0 while demand fits the pipe, proportional once it exceeds it."""
        cap = self.capacity_gbps(a, b)
        if cap is None:
            return 1.0
        n = self._flows.get(_pair(a, b), 0)
        if n <= 0:
            return 1.0
        demand = n * self.bandwidth_gbps(a, b)
        return demand / cap if demand > cap else 1.0


# ==========================================================================
# CostModel — every byte→ms / byte→$ conversion, in one place
# ==========================================================================


class CostModel:
    """Transfer latency, hop cost and stage cost over a :class:`Topology`.

    ``rtt_override`` lets callers keep a custom RTT callable (the planner's
    legacy ``rtt_fn`` hook) while still routing bandwidth/egress through the
    shared model.
    """

    def __init__(self, topology: Optional[Topology] = None, *,
                 rtt_override: Optional[Callable[[str, str], float]] = None):
        self.topology = topology or Topology.from_config()
        self._rtt_override = rtt_override
        # wire_ms fast path: an uncontended topology (no capacities pinned)
        # never needs the per-call contention lookup
        self._maybe_contended = bool(self.topology.capacity_table) or \
            self.topology.default_capacity_gbps is not None
        # per-pair memos over the frozen topology (rtt_ms / wire_ms sit on
        # the interpreter's per-event path; the tables never change after
        # construction, so the fallback chain only needs to run once a pair)
        self._rtt_memo: Dict[Tuple[str, str], float] = {}
        self._wire_denom: Dict[Tuple[str, str], float] = {}

    # ---- latency ----------------------------------------------------------

    def rtt_ms(self, a: str, b: str) -> float:
        """a↔b round-trip (the ``rtt_override`` hook wins when given)."""
        if self._rtt_override is not None:
            return self._rtt_override(a, b)
        r = self._rtt_memo.get((a, b))
        if r is None:
            r = self._rtt_memo[(a, b)] = self.topology.rtt_ms(a, b)
        return r

    def sample_rtt_jitter(self, a: str, b: str, u: float) -> float:
        """One network-jitter draw for an a↔b round-trip: amplitude × ``u``,
        with ``u ∈ [0, 1)`` supplied by the *caller's* seeded RNG so the
        sample stays on the interpreter's single deterministic stream.
        0.0 (and no arithmetic) whenever the pair has no amplitude pinned —
        callers gate on ``topology.rtt_jitter_table`` so that the default
        path draws nothing at all and timelines stay bit-identical."""
        amp = self.topology.rtt_jitter_ms(a, b)
        return amp * u if amp else 0.0

    def wire_ms(self, a: str, b: str, nbytes: int) -> float:
        """Serialization time of ``nbytes`` on the a↔b link.

        The only byte→ms conversion in the codebase: bytes ×8 → bits,
        divided by the link's Gbit/s — stretched by the topology's
        :meth:`Topology.contention_factor` when concurrent flows
        oversubscribe a capacity-pinned pair (1.0 on uncapped links and
        whenever nothing else is in flight, e.g. at planning time).

        The stretch is sampled *once, at call time* — i.e. at flow-open in
        SimCloud.  For the short request/response flows of the effect
        interpreter that is accurate to within one flow lifetime; a
        long-lived speculative *prefetch* flow, however, can outlive the
        flows it was priced against, so SimCloud re-prices it once at its
        predicted completion (``_prefetch_close``): if contention worsened
        while it was in flight, the flow is extended by the residual
        stretch (bounded to a single repricing round, so the correction
        never recurses).  Under bursty arrivals this keeps prefetch sweep
        numbers honest instead of optimistic.
        """
        if nbytes <= 0:
            return 0.0
        # denom memo = bandwidth_gbps(a, b) * 1e9, computed once per pair —
        # the expression below is kept in exactly the historical operation
        # order so results are bit-identical (do NOT fold into a single
        # coefficient multiply: that changes the last ulp and flips the
        # pinned timeline digests).
        denom = self._wire_denom.get((a, b))
        if denom is None:
            denom = self._wire_denom[(a, b)] = \
                self.topology.bandwidth_gbps(a, b) * 1e9
        ms = (nbytes * 8 / denom) * 1000.0
        if not self._maybe_contended:
            return ms
        factor = self.topology.contention_factor(a, b)
        return ms * factor if factor != 1.0 else ms

    def transfer_ms(self, a: str, b: str, nbytes: int) -> float:
        """Latency of moving ``nbytes`` between clouds (RTT + wire time)."""
        return self.rtt_ms(a, b) + self.wire_ms(a, b, nbytes)

    # ---- money ------------------------------------------------------------

    def egress_price_per_gb(self, cloud: str) -> float:
        """$/GB leaving ``cloud`` (delegates to the topology's tariffs)."""
        return self.topology.egress_price_per_gb(cloud)

    def egress_usd(self, src: str, dst: str, nbytes: int) -> float:
        """$ billed for ``nbytes`` leaving ``src`` toward ``dst`` (0 if
        intra-cloud — the Fig 11 majority-rule saving)."""
        if src == dst:
            return 0.0
        return (nbytes / 1e9) * self.egress_price_per_gb(src)

    # ---- per-stage compute (Fig 1/2 heterogeneity) -------------------------

    def stage_cost(self, flavor: cal.Flavor, compute_ms: float,
                   fixed_ms: float = 0.0, memory_gb: Optional[float] = None,
                   accel: bool = True) -> Tuple[float, float]:
        """(duration_ms, usd) of one stage execution on ``flavor`` — see
        module-level :func:`stage_cost`."""
        return stage_cost(flavor, compute_ms, fixed_ms, memory_gb, accel)

    # ---- per-hop overheads -------------------------------------------------

    @property
    def hop_overhead_ms(self) -> float:
        """Placement-independent per-hop overhead: queue dwell +
        control-plane accept + wrapper bookkeeping + two §4.1 checkpoint
        writes (keeps planner estimates comparable to SimCloud)."""
        return (cal.ASYNC_QUEUE_MS + cal.INVOKE_API_MS + cal.WRAPPER_CPU_MS
                + 2 * cal.TABLE_WRITE_MS)

    @property
    def fanout_wave_ms(self) -> float:
        """One §4.1.2 invocation wave: a parallel-invoke accept round plus
        the grouped checkpoint append (write + read-back)."""
        return cal.INVOKE_API_MS + cal.TABLE_WRITE_MS + cal.TABLE_READ_MS

    @staticmethod
    def invocation_waves(width: int) -> int:
        """Number of ``FANOUT_CHUNK``-limited waves a fan-out of ``width``
        instances is issued in (Fig 8 grouped checkpointing)."""
        return max(1, math.ceil(max(width, 1) / cal.FANOUT_CHUNK))

    def fanout_stagger_ms(self, width: int) -> float:
        """Extra start delay of the *last* wave of a width-``width`` fan-out
        relative to the first (0 for width ≤ FANOUT_CHUNK)."""
        return (self.invocation_waves(width) - 1) * self.fanout_wave_ms


def stage_cost(flavor: cal.Flavor, compute_ms: float, fixed_ms: float = 0.0,
               memory_gb: Optional[float] = None,
               accel: bool = True) -> Tuple[float, float]:
    """(duration_ms, usd) of running a stage once on ``flavor`` (GB·s model).

    ``accel=False`` marks compute a GPU cannot accelerate: on GPU flavors it
    runs at CPU-reference speed (mirrors ``Workload.duration_ms``).
    """
    speed = 1.0 if (flavor.gpu and not accel) else flavor.speed
    dur = compute_ms / max(speed, 1e-9) + fixed_ms
    mem = memory_gb if memory_gb is not None else flavor.memory_gb
    usd = mem * (dur / 1000.0) * flavor.price_per_gb_s + cal.INVOKE_PRICE
    return dur, usd


# ==========================================================================
# EdgeProfiles — trace-calibrated workload models (the feedback loop)
# ==========================================================================


@dataclass
class NodeProfile:
    """What the traces say about one workflow function."""

    name: str
    out_bytes: int               # mean observed output wire size
    compute_ms: float            # flavor-normalized reference compute
    fixed_ms: float              # non-accelerable part (from the workload)
    accel: bool
    width: int = 1               # max observed Map instances per workflow
    samples: int = 0
    # population std-dev of the observed output sizes — the prefetch
    # planner's prediction-confidence gate (0.0: perfectly predictable,
    # e.g. a single sample or a static hint)
    out_bytes_std: float = 0.0

    @property
    def out_bytes_cv(self) -> float:
        """Coefficient of variation of the output size (std / mean) — the
        dimensionless confidence figure speculation is gated on."""
        return self.out_bytes_std / self.out_bytes if self.out_bytes > 0 else 0.0

    def as_dict(self) -> dict:
        """JSON-ready form (rounded; see ``EdgeProfiles.as_dict``)."""
        return {"name": self.name, "out_bytes": self.out_bytes,
                "compute_ms": round(self.compute_ms, 3),
                "fixed_ms": round(self.fixed_ms, 3), "accel": self.accel,
                "width": self.width, "samples": self.samples,
                "out_bytes_std": round(self.out_bytes_std, 3)}


class EdgeProfiles:
    """Per-node transfer/duration profiles learned from completed executions.

    Feed the result to ``plan_workflow(profiles=...)``: learned ``out_bytes``
    replace the spec's static hints, learned reference compute replaces the
    declared durations, and learned Map widths populate ``instances`` — the
    pilot-run → re-plan loop.
    """

    def __init__(self, nodes: Optional[Dict[str, NodeProfile]] = None):
        self.nodes: Dict[str, NodeProfile] = dict(nodes or {})

    # ---- learning ----------------------------------------------------------

    @classmethod
    def from_records(cls, sim: Any, *,
                     workflow_prefix: Optional[str] = None) -> "EdgeProfiles":
        """Learn profiles from a SimCloud's completed execution records.

        Only ``done`` records count (crashed/retried attempts carry no
        trustworthy output).  ``workflow_prefix`` restricts learning to one
        workflow's instances (records of other workflows sharing the sim are
        ignored).  Jitter means learned compute is a mildly inflated mean of
        the reference duration — calibration noise the planner tolerates.
        """
        # Imported lazily: simcloud itself builds a CostModel from this
        # module at runtime, so a top-level import would be circular.
        from repro_torch.backends.simcloud import estimate_size

        sizes: Dict[str, list] = defaultdict(list)
        computes: Dict[str, list] = defaultdict(list)
        fixed: Dict[str, float] = {}
        accel: Dict[str, bool] = {}
        widths: Dict[str, Dict[str, set]] = defaultdict(lambda: defaultdict(set))
        for r in sim.records:
            if r.status != "done" or r.function.startswith("__"):
                continue
            dep = sim.deployments.get((r.faas, r.function))
            faas = sim.faas.get(r.faas)
            if dep is None or faas is None:
                continue
            wfid, instance = _instance_key(r.payload)
            if wfid is None or (workflow_prefix is not None
                                and not wfid.startswith(workflow_prefix)):
                continue
            w = dep.workload
            acc = bool(getattr(w, "accel", True))
            fix = float(getattr(w, "fixed_ms", 0.0) or 0.0)
            speed = 1.0 if (faas.flavor.gpu and not acc) else faas.flavor.speed
            user_ms = r.phase_breakdown().get("user_exec", 0.0)
            sizes[r.function].append(estimate_size(r.result))
            computes[r.function].append(max(0.0, user_ms - fix) * speed)
            fixed[r.function] = fix
            accel[r.function] = acc
            widths[r.function][wfid].add(instance)
        nodes: Dict[str, NodeProfile] = {}
        for fn, ss in sizes.items():
            width = max((len(v) for v in widths[fn].values()), default=1)
            mean = sum(ss) / len(ss)
            var = sum((s - mean) ** 2 for s in ss) / len(ss)
            nodes[fn] = NodeProfile(
                name=fn,
                out_bytes=int(round(mean)),
                compute_ms=sum(computes[fn]) / len(computes[fn]),
                fixed_ms=fixed[fn],
                accel=accel[fn],
                width=width,
                samples=len(ss),
                out_bytes_std=math.sqrt(var))
        return cls(nodes)

    # ---- planner-facing queries -------------------------------------------

    def out_bytes(self, name: str) -> Optional[int]:
        """Learned mean output wire size of node ``name`` (None: untraced)."""
        p = self.nodes.get(name)
        return p.out_bytes if p is not None else None

    def out_bytes_std(self, name: str) -> Optional[float]:
        """Std-dev of node ``name``'s observed output size (None: untraced)
        — lets the prefetch planner gate speculation on confidence."""
        p = self.nodes.get(name)
        return p.out_bytes_std if p is not None else None

    def workload(self, name: str) -> Optional[Tuple[float, float, bool]]:
        """(compute_ms, fixed_ms, accel) or None if the node was never traced."""
        p = self.nodes.get(name)
        return (p.compute_ms, p.fixed_ms, p.accel) if p is not None else None

    def instances(self) -> Dict[str, int]:
        """Learned Map widths (> 1 only) keyed by function name."""
        return {n: p.width for n, p in self.nodes.items() if p.width > 1}

    # ---- (de)serialization (persist a pilot run's calibration) -------------

    def as_dict(self) -> dict:
        """JSON-ready per-node profiles (round-trips via :meth:`from_dict`)."""
        return {n: p.as_dict() for n, p in sorted(self.nodes.items())}

    @classmethod
    def from_dict(cls, d: Mapping[str, Mapping[str, Any]]) -> "EdgeProfiles":
        """Rehydrate profiles persisted with :meth:`as_dict`."""
        return cls({n: NodeProfile(
            name=v.get("name", n), out_bytes=int(v["out_bytes"]),
            compute_ms=float(v["compute_ms"]), fixed_ms=float(v["fixed_ms"]),
            accel=bool(v["accel"]), width=int(v.get("width", 1)),
            samples=int(v.get("samples", 0)),
            out_bytes_std=float(v.get("out_bytes_std", 0.0)))
            for n, v in d.items()})

    def __len__(self) -> int:
        return len(self.nodes)


def _instance_key(payload: Any) -> Tuple[Optional[str], Tuple]:
    """(workflow_id, instance discriminator) from an execution payload.

    Downstream hops carry a Control dict (branch stack distinguishes Map
    instances); entry events carry ``workflow_id`` directly.
    """
    if not isinstance(payload, dict):
        return None, ()
    ctl = payload.get("Control")
    if isinstance(ctl, dict):
        return (ctl.get("workflowId"),
                (tuple(ctl.get("branch", ())), ctl.get("iter", 0),
                 ctl.get("step", 0)))
    return payload.get("workflow_id"), ()
