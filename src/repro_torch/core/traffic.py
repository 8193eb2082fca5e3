"""Backend-agnostic traffic generation and online adaptation.

This module turns "drive a workflow substrate with realistic load" into a
reusable subsystem, decoupled from any one backend (Triggerflow-style: the
event/traffic substrate is not welded to a runtime).  It has three layers:

**Arrival processes** — deterministic generators of :class:`ArrivalSchedule`
(open-loop Poisson, fixed-period, replayable explicit schedules).  A schedule
is a plain list of ``(t_ms, stream)`` pairs: *when* (a delay in ms from the
moment the schedule is submitted) and *which* workflow of a round-robin mix.
Schedules are pure data — the same seed produces the same submit times no
matter which substrate consumes them, and they serialize to/from dicts so a
measured trace can be replayed later.

**LoadRunner** — submits a schedule to any :class:`repro_torch.backends.shim.Backend`
through the protocol's ``submit(faas, fn, payload, t=)`` delay contract
(``DeployedWorkflow.start(t=...)``): SimCloud consumes the delays in virtual
time, the concurrent local runner in wall-clock time.  After draining the
backend it collects a :class:`LoadPoint` — p50/p99/mean makespan, completion
and drop counts, and cost (via the optional ``bill`` capability) — using only
the shared record-query surface, so the same harness measures every backend.

**Online adaptation** — :class:`DriftDetector` compares live
``EdgeProfiles.from_records`` windows against the plan-time hints (or any
baseline profile set) and :class:`OnlineReplanner` turns detections into
``DeployedWorkflow.replan(profiles=...)`` calls mid-run — profile-driven
re-planning (GeoFF-style measured transfer profiles), complementing the
outage-driven path in ``benchmarks/failover.py``.

``benchmarks/throughput_sweep.py`` is built on this module (its published
numbers are reproduced bit-for-bit by construction: same RNG, same submit
order) and ``benchmarks/run.py --backend local --open-loop`` drives the real
concurrent executor with the same schedules.
"""

from __future__ import annotations

import math
import random
import statistics
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple)

from repro_torch.backends import shim


# ==========================================================================
# Percentiles — one definition, shared by every load harness
# ==========================================================================


def percentile(sorted_xs: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an ascending-sorted sequence (the exact
    formula the standing throughput benchmark has always published:
    ``xs[min(k-1, round(q*(k-1)))]``).  None on empty input."""
    k = len(sorted_xs)
    if not k:
        return None
    if q == 0.5:  # keep the historical p50 = xs[k//2] midpoint convention
        return sorted_xs[k // 2]
    return sorted_xs[min(k - 1, int(round(q * (k - 1))))]


# ==========================================================================
# Arrival schedules and the processes that generate them
# ==========================================================================


@dataclass(frozen=True)
class Arrival:
    """One workflow arrival: submit-delay ``t_ms`` (relative to the backend's
    clock when the schedule is submitted) and the round-robin ``stream``
    index selecting which deployed workflow of the mix it drives."""

    t_ms: float
    stream: int = 0


@dataclass
class ArrivalSchedule:
    """A replayable, substrate-independent list of arrivals (ascending t_ms).

    The schedule is the *only* thing an arrival process produces; everything
    that touches a backend lives in :class:`LoadRunner`.  ``meta`` records
    provenance (process, rate, seed) so a persisted schedule documents how it
    was made.
    """

    arrivals: List[Arrival]
    meta: Dict[str, Any] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.arrivals)

    def __iter__(self):
        return iter(self.arrivals)

    def __getitem__(self, i):
        return self.arrivals[i]

    @property
    def duration_ms(self) -> float:
        """Span from now (t=0) to the last arrival."""
        return self.arrivals[-1].t_ms if self.arrivals else 0.0

    def offered_rate_wf_s(self) -> Optional[float]:
        """Realized offered load (arrivals per second of schedule span)."""
        if len(self.arrivals) < 2 or self.duration_ms <= 0:
            return None
        return len(self.arrivals) / (self.duration_ms / 1000.0)

    # ---- sharding (partition independent workflows across processes) -------

    def split(self, shards: int) -> List["ArrivalSchedule"]:
        """Deal this schedule round-robin into ``shards`` sub-schedules.

        Arrival ``j`` goes to shard ``(j // streams) % shards`` — whole
        *rounds* of the stream rotation are dealt together, so every shard
        sees every workflow of the mix at the same relative frequency and
        the union of the parts is exactly this schedule (same absolute
        submit delays; arrivals stay in ascending order within each part).
        The deal depends only on position, never on shard execution order,
        so partitioning is deterministic for any shard count.
        ``shards <= 1`` returns ``[self]`` unchanged — the single-shard
        path is byte-identical to not sharding at all.
        """
        if shards <= 1:
            return [self]
        streams = max(int(self.meta.get("streams", 1)), 1)
        parts: List[List[Arrival]] = [[] for _ in range(shards)]
        for j, a in enumerate(self.arrivals):
            parts[(j // streams) % shards].append(a)
        return [ArrivalSchedule(p, meta={**self.meta,
                                         "shard": i, "shards": shards})
                for i, p in enumerate(parts)]

    # ---- persistence (replay a measured trace) ----------------------------

    def as_dict(self) -> dict:
        """JSON-ready form (round-trips via :meth:`from_dict`)."""
        return {"meta": dict(self.meta),
                "arrivals": [[a.t_ms, a.stream] for a in self.arrivals]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ArrivalSchedule":
        """Rehydrate a schedule persisted with :meth:`as_dict`."""
        return cls([Arrival(float(t), int(s)) for t, s in d["arrivals"]],
                   meta=dict(d.get("meta", {})))

    @classmethod
    def from_times(cls, times_ms: Sequence[float], streams: int = 1,
                   **meta: Any) -> "ArrivalSchedule":
        """Explicit schedule: round-robin streams over given submit times."""
        return cls([Arrival(float(t), i % max(streams, 1))
                    for i, t in enumerate(times_ms)],
                   meta={"process": "explicit", **meta})


@dataclass(frozen=True)
class PoissonProcess:
    """Open-loop Poisson arrivals at ``rate_wf_s`` workflows/second.

    Deterministic: the schedule is a pure function of ``(rate_wf_s, seed,
    n, streams)`` — exponential gaps from ``random.Random(seed)``, identical
    to the arithmetic the throughput sweep has always used, so refactored
    harnesses reproduce their published numbers.
    """

    rate_wf_s: float
    seed: int = 0

    def schedule(self, n: int, streams: int = 1) -> ArrivalSchedule:
        """``n`` arrivals, round-robin over ``streams`` workflow slots."""
        rng = random.Random(self.seed)
        t = 0.0
        arrivals: List[Arrival] = []
        for i in range(n):
            t += rng.expovariate(self.rate_wf_s) * 1000.0
            arrivals.append(Arrival(t, i % max(streams, 1)))
        return ArrivalSchedule(arrivals, meta={
            "process": "poisson", "rate_wf_s": self.rate_wf_s,
            "seed": self.seed, "n": n, "streams": streams})


@dataclass(frozen=True)
class UniformProcess:
    """Fixed-period arrivals (the classic ``i * spacing_ms`` launcher)."""

    period_ms: float
    start_ms: float = 0.0

    def schedule(self, n: int, streams: int = 1) -> ArrivalSchedule:
        """``n`` arrivals, round-robin over ``streams`` workflow slots."""
        arrivals = [Arrival(self.start_ms + i * self.period_ms,
                            i % max(streams, 1)) for i in range(n)]
        return ArrivalSchedule(arrivals, meta={
            "process": "uniform", "period_ms": self.period_ms,
            "start_ms": self.start_ms, "n": n, "streams": streams})


@dataclass(frozen=True)
class SignalArrival:
    """One scheduled signal delivery for durable workflows: after ``t_ms``,
    deliver signal ``name`` (carrying ``value``) to the ``index``-th workflow
    instance of the batch being driven — resolving any ``WaitForSignal(name)``
    it is suspended on.  Pure data, like :class:`Arrival`: the same list
    drives SimCloud in virtual time and the local runner in wall-clock time
    through the backend's ``signal(..., t=)`` delay contract."""

    t_ms: float
    name: str
    index: int = 0
    value: Any = True


@dataclass(frozen=True)
class ClosedLoopProcess:
    """Closed-loop traffic: ``clients`` concurrent clients, each submitting
    its next workflow ``think_time_ms`` after its previous one finished.

    A closed loop cannot be precomputed as a schedule (arrival times depend
    on observed completions), so it is *driven* by
    :meth:`LoadRunner.run_closed` in barrier-synchronized rounds: every
    client's round-``k`` workflow is submitted with the think-time delay
    through the same ``submit(t=)`` contract once round ``k-1`` has drained.
    Deterministic on SimCloud; on the local runner timings are wall-clock.
    """

    clients: int
    think_time_ms: float = 0.0


# ==========================================================================
# LoadPoint — what one offered-load measurement reports
# ==========================================================================


@dataclass
class LoadPoint:
    """Per-point load metrics, computed from the record-query surface only."""

    submitted: int
    completed: int
    dropped: int
    p50_ms: Optional[float]
    p99_ms: Optional[float]
    mean_ms: Optional[float]
    makespans_ms: List[float] = field(default_factory=list, repr=False)
    cost_usd: Optional[float] = None      # via the optional ``bill`` capability
    duration_ms: float = 0.0              # backend-clock span of the point

    @property
    def throughput_wf_s(self) -> Optional[float]:
        """Achieved workflows/second over the point's backend-clock span."""
        if self.duration_ms <= 0:
            return None
        return self.completed / (self.duration_ms / 1000.0)

    def as_dict(self) -> dict:
        """JSON-ready summary (makespans list omitted)."""
        return {"submitted": self.submitted, "completed": self.completed,
                "dropped": self.dropped,
                "p50_ms": round(self.p50_ms, 1) if self.p50_ms is not None else None,
                "p99_ms": round(self.p99_ms, 1) if self.p99_ms is not None else None,
                "mean_ms": round(self.mean_ms, 1) if self.mean_ms is not None else None,
                "cost_usd": self.cost_usd, "duration_ms": round(self.duration_ms, 1)}


# ==========================================================================
# LoadRunner — drive any Backend with a schedule, measure the outcome
# ==========================================================================


class LoadRunner:
    """Submit arrival schedules to deployed workflows on any Backend.

    ``deployed`` is the workflow mix: arrival ``stream`` ``i`` starts
    ``deployed[i % len(deployed)]``.  All backend interaction goes through
    the Backend protocol (``submit`` via ``DeployedWorkflow.start(t=)``,
    ``run``, the record-query surface), so the same runner drives SimCloud
    in virtual time and the concurrent local executor in wall-clock time.
    """

    def __init__(self, deployed: Sequence[Any], *, input_value: Any = 0):
        if not deployed:
            raise ValueError("LoadRunner needs at least one deployed workflow")
        self.deployed = list(deployed)
        backends = {id(d.backend) for d in self.deployed}
        if len(backends) != 1:
            raise ValueError("all deployed workflows must share one backend")
        self.backend = self.deployed[0].backend
        self.input_value = input_value
        self.started: List[Tuple[Any, str]] = []   # (DeployedWorkflow, wfid)
        self._drops_seen = len(self.backend.dropped)

    # ---- submission --------------------------------------------------------

    def submit(self, schedule: ArrivalSchedule) -> List[Tuple[Any, str]]:
        """Submit every arrival through the ``submit(t=)`` delay contract, in
        schedule order (submit order is part of determinism on SimCloud).
        Returns the new ``(workflow, workflow_id)`` pairs."""
        new: List[Tuple[Any, str]] = []
        mix = self.deployed
        for a in schedule:
            dep = mix[a.stream % len(mix)]
            new.append((dep, dep.start(self.input_value, t=a.t_ms)))
        self.started.extend(new)
        return new

    def submit_lazy(self, schedule: ArrivalSchedule) -> List[Tuple[Any, str]]:
        """Submit a schedule as a *feeder chain* instead of pre-pushing every
        arrival onto the backend's event heap.

        ``submit`` materializes one heap event per arrival up front — at
        10⁶ arrivals that is gigabytes of resident heap before the first
        workflow even runs.  This path keeps O(1) pending arrivals: each
        feeder event starts one workflow at its scheduled instant and arms
        the next feeder.  Workflow ids are minted upfront so the returned
        ``(workflow, workflow_id)`` pairs are immediately addressable.

        Requires the backend's optional ``at(t, fn, *args)`` scheduler
        capability (probed with ``getattr``, per the Backend protocol) —
        virtual-time substrates only.  Metric-equivalent to ``submit`` but
        *not* event-sequence-identical (the feeder adds one scheduler event
        per arrival), so digest-pinned comparisons must use ``submit``."""
        at = getattr(self.backend, "at", None)
        if not at:
            raise shim.CapabilityError(
                f"{type(self.backend).__name__} provides no 'at' scheduler "
                f"capability, required for lazy submission (see the Backend "
                f"protocol in repro_torch.backends.shim)")
        arrivals = schedule.arrivals
        if not arrivals:
            return []
        mix = self.deployed
        nmix = len(mix)
        new: List[Tuple[Any, str]] = [
            (dep := mix[a.stream % nmix], dep.mint_workflow_id())
            for a in arrivals]
        iv = self.input_value
        t0 = getattr(self.backend, "now", 0.0)   # schedule t_ms are delays
        last = len(arrivals) - 1

        def _feed(i: int) -> None:
            dep, wid = new[i]
            dep.start(iv, workflow_id=wid, t=0.0)
            if i < last:
                at(t0 + arrivals[i + 1].t_ms, _feed, i + 1)

        at(t0 + arrivals[0].t_ms, _feed, 0)
        self.started.extend(new)
        return new

    def submit_signals(self, signals: Sequence[SignalArrival],
                       started: Optional[Sequence[Tuple[Any, str]]] = None
                       ) -> int:
        """Schedule signal deliveries against workflows this runner started
        (default: everything submitted so far; pass :meth:`submit`'s return
        value to address one batch).  Each arrival targets the ``index``-th
        ``(workflow, wfid)`` pair and goes through the backend's optional
        ``signal`` capability — probed with ``getattr`` per the protocol's
        capability rule, so a backend without signal delivery raises a clear
        :class:`repro_torch.backends.shim.CapabilityError`.  Returns the number of
        deliveries scheduled."""
        started = self.started if started is None else list(started)
        send = getattr(self.backend, "signal", None)
        if not send:
            raise shim.CapabilityError(
                f"{type(self.backend).__name__} provides no 'signal' "
                f"capability, required to deliver SignalArrivals (see the "
                f"Backend protocol in repro_torch.backends.shim)")
        if not started:
            raise ValueError("no started workflows to signal")
        for s in signals:
            _, wid = started[s.index % len(started)]
            send(wid, s.name, s.value, t=s.t_ms)
        return len(signals)

    def drain(self, **run_kwargs: Any) -> Any:
        """Drive the backend until quiescent.  Backend-specific limits
        (``t_max=`` on SimCloud, ``timeout_s=`` on the local runner) pass
        through as keyword arguments, per the Backend protocol."""
        return self.backend.run(**run_kwargs)

    # ---- measurement -------------------------------------------------------

    def collect(self, started: Optional[Sequence[Tuple[Any, str]]] = None
                ) -> LoadPoint:
        """Build a :class:`LoadPoint` for ``started`` (default: everything
        this runner submitted) from the record-query surface — one index
        query per workflow (makespan, queue/end extremes in a single pass).

        ``dropped`` counts drops since the previous :meth:`collect` on this
        runner: backends report drops globally, not per workflow, so drops
        are attributed to the load point being collected, which is exact
        for the submit→drain→collect cycle of :meth:`offered`."""
        from repro_torch.core.subgraph import GC_FUNCTION
        started = self.started if started is None else list(started)
        makespans = []
        t_start, t_end = math.inf, -math.inf
        for dep, wid in started:
            m0 = m1 = None
            for r in dep.executions(wid):
                if r.t_queued < t_start:
                    t_start = r.t_queued
                if r.t_end == r.t_end and r.t_end > t_end:
                    t_end = r.t_end
                if r.status == "done" and r.function != GC_FUNCTION:
                    if m0 is None or r.t_queued < m0:
                        m0 = r.t_queued
                    if m1 is None or r.t_end > m1:
                        m1 = r.t_end
            if m0 is not None:
                makespans.append(m1 - m0)
        makespans.sort()
        k = len(makespans)
        bill = getattr(self.backend, "bill", None)
        cost = None
        if bill is not None:
            try:
                cost = round(sum(bill.breakdown().values()), 6)
            except Exception:
                cost = None
        total_drops = len(self.backend.dropped)
        dropped, self._drops_seen = total_drops - self._drops_seen, total_drops
        return LoadPoint(
            submitted=len(started), completed=k, dropped=dropped,
            p50_ms=percentile(makespans, 0.5),
            p99_ms=percentile(makespans, 0.99),
            mean_ms=statistics.fmean(makespans) if k else None,
            makespans_ms=makespans, cost_usd=cost,
            duration_ms=max(0.0, t_end - t_start) if k else 0.0)

    def offered(self, schedule: ArrivalSchedule, *,
                signals: Sequence[SignalArrival] = (),
                **run_kwargs: Any) -> LoadPoint:
        """One open-loop point: submit the whole schedule (plus any
        ``signals`` addressed into the batch), drain, collect."""
        started = self.submit(schedule)
        if signals:
            self.submit_signals(signals, started)
        self.drain(**run_kwargs)
        return self.collect(started)

    @staticmethod
    def offered_sharded(builders: Sequence[Any], backend_factory: Any,
                        schedule: ArrivalSchedule, **kwargs: Any):
        """One open-loop point partitioned across worker processes — the
        ``shards=N`` face of :meth:`offered`.  Delegates to
        :func:`repro_torch.core.shard.run_sharded` (see that module for the
        independence invariants and the exact-merge semantics); takes spec
        *builders* and a ``backend_factory(seed)`` instead of live deployed
        workflows because each shard constructs its own backend in its own
        process.  Returns ``(LoadPoint, stats_dict)``."""
        from repro_torch.core import shard            # local: shard imports traffic
        return shard.run_sharded(builders, backend_factory, schedule, **kwargs)

    def run_closed(self, process: ClosedLoopProcess, rounds: int,
                   **run_kwargs: Any) -> LoadPoint:
        """Drive a closed loop for ``rounds`` rounds (see
        :class:`ClosedLoopProcess` for the barrier-synchronized semantics)."""
        started: List[Tuple[Any, str]] = []
        mix = self.deployed
        for r in range(rounds):
            think = process.think_time_ms if r else 0.0
            batch = ArrivalSchedule(
                [Arrival(think, c) for c in range(process.clients)],
                meta={"process": "closed", "round": r})
            started.extend(self.submit(batch))
            self.drain(**run_kwargs)
        return self.collect(started)


# ==========================================================================
# Drift detection — live profiles vs plan-time hints
# ==========================================================================


@dataclass(frozen=True)
class DriftThresholds:
    """When is an observed profile "drifted" from its baseline?

    A node triggers when its live mean ``out_bytes`` (or reference compute)
    leaves the band ``[baseline/ratio, baseline*ratio]``; nodes with fewer
    than ``min_samples`` completed executions in the window are ignored
    (small windows are noisy, and SimCloud jitter alone is ±12%).  Byte
    drift is also ignored while *both* sides sit under ``min_out_bytes`` —
    a 64 B hint observed as 19 B is a hint inaccuracy, not a placement-
    relevant traffic change (the ratio test is meaningless at sizes whose
    wire time rounds to zero)."""

    out_bytes_ratio: float = 1.5
    compute_ratio: float = 2.0
    min_samples: int = 5
    min_out_bytes: int = 16_384


@dataclass
class DriftReport:
    """Outcome of one detector check: which nodes drifted, and why."""

    drifted: Dict[str, str] = field(default_factory=dict)  # node -> reason
    checked: int = 0

    def __bool__(self) -> bool:
        return bool(self.drifted)


class DriftDetector:
    """Compare live :class:`~repro_torch.core.costmodel.EdgeProfiles` windows
    against baseline (plan-time) per-node profiles.

    The baseline is what the current placement was *planned with*: the
    spec's static ``out_bytes``/duration hints (:meth:`from_spec`) or a
    previously learned profile set (e.g. the pilot run's).  ``check()``
    is pure — it never touches a backend — so it is unit-testable and
    substrate-independent; :class:`OnlineReplanner` wires it to live
    record windows.
    """

    def __init__(self, baseline: Mapping[str, Any],
                 thresholds: DriftThresholds = DriftThresholds()):
        # baseline values need .out_bytes / .compute_ms (NodeProfile shape)
        self.baseline = dict(baseline)
        self.thresholds = thresholds

    @classmethod
    def from_spec(cls, spec: Any,
                  thresholds: DriftThresholds = DriftThresholds()
                  ) -> "DriftDetector":
        """Baseline from a WorkflowSpec's static workload hints — what the
        *initial* plan was computed from (nodes without an ``out_bytes``
        hint are only compute-checked)."""
        from repro_torch.core.costmodel import NodeProfile
        base: Dict[str, NodeProfile] = {}
        for name, f in spec.functions.items():
            w = f.workload
            if not isinstance(w, shim.Workload):
                continue
            base[name] = NodeProfile(
                name=name,
                out_bytes=int(w.out_bytes) if w.out_bytes else 0,
                out_bytes_std=float(w.out_bytes_std or 0.0),
                compute_ms=float(w.compute_ms), fixed_ms=float(w.fixed_ms),
                accel=w.accel)
        return cls(base, thresholds)

    def rebase(self, profiles: Any) -> None:
        """Adopt ``profiles`` (an EdgeProfiles or node mapping) as the new
        baseline — call after re-planning with them, so the detector tracks
        drift from the *current* plan, not the original one."""
        nodes = getattr(profiles, "nodes", profiles)
        self.baseline.update(nodes)

    def check(self, live: Any) -> DriftReport:
        """``live``: an EdgeProfiles (or node mapping) learned from a recent
        record window.  Returns which baselined nodes left their band."""
        th = self.thresholds
        nodes = getattr(live, "nodes", live)
        report = DriftReport()
        for name, prof in nodes.items():
            base = self.baseline.get(name)
            if base is None or prof.samples < th.min_samples:
                continue
            report.checked += 1
            if (base.out_bytes > 0 and prof.out_bytes > 0
                    and max(base.out_bytes, prof.out_bytes) >= th.min_out_bytes):
                ratio = prof.out_bytes / base.out_bytes
                if ratio > th.out_bytes_ratio or ratio < 1.0 / th.out_bytes_ratio:
                    report.drifted[name] = (
                        f"out_bytes {prof.out_bytes} vs plan {base.out_bytes} "
                        f"({ratio:.2f}x)")
                    continue
            if base.compute_ms > 0 and prof.compute_ms > 0:
                ratio = prof.compute_ms / base.compute_ms
                if ratio > th.compute_ratio or ratio < 1.0 / th.compute_ratio:
                    report.drifted[name] = (
                        f"compute {prof.compute_ms:.1f} ms vs plan "
                        f"{base.compute_ms:.1f} ms ({ratio:.2f}x)")
        return report


# ==========================================================================
# OnlineReplanner — drift-triggered mid-run re-planning
# ==========================================================================


class OnlineReplanner:
    """Profile-driven *online* re-planning: watch live execution records,
    and when they drift from the plan-time hints, re-place the workflow for
    future instances (``DeployedWorkflow.replan(profiles=...)``).

    Today's outage path re-plans only when a cloud *dies*; this monitor
    re-plans when the *traffic* changes shape (bigger payloads, slower
    stages) — the GeoFF observation that cross-cloud placements rot as
    transfer profiles move.

    Mechanics: each :meth:`probe` learns an ``EdgeProfiles`` window from the
    executions *completed* since the previous probe (``completed()`` from
    the record-query surface, filtered by ``t_end`` — completion windows,
    not queue windows: under overload a stage's records can sit ``running``
    across many probes, and a queue-order cursor would skip them forever),
    checks it against the :class:`DriftDetector` baseline, and on drift
    calls ``replan(profiles=window)`` with the **entry function pinned** to
    its current FaaS — external clients (and already-scheduled arrivals)
    address the entry endpoint, so the front door must not move mid-run.
    After a re-plan the detector is re-based on the learned window and a
    cooldown suppresses immediate re-triggers.

    On SimCloud, :meth:`install` self-arms the probe in virtual time via the
    backend's ``after`` capability (probed with ``getattr``, per the
    protocol's capability rule), and disarms itself after
    ``max_idle_probes`` consecutive probes with no backend activity (the
    traffic ended — re-``install`` for a new wave).  Harnesses on backends
    without a scheduler call :meth:`probe` themselves between rounds.
    """

    def __init__(self, dep: Any, detector: DriftDetector, *,
                 interval_ms: float = 1000.0, cooldown_ms: float = 2000.0,
                 objective: str = "makespan", pin_entry: bool = True,
                 max_idle_probes: int = 4):
        self.dep = dep                    # current DeployedWorkflow (mutates)
        self.detector = detector
        self.interval_ms = interval_ms
        self.cooldown_ms = cooldown_ms
        self.objective = objective
        self.pin_entry = pin_entry
        self.max_idle_probes = max_idle_probes
        self.replans: List[Tuple[float, DriftReport]] = []
        self._seen: set = set()          # exec_ids already windowed
        self._cooldown_until = float("-inf")

    # ---- record windows ----------------------------------------------------

    def _window_profiles(self) -> Any:
        """EdgeProfiles over executions completed since the last probe,
        restricted to this workflow's instances.  The window cursor is a
        set of seen ``exec_id``s, not a ``t_end`` watermark — on a threaded
        backend a record can be *stamped* before a concurrently-completing
        record publishes, and a time watermark would skip it forever.  Uses
        a lightweight view (records slice + deployments + faas) so no
        backend grows a windowing API."""
        from repro_torch.core.costmodel import EdgeProfiles
        backend = self.dep.backend
        seen = self._seen
        window = [r for r in backend.completed() if r.exec_id not in seen]
        if not window:
            return EdgeProfiles()
        seen.update(r.exec_id for r in window)
        view = SimpleNamespace(records=window, deployments=backend.deployments,
                               faas=getattr(backend, "faas", {}))
        return EdgeProfiles.from_records(
            view, workflow_prefix=self.dep.spec.name)

    # ---- the probe ---------------------------------------------------------

    def probe(self, now_ms: Optional[float] = None) -> Optional[DriftReport]:
        """One drift check.  Returns the report when a re-plan fired."""
        live = self._window_profiles()
        if not len(live):
            return None
        now = now_ms if now_ms is not None else getattr(
            self.dep.backend, "now", 0.0)
        report = self.detector.check(live)
        if not report or now < self._cooldown_until:
            return None
        candidates = None
        if self.pin_entry and self.dep.spec.entry:
            entry = self.dep.spec.entry
            candidates = {entry: (self.dep.views[entry].faas,)}
        self.dep = self.dep.replan(objective=self.objective, profiles=live,
                                   candidates=candidates)
        self.detector.rebase(live)
        self._cooldown_until = now + self.cooldown_ms
        self.replans.append((now, report))
        return report

    # ---- virtual-time self-arming (SimCloud) -------------------------------

    def install(self, until_ms: float = float("inf")) -> None:
        """Arm periodic probing on a backend with an ``after(dt, fn)``
        scheduler capability (SimCloud's virtual clock).  Raises
        :class:`repro_torch.backends.shim.CapabilityError` on backends without
        one — drive :meth:`probe` manually there.  The probe disarms after
        ``max_idle_probes`` probes with no new records (otherwise a
        self-re-arming monitor would keep an otherwise-drained event heap
        spinning to the run's time horizon)."""
        backend = self.dep.backend
        after = getattr(backend, "after", None)
        if after is None:
            raise shim.CapabilityError(
                f"{type(backend).__name__} provides no 'after' scheduler "
                f"capability; call OnlineReplanner.probe() manually")
        state = {"idle": 0, "nrecords": len(backend.records)}

        def tick():
            self.probe(getattr(backend, "now", None))
            n = len(backend.records)
            state["idle"] = 0 if n != state["nrecords"] else state["idle"] + 1
            state["nrecords"] = n
            if (getattr(backend, "now", 0.0) < until_ms
                    and state["idle"] < self.max_idle_probes):
                backend.after(self.interval_ms, tick)

        after(self.interval_ms, tick)


# ==========================================================================
# Drift injection — benchmark/test scaffolding
# ==========================================================================


def inject_output_drift(backend: Any, function: str, out_bytes: int) -> int:
    """Make every deployment of ``function`` start emitting ``out_bytes``-
    sized Blobs (its workload ``fn`` is replaced; ``out_bytes`` hints are
    deliberately left stale — that is the *point*: the live traffic no
    longer matches the plan-time hints).  Returns how many deployments were
    mutated.  Schedule it mid-run (e.g. ``sim.at(t, inject_output_drift,
    sim, "sort", 4_000_000)``) to create the drift the online re-planner
    reacts to."""
    n = 0
    for (faas, fn), dep in list(backend.deployments.items()):
        if fn != function:
            continue
        dep.workload.fn = lambda x, _b=out_bytes: shim.Blob(_b, "drift")
        n += 1
    if not n:
        raise KeyError(f"no deployment of function {function!r}")
    return n
