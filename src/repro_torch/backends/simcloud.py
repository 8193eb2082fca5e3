"""SimCloud — a deterministic, high-throughput discrete-event Jointcloud simulator.

The container has no AWS/AliYun access, so the multi-cloud substrate the paper
evaluates on is simulated here.  Everything *algorithmic* (checkpoint
protocols, failover, naming, coordination) executes for real — only wire
latencies, queue dwell times and prices come from
:mod:`repro_torch.backends.calibration`.

Model
-----
* A single event heap drives a virtual clock (milliseconds).  Every datastore
  operation executes atomically at one point in virtual time, which makes the
  stores linearizable by construction (the consistency level Table 2 demands).
* Workflow functions are *effect generators* (see :mod:`repro_torch.backends.shim`).
  Each invocation becomes an :class:`Execution` that is resumed once per
  effect completion.
* Failure injection: cloud/FaaS outage windows kill running executions and
  make invocations fail fast (connection-refused semantics); the FaaS retry
  queue then re-delivers — i.e. the substrate provides exactly the
  *at-least-once* guarantee the paper builds exactly-once on top of.
* A crash policy hook can abort an execution at any effect boundary, which is
  how the property tests explore the duplicate-execution space of §4.1.2's
  "most extreme scenario".
* Load substrate (both opt-in, off by default so single-workflow studies are
  unaffected): per-FaaS *concurrency slots* — invocations wait for a free
  slot, and minting a new slot pays a cold start (``concurrency=`` /
  ``cold_start_ms=``) — and *contention-aware bandwidth*: when the topology
  pins a per-pair link capacity, concurrent cross-cloud transfers share it
  and :meth:`repro_torch.core.costmodel.CostModel.wire_ms` stretches accordingly.

Determinism: a seeded RNG drives latency jitter; the heap breaks ties by
sequence number.  Same seed ⇒ bit-identical timelines (guarded by the digest
regression tests in ``tests/test_simcloud_engine.py`` — see
:func:`timeline_digest`).

Engine invariants new effects must respect (the hot paths are index-based;
see ROADMAP):

* effect dispatch is a per-type table (``SimCloud._dispatch``), not an
  isinstance chain — register new effect classes there;
* ``FaaSSystem`` outage windows are kept merged + sorted so ``up_at`` is a
  bisect — add windows via :meth:`FaaSSystem.add_outage`, never by mutating
  ``outages`` directly;
* ``records`` is mirrored into per-function / per-workflow / completed
  indexes at enqueue time — reporting must go through ``executions_of`` /
  ``completed`` / ``workflow_records`` instead of scanning ``records``;
* scheduled events are ``(t, seq, fn, args)`` tuples — continuations are
  disarmed via ``Execution.alive``, never by cancelling events.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import math
import random
from bisect import bisect_left, bisect_right
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Generator, List, Mapping, Optional,
                    Tuple)

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.backends.billing import Bill
from repro_torch.backends.datastore import TableState, signal_key


# Shared runtime types live in the shim (backend-agnostic); re-exported here
# because SimCloud was their historical home and most callers import them
# from this module.
from repro_torch.backends.shim import (Blob, Deployment, ExecutionRecord,  # noqa: F401
                                 Workload, estimate_size)

# ==========================================================================
# Static entities
# ==========================================================================


@dataclass
class FaaSSystem:
    id: str                      # "cloud/system"
    cloud: str
    flavor: cal.Flavor
    payload_quota: int
    # Load substrate (None ⇒ unbounded pre-warmed capacity, the paper's
    # setup; an int ⇒ that many concurrency slots, minted on demand with a
    # cold-start penalty, then kept warm).
    concurrency: Optional[int] = None
    cold_start_ms: float = 0.0

    def __post_init__(self):
        self.outages: List[Tuple[float, float]] = []     # raw, as scheduled
        self._outage_starts: List[float] = []            # merged, sorted
        self._outage_ends: List[float] = []
        # slot accounting (only consulted when concurrency is not None)
        self.slots_total = 0        # slots minted so far (≤ concurrency)
        self.slots_busy = 0
        self.cold_starts = 0
        self.pending: deque = deque()   # (dep, payload, rec) awaiting a slot

    def add_outage(self, t0: float, t1: float) -> None:
        """Register an outage window, keeping the merged set sorted so
        :meth:`up_at` stays a bisect.  Never append to ``outages`` directly."""
        self.outages.append((t0, t1))
        merged: List[Tuple[float, float]] = []
        for a, b in sorted(self.outages):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        self._outage_starts = [a for a, _ in merged]
        self._outage_ends = [b for _, b in merged]

    def up_at(self, t: float) -> bool:
        starts = self._outage_starts
        if not starts:
            return True
        i = bisect_right(starts, t) - 1
        return i < 0 or t >= self._outage_ends[i]


@dataclass
class DataStoreService:
    id: str                      # "cloud/store"
    cloud: str
    kind: str                    # "table" | "object"
    state: TableState = field(default_factory=lambda: TableState("ds"))

    def read_ms(self) -> float:
        return cal.TABLE_READ_MS if self.kind == "table" else cal.OBJECT_READ_MS

    def write_ms(self) -> float:
        return cal.TABLE_WRITE_MS if self.kind == "table" else cal.OBJECT_WRITE_MS


# Sentinel first element of a FaaSSystem.pending entry marking a suspended
# execution waiting to re-acquire a slot (vs a new (dep, payload, rec) start).
_RESUME = object()


class Execution:
    """One running attempt of a deployed function (drives its generator)."""

    __slots__ = ("sim", "dep", "payload", "record", "gen", "effect_index",
                 "alive", "faas_obj", "cloud", "suspended_ms", "suspend_t0",
                 "_send", "_resume", "_throw")

    def __init__(self, sim: "SimCloud", dep: Deployment, payload: Any,
                 record: ExecutionRecord):
        self.sim = sim
        self.dep = dep
        self.payload = payload
        self.record = record
        self.gen: Generator = dep.handler(payload)
        self.effect_index = 0
        self.alive = True
        self.faas_obj = sim.faas[dep.faas]     # hot-path cache
        self.cloud = self.faas_obj.cloud
        self.suspended_ms = 0.0       # Sleep/WaitForSignal time: not billed
        self.suspend_t0 = 0.0
        # bound-method caches: _step binds gen.send and hands (resume, throw)
        # to the effect handler on *every* effect — two fresh bound-method
        # objects per effect is measurable garbage at 1M-workflow scale
        self._send = self.gen.send
        self._resume = self.resume
        self._throw = self.throw

    # ---- generator stepping ------------------------------------------------

    def start(self) -> None:
        self.record.t_start = self.sim.now
        self.record.status = "running"
        self.sim.running.setdefault(self.dep.faas, set()).add(self)
        self._step(self._send, None)

    def resume(self, value: Any) -> None:
        if not self.alive:
            return
        self._step(self._send, value)

    def throw(self, exc: BaseException) -> None:
        if not self.alive:
            return
        self._step(self.gen.throw, exc)

    def _step(self, advance: Callable[[Any], shim.Effect], arg: Any) -> None:
        sim = self.sim
        send = self._send
        # Synchronous effects (Trace/Now) complete at the current instant —
        # loop over them here instead of recursing through
        # perform → ok → resume, which would stack four frames per effect.
        while True:
            try:
                effect = advance(arg)
            except StopIteration as stop:
                self._finish(stop.value)
                return
            except shim.ShimError as exc:
                # Unhandled shim error escapes the handler: the attempt
                # crashes and the FaaS at-least-once queue may retry it.
                sim._crash_execution(self, reason=repr(exc))
                return
            # crash-policy hook: abort *before* performing the effect
            # (models a process kill between two side effects — §4.1.2
            # extreme scenario)
            if sim.crash_policy is not None and sim.crash_policy(self, effect):
                sim._crash_execution(self, reason="injected")
                return
            self.effect_index += 1
            klass = effect.__class__
            if klass is shim.Trace:
                self.record.phases.append((sim.now, effect.phase))
                advance, arg = send, None
                continue
            if klass is shim.Now:
                advance, arg = send, sim.now
                continue
            handler = sim._dispatch.get(klass)
            if handler is None:
                sim.perform(self, effect, self._resume, self._throw)  # MRO path
            else:
                handler(self, effect, self._resume, self._throw)
            return

    def _finish(self, result: Any) -> None:
        self.alive = False
        self.record.t_end = self.sim.now
        self.record.status = "done"
        self.record.result = result
        self.sim.running.get(self.dep.faas, set()).discard(self)
        self.sim._done_records.append(self.record)
        faas = self.faas_obj
        mem = self.dep.memory_gb or faas.flavor.memory_gb
        self.sim.bill.charge_execution(
            faas.cloud, mem,
            self.record.t_end - self.record.t_start - self.suspended_ms,
            faas.flavor.price_per_gb_s)
        self.sim._release_slot(faas)

    def kill(self) -> None:
        """Abort this attempt (outage / injected crash).

        In-flight side effects (HTTP requests / datastore writes already on
        the wire) are *not* cancelled — a dead sender cannot recall a packet.
        Only the continuation is disarmed (``alive`` flag), which is exactly
        the duplicate-effect hazard §4.1's checkpoints must absorb.
        """
        self.alive = False
        self.record.t_end = self.sim.now
        self.record.status = "crashed"
        self.sim.running.get(self.dep.faas, set()).discard(self)
        # Partial executions still bill their GB·s (clouds charge until kill).
        faas = self.faas_obj
        mem = self.dep.memory_gb or faas.flavor.memory_gb
        if not math.isnan(self.record.t_start):
            self.sim.bill.charge_execution(
                faas.cloud, mem,
                self.record.t_end - self.record.t_start - self.suspended_ms,
                faas.flavor.price_per_gb_s)
        self.sim._release_slot(faas)


# ==========================================================================
# The simulator
# ==========================================================================


class SimCloud:
    def __init__(self, config: Optional[dict] = None, *, seed: int = 0,
                 jitter: float = 0.12,
                 concurrency: Optional[Mapping[str, int]] = None,
                 cold_start_ms: Optional[float] = None):
        """``concurrency`` maps FaaS ids ("aws/lambda") or cloud names
        ("aws") to a slot count; systems it covers pay ``cold_start_ms``
        (default ``calibration.COLD_START_MS``) whenever a new slot is
        minted and queue when all slots are busy.  Systems it does not cover
        keep the paper's pre-warmed unbounded-capacity behavior."""
        config = config or cal.default_jointcloud()
        self.rng = random.Random(seed)
        self.jitter = jitter
        self.now = 0.0
        # heap entries are (t, seq, fn, args) — seq is a unique tie-break so
        # comparison never reaches fn
        self._heap: List[Tuple[float, int, Callable, tuple]] = []
        self._seq = itertools.count()
        self.bill = Bill()
        self.events_processed = 0

        # Imported here, not at module top: repro_torch.core's package init pulls
        # in workflow.py, which imports this module — a top-level import of
        # repro_torch.core.costmodel would deadlock that cycle at first import.
        from repro_torch.core.costmodel import CostModel, Topology
        self.topology = Topology.from_config(config)
        self.cost = CostModel(self.topology)
        # network-jitter fast path: with no per-pair amplitude pinned (the
        # default) the interpreter draws zero extra random numbers, keeping
        # timelines bit-identical to previous releases
        self._net_jitter = bool(self.topology.rtt_jitter_table)

        cold_ms = cal.COLD_START_MS if cold_start_ms is None else cold_start_ms
        self.faas: Dict[str, FaaSSystem] = {}
        self.stores: Dict[str, DataStoreService] = {}
        for cname, c in config["clouds"].items():
            for sysname, flavor in c.get("faas", {}).items():
                fid = shim.faas_id(cname, sysname)
                quota = cal.PAYLOAD_QUOTA.get(cname, cal.DEFAULT_PAYLOAD_QUOTA)
                conc = None
                if concurrency:
                    conc = concurrency.get(fid, concurrency.get(cname))
                self.faas[fid] = FaaSSystem(
                    fid, cname, flavor, quota, concurrency=conc,
                    cold_start_ms=cold_ms if conc is not None else 0.0)
            for t in c.get("tables", []):
                did = shim.ds_id(cname, t)
                self.stores[did] = DataStoreService(did, cname, "table", TableState(did))
            for o in c.get("objects", []):
                did = shim.ds_id(cname, o)
                self.stores[did] = DataStoreService(did, cname, "object", TableState(did))

        self.deployments: Dict[Tuple[str, str], Deployment] = {}
        self.running: Dict[str, set] = {}
        self.records: List[ExecutionRecord] = []
        # reporting indexes (kept in lock-step with ``records``)
        self._by_function: Dict[str, List[ExecutionRecord]] = {}
        self._done_records: List[ExecutionRecord] = []
        self._wf_records: Dict[str, List[ExecutionRecord]] = {}
        # sorted on demand (see workflow_records): arrivals append here and
        # only prefix queries need order, so the per-arrival insort memmove
        # is deferred to one amortized sort at query time
        self._wf_keys: List[str] = []
        self._wf_keys_sorted = True
        self._exec_ids = itertools.count()
        self.crash_policy: Optional[Callable[[Execution, shim.Effect], bool]] = None
        self.dropped: List[Tuple[str, str, Any]] = []   # (faas, function, payload)

        # Speculative-transfer support (the ``prefetch`` capability): pushes
        # in flight / landed, keyed (ds, key, dest_cloud) — a duplicate
        # Prefetch (at-least-once retry) is a no-op against this ledger, and
        # ``_ds_get`` at the destination pays only the residual wire time.
        # Empty unless handlers yield Prefetch, so prefetch-off timelines
        # take zero extra heap events and zero extra RNG draws.
        self.prefetch = True
        self._prefetch_ledger: Dict[Tuple[str, str, str], Dict[str, float]] = {}

        # Durable-execution support.  Signals are per-workflow latches: the
        # in-memory map serves live waits, the durable copy (written to the
        # canonical signal table — smallest table-store id, a deterministic
        # choice every instance over the same stores agrees on) survives
        # into adopted/fresh backends.
        self._signals: Dict[Tuple[str, str], Any] = {}
        self._signal_waiters: Dict[Tuple[str, str], List[Execution]] = {}
        self._signal_table: Optional[str] = min(
            (d for d, s in self.stores.items() if s.kind == "table"),
            default=None)

        # per-effect-type dispatch (engine invariant: extend this table, do
        # not add isinstance chains)
        self._dispatch: Dict[type, Callable] = {
            shim.Now: self._perform_now,
            shim.Trace: self._perform_trace,
            shim.RunUser: self._perform_run_user,
            shim.CreateClient: self._perform_create_client,
            shim.Invoke: self._perform_invoke,
            shim.DsCreate: self._perform_ds,
            shim.DsGet: self._perform_ds,
            shim.DsAppendGetList: self._perform_ds,
            shim.DsUpdateBitmap: self._perform_ds,
            shim.DsListPrefix: self._perform_ds,
            shim.DsDelete: self._perform_ds,
            shim.Parallel: self._perform_parallel,
            shim.Sleep: self._perform_sleep,
            shim.WaitForSignal: self._perform_wait_signal,
            shim.Prefetch: self._perform_prefetch,
        }
        self._ds_ops: Dict[type, Callable] = {
            shim.DsCreate: self._ds_create,
            shim.DsGet: self._ds_get,
            shim.DsAppendGetList: self._ds_append_get_list,
            shim.DsUpdateBitmap: self._ds_update_bitmap,
            shim.DsListPrefix: self._ds_list_prefix,
            shim.DsDelete: self._ds_delete,
        }

    # ---- topology helpers -----------------------------------------------------

    def rtt_ms(self, cloud_a: str, cloud_b: str) -> float:
        return self.cost.rtt_ms(cloud_a, cloud_b)

    def transfer_ms(self, cloud_a: str, cloud_b: str, nbytes: int) -> float:
        """Latency of moving nbytes between clouds (RTT + wire time) — the
        shared :class:`repro_torch.core.costmodel.CostModel`, so the placement
        planner predicts exactly what the interpreter charges."""
        return self.cost.transfer_ms(cloud_a, cloud_b, nbytes)

    def _jit(self, ms: float) -> float:
        return ms * (1.0 + self.rng.random() * self.jitter)

    def _wire_flow(self, a: str, b: str, nbytes: int) -> float:
        """Wire time of one transfer, registering it as an in-flight flow
        when the a↔b link has a pinned capacity (contention-aware sharing).
        Uncapped links take the zero-overhead path — no flow events, no
        extra RNG draws — so default-topology timelines are untouched."""
        if nbytes <= 0:
            return 0.0
        topo = self.topology
        if a != b and topo.tracks_contention(a, b):
            topo.open_flow(a, b, nbytes)
            wire = self.cost.wire_ms(a, b, nbytes)   # sees this flow too
            self.after(wire, topo.close_flow, a, b, nbytes)
            return wire
        return self.cost.wire_ms(a, b, nbytes)

    def _wire_flow_roundtrip(self, a: str, b: str, up: int, down: int) -> float:
        """Wire time of a request/response pair (coordination ops).  The two
        legs are sequential, so under contention they occupy the link as ONE
        flow of ``up + down`` bytes — not two simultaneous flows, which
        would double-count the op against the pair's flow budget."""
        topo = self.topology
        if a != b and topo.tracks_contention(a, b):
            return self._wire_flow(a, b, up + down)
        return self.cost.wire_ms(a, b, up) + self.cost.wire_ms(a, b, down)

    # ---- deployment & invocation ----------------------------------------------

    def catalog(self):
        """Service directory of this simulated substrate (Backend protocol),
        with the same catalog rules as every backend (``shim.build_catalog``)."""
        return shim.build_catalog(self.stores, self.faas)

    def deploy(self, dep: Deployment) -> None:
        if dep.faas not in self.faas:
            raise KeyError(f"unknown FaaS system {dep.faas}")
        self.deployments[(dep.faas, dep.function)] = dep

    def submit(self, faas: str, function: str, payload: Any, t: float = 0.0) -> None:
        """External client async-invokes ``function`` after a delay of ``t``
        virtual ms (the Backend-protocol contract — before the first ``run``
        the clock is 0, so the delay doubles as an absolute arrival time).
        Negative delays are rejected loudly, never clamped."""
        if t < 0:
            raise ValueError(f"submit delay t={t} ms must be >= 0")
        self.after(t, self._enqueue, faas, function, payload, 0)

    def at(self, t: float, fn: Callable[..., None], *args: Any) -> None:
        if t < self.now:
            t = self.now
        heapq.heappush(self._heap, (t, next(self._seq), fn, args))

    def after(self, dt: float, fn: Callable[..., None], *args: Any) -> None:
        # hot path: dt is never negative, so no clamp — push directly
        heapq.heappush(self._heap, (self.now + dt, next(self._seq), fn, args))

    def _enqueue(self, faas_id_: str, function: str, payload: Any, attempt: int) -> None:
        """Queue an accepted async invocation for execution (at-least-once)."""
        dep = self.deployments.get((faas_id_, function))
        if dep is None:
            raise KeyError(f"function {function} not deployed on {faas_id_}")
        rec = ExecutionRecord(next(self._exec_ids), function, faas_id_,
                              t_queued=self.now, attempt=attempt, payload=payload)
        self.records.append(rec)
        bucket = self._by_function.get(function)
        if bucket is None:
            self._by_function[function] = bucket = []
        bucket.append(rec)
        wfid = None
        if payload.__class__ is dict:
            ctl = payload.get("Control")
            if ctl.__class__ is dict:
                wfid = ctl.get("workflowId")
            else:
                wfid = payload.get("workflow_id")
        if wfid is not None:
            wfid = str(wfid)
            wbucket = self._wf_records.get(wfid)
            if wbucket is None:
                self._wf_records[wfid] = wbucket = []
                self._wf_keys.append(wfid)
                self._wf_keys_sorted = False
            wbucket.append(rec)
        self.after(self._jit(cal.ASYNC_QUEUE_MS), self._start_queued,
                   dep, payload, rec)

    def _start_queued(self, dep: Deployment, payload: Any,
                      rec: ExecutionRecord) -> None:
        """Queue dwell elapsed: acquire a slot (if this FaaS meters
        concurrency) and start the execution."""
        faas = self.faas[dep.faas]
        if not faas.up_at(self.now):
            rec.status = "crashed"
            self._retry(dep, payload, rec.attempt)
            return
        if faas.concurrency is not None:
            if faas.slots_busy < faas.slots_total:       # warm slot free
                faas.slots_busy += 1
            elif faas.slots_total < faas.concurrency:    # mint a cold slot
                faas.slots_total += 1
                faas.slots_busy += 1
                faas.cold_starts += 1
                if faas.cold_start_ms > 0.0:
                    self.after(self._jit(faas.cold_start_ms),
                               self._begin_execution, dep, payload, rec)
                    return
            else:                                        # saturated: wait
                faas.pending.append((dep, payload, rec))
                return
        Execution(self, dep, payload, rec).start()

    def _begin_execution(self, dep: Deployment, payload: Any,
                         rec: ExecutionRecord) -> None:
        """Start an execution that already holds a slot (post cold start)."""
        faas = self.faas[dep.faas]
        if not faas.up_at(self.now):                     # outage hit mid-cold-start
            rec.status = "crashed"
            self._release_slot(faas)
            self._retry(dep, payload, rec.attempt)
            return
        Execution(self, dep, payload, rec).start()

    def _release_slot(self, faas: FaaSSystem) -> None:
        if faas.concurrency is None:
            return
        faas.slots_busy -= 1
        # hand the freed warm slot to the queue head (crashed pops drain on)
        while faas.pending and faas.slots_busy < faas.slots_total:
            head, payload, rec = faas.pending.popleft()
            if head is _RESUME:              # a suspended execution waking up
                faas.slots_busy += 1
                self._resume_execution(payload, rec)   # (ex, value)
                break
            dep = head
            if not faas.up_at(self.now):
                rec.status = "crashed"
                self._retry(dep, payload, rec.attempt)
                continue
            faas.slots_busy += 1
            Execution(self, dep, payload, rec).start()
            break

    def _retry(self, dep: Deployment, payload: Any, attempt: int) -> None:
        if attempt < dep.max_retries:
            self.after(self._jit(cal.RETRY_BACKOFF_MS), self._enqueue,
                       dep.faas, dep.function, payload, attempt + 1)
        else:
            self.dropped.append((dep.faas, dep.function, payload))

    def _crash_execution(self, ex: Execution, reason: str) -> None:
        ex.kill()
        self._retry(ex.dep, ex.payload, ex.record.attempt)

    # ---- suspension (Sleep / WaitForSignal) ----------------------------------

    def _suspend(self, ex: Execution) -> None:
        """Park a live execution without a slot: it leaves the running set
        (outages cannot kill what is not running), frees its concurrency
        slot, and stops accruing GB·s — a 1-hour sleep is one heap event."""
        ex.suspend_t0 = self.now
        ex.record.status = "suspended"
        self.running.get(ex.dep.faas, set()).discard(ex)
        self._release_slot(ex.faas_obj)

    def _wake(self, ex: Execution, value: Any) -> None:
        """Timer fired / signal arrived: re-acquire a slot and resume.
        Mirrors :meth:`_start_queued`'s acquisition (warm / mint-cold /
        queue as a ``_RESUME``-tagged pending entry)."""
        if not ex.alive:
            return
        faas = ex.faas_obj
        if not faas.up_at(self.now):
            # outage at wake-up: crash WITHOUT slot release (a suspended
            # execution holds none) and let at-least-once re-deliver
            ex.suspended_ms += self.now - ex.suspend_t0
            ex.alive = False
            ex.record.t_end = self.now
            ex.record.status = "crashed"
            mem = ex.dep.memory_gb or faas.flavor.memory_gb
            self.bill.charge_execution(
                faas.cloud, mem,
                ex.record.t_end - ex.record.t_start - ex.suspended_ms,
                faas.flavor.price_per_gb_s)
            self._retry(ex.dep, ex.payload, ex.record.attempt)
            return
        if faas.concurrency is not None:
            if faas.slots_busy < faas.slots_total:
                faas.slots_busy += 1
            elif faas.slots_total < faas.concurrency:
                faas.slots_total += 1
                faas.slots_busy += 1
                faas.cold_starts += 1
                if faas.cold_start_ms > 0.0:
                    self.after(self._jit(faas.cold_start_ms),
                               self._resume_execution, ex, value)
                    return
            else:
                faas.pending.append((_RESUME, ex, value))
                return
        self._resume_execution(ex, value)

    def _resume_execution(self, ex: Execution, value: Any) -> None:
        """Resume a suspended execution that now holds a slot."""
        faas = ex.faas_obj
        if not ex.alive:
            self._release_slot(faas)
            return
        if not faas.up_at(self.now):       # outage hit during the cold start
            self._crash_execution(ex, reason="outage")   # kill() frees the slot
            return
        ex.suspended_ms += self.now - ex.suspend_t0
        ex.record.status = "running"
        self.running.setdefault(ex.dep.faas, set()).add(ex)
        ex.resume(value)

    def _perform_sleep(self, ex: Execution, effect: shim.Sleep,
                       ok: Callable, err: Callable) -> None:
        if effect.ms <= 0:
            ok(None)
            return
        self._suspend(ex)
        self.after(effect.ms, self._wake, ex, None)

    def _perform_wait_signal(self, ex: Execution, effect: shim.WaitForSignal,
                             ok: Callable, err: Callable) -> None:
        scope = effect.scope
        if not scope:
            err(shim.ShimError(
                f"WaitForSignal({effect.name!r}) has no workflow scope"))
            return
        key = (scope, effect.name)
        if key in self._signals:                       # already delivered
            ok(self._signals[key])
            return
        if self._signal_table is not None:             # durable latch (adopted stores)
            stored = self.stores[self._signal_table].state.items.get(
                signal_key(scope, effect.name))
            if stored is not None:
                self._signals[key] = stored["v"]
                ok(stored["v"])
                return
        self._suspend(ex)
        self._signal_waiters.setdefault(key, []).append(ex)

    def signal(self, workflow_id: str, name: str, value: Any = True,
               t: float = 0.0) -> None:
        """Deliver a named signal to one workflow after ``t`` virtual ms
        (same delay contract as :meth:`submit`).  First delivery wins; the
        latch is persisted to the canonical signal table so adopted stores
        replay it."""
        if t < 0:
            raise ValueError(f"signal delay t={t} ms must be >= 0")
        self.after(t, self._deliver_signal, str(workflow_id), name, value)

    def _deliver_signal(self, wfid: str, name: str, value: Any) -> None:
        if self._signal_table is not None:
            st = self.stores[self._signal_table].state
            if not st.create_if_absent(signal_key(wfid, name), {"v": value}):
                value = st.get(signal_key(wfid, name))["v"]   # first delivery won
        key = (wfid, name)
        self._signals.setdefault(key, value)
        value = self._signals[key]
        for ex in self._signal_waiters.pop(key, ()):
            self._wake(ex, value)

    # ---- failure injection ---------------------------------------------------

    def schedule_outage(self, target: str, t0: float, t1: float) -> None:
        """Take a FaaS system ("cloud/sys") or a whole cloud ("cloud") down
        over [t0, t1).  Running executions on it are killed at t0."""
        systems = [f for f in self.faas.values()
                   if f.id == target or f.cloud == target]
        if not systems:
            raise KeyError(f"no FaaS system matches {target}")
        for f in systems:
            f.add_outage(t0, t1)
            self.at(t0, self._kill_running_on, f.id)

    def _kill_running_on(self, fid: str) -> None:
        for ex in list(self.running.get(fid, ())):
            self._crash_execution(ex, reason="outage")

    # ---- effect interpreter ----------------------------------------------------

    @staticmethod
    def _resolve(table: Dict[type, Callable], effect: shim.Effect) -> Callable:
        """Nearest-base handler for a subclassed effect, cached in ``table``
        under the concrete class (shared by perform() and _ds_arrive)."""
        for klass in effect.__class__.__mro__[1:]:
            handler = table.get(klass)
            if handler is not None:
                table[effect.__class__] = handler
                return handler
        raise TypeError(f"unknown effect {effect!r}")

    def perform(self, ex: Execution, effect: shim.Effect,
                ok: Callable[[Any], None], err: Callable[[BaseException], None]) -> None:
        handler = self._dispatch.get(effect.__class__)
        if handler is None:
            handler = self._resolve(self._dispatch, effect)
        handler(ex, effect, ok, err)

    def _perform_now(self, ex: Execution, effect: shim.Effect,
                     ok: Callable, err: Callable) -> None:
        ok(self.now)

    def _perform_trace(self, ex: Execution, effect: shim.Trace,
                       ok: Callable, err: Callable) -> None:
        ex.record.phases.append((self.now, effect.phase))
        ok(None)

    def _perform_run_user(self, ex: Execution, effect: shim.RunUser,
                          ok: Callable, err: Callable) -> None:
        dur = self._jit(ex.dep.workload.duration_ms(ex.faas_obj.flavor))
        out = ex.dep.workload.output(effect.data)
        self.after(dur, ok, out)

    def _perform_create_client(self, ex: Execution, effect: shim.CreateClient,
                               ok: Callable, err: Callable) -> None:
        self.after(self._jit(cal.CLIENT_CREATE_MS), ok, effect.target)

    # -- invoke ------------------------------------------------------------------

    def _perform_invoke(self, ex: Execution, effect: shim.Invoke,
                        ok: Callable[[Any], None],
                        err: Callable[[BaseException], None]) -> None:
        target = self.faas.get(effect.faas)
        if target is None:
            err(shim.InvocationError(f"unknown FaaS {effect.faas}"))
            return
        nbytes = effect.size_bytes or estimate_size(effect.payload)
        if nbytes > target.payload_quota:
            err(shim.PayloadTooLarge(
                f"{nbytes}B > quota {target.payload_quota}B on {effect.faas}"))
            return
        here = ex.cloud
        rtt = self._jit(self.rtt_ms(here, target.cloud))
        if self._net_jitter:
            rtt += self.cost.sample_rtt_jitter(here, target.cloud,
                                               self.rng.random())
        self.after(rtt / 2, self._invoke_arrive,
                   here, effect, target, nbytes, rtt, ok, err)

    def _invoke_arrive(self, here: str, effect: shim.Invoke, target: FaaSSystem,
                       nbytes: int, rtt: float, ok: Callable, err: Callable) -> None:
        if not target.up_at(self.now):
            # connection refused — caller learns after the return trip
            # (``rtt`` already carries jitter; no second draw)
            self.after(rtt / 2, err,
                       shim.InvocationError(f"{effect.faas} is down"))
            return
        # control-plane accept + payload transfer; bill egress if cross-cloud
        if target.cloud != here:
            self.bill.charge_egress(here, nbytes,
                                    self.cost.egress_price_per_gb(here))
        self.bill.charge_invoke(target.cloud)
        accept = self._jit(cal.INVOKE_API_MS) + self._wire_flow(
            here, target.cloud, nbytes)
        self.after(accept, self._enqueue, effect.faas, effect.function,
                   effect.payload, 0)
        self.after(accept + rtt / 2, ok, True)

    # -- prefetch (speculative cross-cloud push) ----------------------------------

    def _perform_prefetch(self, ex: Execution, effect: shim.Prefetch,
                          ok: Callable[[Any], None],
                          err: Callable[[BaseException], None]) -> None:
        """Open a *real* flow for ``ds[key]`` toward cloud ``dest`` now,
        ahead of the consumer's DsGet (the ``prefetch`` capability).

        The push is modelled store-side: the committed value streams from
        the store's cloud to the destination through the same
        contention-aware :class:`Topology` accounting as on-demand
        transfers, so oversubscription stays honest — a prefetch stream
        stretches every concurrent flow's ``contention_factor`` exactly
        like a demand read would.  The issuing handler resumes after a
        local API call; the transfer itself proceeds independently and
        lands in ``_prefetch_ledger``, where the destination's ``_ds_get``
        finds it and pays only ``max(0, eta - now)`` plus a residual
        transfer for any under-predicted bytes.

        Idempotent by ledger key ``(ds, key, dest)``: a retried attempt
        re-yielding the same push is a no-op (no double-transfer, no
        double-bill).  A crashed issuer needs no undo — the pushed bytes
        were billed honestly (they really crossed the wire) and the ledger
        entry only ever *reduces* a later read's wait, never changes its
        value (§4.1 conditional creates make checkpoints immutable)."""
        store = self.stores.get(effect.ds)
        if store is None:
            err(shim.DataStoreError(f"unknown datastore {effect.ds}"))
            return
        dest = effect.dest
        lkey = (effect.ds, effect.key, dest)
        if store.cloud == dest or lkey in self._prefetch_ledger:
            # intra-cloud (nothing to push) or duplicate (at-least-once
            # retry): report "no push started" without touching the wire
            self.after(0.0, ok, False)
            return
        val = store.state.get(effect.key)
        if val is None:
            # value not committed yet (mis-ordered directive): degrade to
            # the on-demand path rather than pushing a tombstone
            self.after(0.0, ok, False)
            return
        actual = estimate_size(val)
        # can't push more bytes than exist; a *under*-prediction pushes the
        # predicted prefix and leaves the rest to the residual fallback
        pushed = min(effect.size_bytes, actual) if effect.size_bytes else actual
        if pushed <= 0:
            self.after(0.0, ok, False)
            return
        src = store.cloud
        topo = self.topology
        tracked = topo.tracks_contention(src, dest)
        if tracked and topo.contention_factor(src, dest) > 1.0:
            # admission control: the link is already oversubscribed —
            # speculation only wins by soaking *idle* bandwidth, and a push
            # into a saturated pipe would stretch every demand flow (and
            # its own ETA) for no overlap gain.  Decline; the consumer's
            # DsGet falls back to an on-demand transfer, which pays the
            # same contention it would have paid anyway.
            self.after(0.0, ok, False)
            return
        if tracked:
            topo.open_flow(src, dest, pushed)
        wire = self.cost.wire_ms(src, dest, pushed)  # open-time stretch
        factor = topo.contention_factor(src, dest) if tracked else 1.0
        # command hop to the store, then first byte toward dest
        start = self.rtt_ms(ex.cloud, src) / 2 + self.rtt_ms(src, dest) / 2
        self._prefetch_ledger[lkey] = {
            "eta": self.now + start + wire, "bytes": float(pushed)}
        # egress billed at push time, once — the consuming _ds_get bills
        # only the residual, so retries can never double-charge
        self.bill.charge_egress(src, pushed,
                                self.cost.egress_price_per_gb(src))
        if tracked:
            self.after(start + wire, self._prefetch_close,
                       lkey, src, dest, pushed, wire / factor, factor)
        # fire-and-forget: the push is a store-side trigger (the value is
        # already committed there) — the issuing handler resumes at once,
        # else the initiation cost would eat the overlap it buys
        self.after(0.0, ok, True)

    def _prefetch_close(self, lkey: Tuple[str, str, str], src: str, dest: str,
                        nbytes: int, base_ms: float, factor_open: float) -> None:
        """Bounded re-pricing at a prefetch flow's predicted completion.

        ``CostModel.wire_ms`` samples the contention stretch *once* at
        flow-open; a long-lived prefetch flow can outlive the flows it was
        priced against.  At the open-time ETA we recompute the factor: if
        the link got *more* crowded, the flow stays open for one residual
        stretch (and the ledger ETA moves so consumers keep waiting
        honestly); if it got less crowded (or unchanged) we just close.
        Exactly one re-pricing round — the extension itself is priced at
        the now-current factor and never re-examined, which bounds the
        error to one window instead of recursing forever (documented in
        ``CostModel.wire_ms``)."""
        topo = self.topology
        factor_now = topo.contention_factor(src, dest)
        extra = base_ms * (factor_now - factor_open)
        if extra > 1e-9:
            ent = self._prefetch_ledger.get(lkey)
            if ent is not None:
                ent["eta"] += extra
            self.after(extra, topo.close_flow, src, dest, nbytes)
        else:
            topo.close_flow(src, dest, nbytes)

    # -- datastore -----------------------------------------------------------------

    def _perform_ds(self, ex: Execution, effect: shim.Effect,
                    ok: Callable[[Any], None], err: Callable[[BaseException], None]) -> None:
        store = self.stores.get(effect.ds)
        if store is None:
            err(shim.DataStoreError(f"unknown datastore {effect.ds}"))
            return
        here = ex.cloud
        rtt = self.rtt_ms(here, store.cloud)
        if self._net_jitter:
            rtt += self.cost.sample_rtt_jitter(here, store.cloud,
                                               self.rng.random())
        self.after(rtt / 2, self._ds_arrive, here, effect, store, rtt, ok, err)

    def _ds_arrive(self, here: str, effect: shim.Effect, store: DataStoreService,
                   rtt: float, ok: Callable, err: Callable) -> None:
        # The store itself is assumed HA (managed service); only the
        # network from a dead cloud fails — modelled at the caller side.
        op = self._ds_ops.get(effect.__class__)
        if op is None:
            op = self._resolve(self._ds_ops, effect)
        result, op_ms, w, r, moves = op(here, store, effect)
        if w:
            self.bill.charge_ds_write(store.cloud, w)
        if r:
            self.bill.charge_ds_read(store.cloud, r)
        for src, nb in moves:
            if nb:
                self.bill.charge_egress(src, nb,
                                        self.cost.egress_price_per_gb(src))
        if isinstance(result, BaseException):
            self.after(self._jit(op_ms) + rtt / 2, err, result)
        else:
            self.after(self._jit(op_ms) + rtt / 2, ok, result)

    # Each op returns (result, op_ms, writes, reads, moves) where moves is a
    # tuple of (egress_src_cloud, nbytes) for cross-cloud payload movement.

    def _ds_create(self, here: str, store: DataStoreService,
                   effect: shim.DsCreate):
        nbytes = effect.size_bytes or estimate_size(effect.value)
        created = store.state.create_if_absent(effect.key, effect.value)
        wire = self._wire_flow(here, store.cloud, nbytes)
        moves = ((here, nbytes),) if store.cloud != here else ()
        return created, store.write_ms() + wire, 1, 0, moves

    def _ds_get(self, here: str, store: DataStoreService, effect: shim.DsGet):
        val = store.state.get(effect.key)
        nbytes = estimate_size(val)
        # prefetched value: pay only the remaining in-flight time plus a
        # residual on-demand transfer for under-predicted bytes.  The
        # ledger is empty unless Prefetch effects ran, so the prefetch-off
        # path short-circuits here — zero extra events, zero RNG draws.
        if store.cloud != here and self._prefetch_ledger and val is not None:
            ent = self._prefetch_ledger.get((effect.ds, effect.key, here))
            if ent is not None:
                residual = nbytes - int(ent["bytes"])
                wire = max(0.0, ent["eta"] - self.now)
                moves: tuple = ()
                if residual > 0:   # mis-predicted size: fall back honestly
                    wire += self._wire_flow(here, store.cloud, residual)
                    moves = ((store.cloud, residual),)
                return val, store.read_ms() + wire, 0, 1, moves
        wire = self._wire_flow(here, store.cloud, nbytes)
        moves = ((store.cloud, nbytes),) if store.cloud != here else ()
        return val, store.read_ms() + wire, 0, 1, moves

    def _ds_append_get_list(self, here: str, store: DataStoreService,
                            effect: shim.DsAppendGetList):
        val = store.state.append_and_get_list(effect.key, effect.items)
        op_ms = store.write_ms() + store.read_ms()
        moves: tuple = ()
        if store.cloud != here:
            # coordination payloads ride the wire like any other transfer:
            # items up, the refreshed list back down
            up = estimate_size(effect.items)
            down = estimate_size(val)
            op_ms += self._wire_flow_roundtrip(here, store.cloud, up, down)
            moves = ((here, up), (store.cloud, down))
        return val, op_ms, 1, 1, moves

    def _ds_update_bitmap(self, here: str, store: DataStoreService,
                          effect: shim.DsUpdateBitmap):
        val = store.state.update_bitmap(effect.index, effect.key)
        op_ms = store.write_ms() + store.read_ms()
        moves: tuple = ()
        if store.cloud != here:
            up = 8                                # the bit index
            down = estimate_size(val)             # the refreshed bitmap
            op_ms += self._wire_flow_roundtrip(here, store.cloud, up, down)
            moves = ((here, up), (store.cloud, down))
        return val, op_ms, 1, 1, moves

    def _ds_list_prefix(self, here: str, store: DataStoreService,
                        effect: shim.DsListPrefix):
        return store.state.list_prefix(effect.prefix), store.read_ms(), 0, 1, ()

    def _ds_delete(self, here: str, store: DataStoreService,
                   effect: shim.DsDelete):
        n = store.state.delete(effect.keys)
        return n, store.write_ms(), len(list(effect.keys)), 0, ()

    # -- parallel -----------------------------------------------------------------

    def _perform_parallel(self, ex: Execution, effect: shim.Parallel,
                          ok: Callable[[Any], None], err: Callable) -> None:
        n = len(effect.effects)
        if n == 0:
            ok([])
            return
        if any(type(s) in (shim.Sleep, shim.WaitForSignal)
               for s in effect.effects):
            # Suspension releases the whole execution's slot — meaningless
            # for one branch of a concurrent group; reject loudly.
            err(shim.ShimError("Sleep/WaitForSignal cannot run inside Parallel"))
            return
        results: List[Any] = [None] * n
        remaining = [n]

        def done(i: int, value: Any) -> None:
            results[i] = value
            remaining[0] -= 1
            if remaining[0] == 0:
                ok(list(results))

        for i, sub in enumerate(effect.effects):
            self.perform(ex, sub,
                         ok=(lambda v, i=i: done(i, v)),
                         err=(lambda e, i=i: done(i, e)))

    # ---- main loop ----------------------------------------------------------------

    def run(self, t_max: float = 1e9) -> float:
        """Drain the event heap (up to t_max). Returns the final clock."""
        heap = self._heap
        pop = heapq.heappop
        n = 0
        while heap:
            ev = pop(heap)
            t = ev[0]
            if t > t_max:
                heapq.heappush(heap, ev)   # keep it for a resumed run
                self.now = t_max
                break
            self.now = t
            ev[2](*ev[3])
            n += 1
        self.events_processed += n
        return self.now

    # ---- durable-execution capability surface ---------------------------------

    def journal(self) -> List[TableState]:
        """The table states :func:`repro_torch.core.durable.resume` scans for
        started-but-unfinished effect journals (the ``journal`` capability).
        SimCloud qualifies because :meth:`adopt_stores` carries these states
        into a fresh instance."""
        return [s.state for s in self.stores.values() if s.kind == "table"]

    def adopt_stores(self, other: "SimCloud") -> None:
        """Take over another SimCloud's datastore contents — the fresh-
        backend-over-the-same-stores idiom durable recovery needs: build a
        new SimCloud, adopt the dead one's stores, re-``deploy`` the spec,
        then ``DeployedWorkflow.resume()`` replays the journals."""
        for did, store in self.stores.items():
            src = other.stores.get(did)
            if src is not None:
                store.state = src.state

    # ---- reporting -----------------------------------------------------------------

    def executions_of(self, function: str) -> List[ExecutionRecord]:
        return list(self._by_function.get(function, ()))

    def completed(self) -> List[ExecutionRecord]:
        return sorted(self._done_records, key=lambda r: r.exec_id)

    def workflow_records(self, prefix: str) -> List[ExecutionRecord]:
        """All execution records whose workflow id starts with ``prefix``
        (batch spin-offs carry a ``<wfid>-batchN`` id), in creation order —
        a bisect over the sorted workflow-id index, not a record scan."""
        keys = self._wf_keys
        if not self._wf_keys_sorted:
            keys.sort()
            self._wf_keys_sorted = True
        i = bisect_left(keys, prefix)
        out: List[ExecutionRecord] = []
        while i < len(keys) and keys[i].startswith(prefix):
            out.extend(self._wf_records[keys[i]])
            i += 1
        out.sort(key=lambda r: r.exec_id)
        return out


def timeline_digest(sim: SimCloud) -> str:
    """SHA-256 over every record's schedule + the final clock — the
    regression oracle for 'same seed ⇒ bit-identical timelines'."""
    h = hashlib.sha256()
    for r in sim.records:
        h.update(repr((r.exec_id, r.function, r.faas, r.t_queued, r.t_start,
                       r.t_end, r.status, r.attempt)).encode())
    h.update(repr(sim.now).encode())
    return h.hexdigest()
