"""Local real-execution backend: the same orchestrator, truly concurrent.

Workflow nodes execute *for real* in-process (their ``Workload.fn`` is an
arbitrary Python/JAX callable — e.g. a jitted train/serve step) on per-FaaS
**worker pools** with configurable concurrency slots (mirroring
``SimCloud(concurrency=...)``), so ``Parallel`` effects and fan-outs
genuinely overlap in wall-clock time — the 10-thread fan-out of §4.1.2 runs
on ten real threads, not a sequential loop.

Datastore effects hit an in-memory **linearizable store**: per-key locks
serialize value read-modify-writes and one index lock serializes key-set
mutations, so the §4.1 conditional-create / append / bitmap primitives stay
atomic under real thread races.  Invocations flow through per-FaaS FIFO
queues with at-least-once redelivery; failure injection works mid-flight
(``set_down(..., kill_running=True)`` aborts running attempts at their next
effect boundary — exactly SimCloud's continuation-disarm hazard) and a
``crash_policy`` hook can abort any attempt between two side effects, so
exactly-once is exercised under real races, not just simulated ones.

The runner implements the full :class:`repro_torch.backends.shim.Backend`
protocol — deploy through the one ``repro_torch.core.workflow.deploy`` path
(``deploy_local`` is a thin alias) and query results through
``executions_of`` / ``completed`` / ``workflow_records`` exactly as on
SimCloud.  Invocations that exhaust the retry budget are recorded as
``"dropped"`` :class:`ExecutionRecord`\\ s (and counted in ``dropped``),
never silently discarded.

This is the backend the end-to-end training example uses: each pipeline
stage (data → step → checkpoint-commit) is a workflow function and the
exactly-once protocol of §4.1 doubles as the trainer's step-commit.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from bisect import bisect_left, insort
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.backends.datastore import (PersistentTableState, TableState,
                                      signal_key, wal_path)
from repro_torch.backends.shim import (Deployment, ExecutionRecord, Workload,
                                 estimate_size)


def _now_ms() -> float:
    return time.monotonic() * 1e3


class _Killed(BaseException):
    """The current attempt was aborted between two effects (outage /
    injected crash).  A ``BaseException`` so the orchestrator's
    ``except ShimError`` clauses cannot swallow it — the generator is
    abandoned, mirroring SimCloud disarming a continuation."""


class _Suspend(BaseException):
    """Control flow for ``Sleep``/``WaitForSignal``: the current attempt
    parks — its generator is kept alive off-thread and the worker is
    released (zero concurrency slots while suspended).  ``arrange`` is
    called with a resume callback that re-enqueues the parked execution
    when the wake condition fires.  A ``BaseException`` for the same
    reason as :class:`_Killed`."""

    def __init__(self, arrange: Callable[[Callable[[Any], None]], None]):
        self.arrange = arrange


# ==========================================================================
# Linearizable store under real threads
# ==========================================================================


class LockedTableState:
    """Thread-safe :class:`TableState`: a linearizable key-value namespace.

    Per-key locks serialize value read-modify-writes (get / update_bitmap);
    one *index* lock serializes key-set mutations (create / append-create /
    delete) and prefix scans, because the sorted prefix index is shared
    state.  Lock order is always index → key, never the reverse, so the two
    levels cannot deadlock.
    """

    def __init__(self, state: TableState, cloud: str, kind: str = "table"):
        self.state = state
        self.cloud = cloud
        self.kind = kind
        self._index = threading.RLock()
        self._key_locks: Dict[str, threading.RLock] = {}
        self._key_guard = threading.Lock()

    def _key_lock(self, key: str) -> threading.RLock:
        with self._key_guard:
            lk = self._key_locks.get(key)
            if lk is None:
                lk = self._key_locks[key] = threading.RLock()
            return lk

    # -- Table 2 primitives (each atomic under its locks) -------------------

    def create_if_absent(self, key: str, value: Any) -> bool:
        with self._index, self._key_lock(key):
            return self.state.create_if_absent(key, value)

    def get(self, key: str) -> Any:
        with self._key_lock(key):
            return self.state.get(key)

    def append_and_get_list(self, key: str, items) -> list:
        with self._index, self._key_lock(key):   # may create the key
            return self.state.append_and_get_list(key, items)

    def update_bitmap(self, index: int, key: str) -> list:
        with self._key_lock(key):
            return self.state.update_bitmap(index, key)

    def list_prefix(self, prefix: str) -> list:
        with self._index:
            return self.state.list_prefix(prefix)

    def delete(self, keys) -> int:
        # also takes each victim's key lock: a delete must not interleave
        # with an in-flight value RMW (get/update_bitmap hold only key locks)
        with self._index:
            n = 0
            for k in keys:
                with self._key_lock(k):
                    n += self.state.delete((k,))
            return n

    def __len__(self) -> int:
        return len(self.state)


# ==========================================================================
# Substrate entities
# ==========================================================================


class LocalFaaS:
    """One FaaS system of the local substrate: a pool of ``concurrency``
    worker threads plus an up/down flag for outage injection."""

    def __init__(self, id: str, cloud: str, flavor: cal.Flavor,
                 payload_quota: int, concurrency: int):
        self.id = id
        self.cloud = cloud
        self.flavor = flavor
        self.payload_quota = payload_quota
        self.concurrency = max(1, int(concurrency))
        self.down = False            # mutated under the runner lock
        self.kill_running = False    # down AND abort in-flight attempts


class LocalExecution:
    """One running attempt of a deployed function on a worker thread.

    Exposes the same probe surface as SimCloud's ``Execution``
    (``dep`` / ``record`` / ``effect_index``) so crash policies can be
    shared between backends.
    """

    __slots__ = ("runner", "dep", "faas", "record", "gen", "effect_index")

    def __init__(self, runner: "LocalRunner", dep: Deployment,
                 faas: LocalFaaS, record: ExecutionRecord):
        self.runner = runner
        self.dep = dep
        self.faas = faas
        self.record = record
        self.gen = dep.handler(record.payload)
        self.effect_index = 0

    def drive(self, value: Any = None) -> Any:
        """Step the effect generator to completion on this thread.  A
        parked attempt is resumed by calling ``drive(wake_value)`` again
        from whichever worker picks up its resume continuation."""
        runner = self.runner
        exc: Optional[BaseException] = None
        while True:
            try:
                effect = self.gen.send(value) if exc is None else self.gen.throw(exc)
            except StopIteration as stop:
                return stop.value
            # kill checks *between* effects: a down FaaS (kill_running) or a
            # crash policy aborts the attempt here — side effects already on
            # the wire stay applied, the §4.1.2 duplicate hazard
            if self.faas.kill_running:
                raise _Killed()
            cp = runner.crash_policy
            if cp is not None and cp(self, effect):
                raise _Killed()
            self.effect_index += 1
            value, exc = None, None
            try:
                value = runner._apply(self, effect)
            except shim.ShimError as e:
                exc = e


# ==========================================================================
# The runner
# ==========================================================================


class LocalRunner:
    """Concurrent interpreter for orchestrator effect generators.

    Implements the :class:`repro_torch.backends.shim.Backend` protocol: the
    execution surface (``deploy``/``submit``/``run``) plus the
    record-query surface (``catalog``/``executions_of``/``completed``/
    ``workflow_records``).  It intentionally provides **no** ``topology``
    capability — there is no simulated network to re-plan over — so
    ``DeployedWorkflow.replan()`` degrades to a ``CapabilityError``.

    ``concurrency`` maps FaaS ids ("aws/lambda") or cloud names ("aws") to
    a worker-thread count, or is a single int applied to every system
    (default 8 — enough for the paper's 10-way fan-out chunks to overlap).
    """

    def __init__(self, config: Optional[dict] = None, *,
                 concurrency: Union[int, Mapping[str, int]] = 8,
                 max_requeues: int = 8, retry_backoff_ms: float = 25.0,
                 store_dir: Optional[str] = None, prefetch: bool = True):
        self._config = config or cal.default_jointcloud()
        self.store_dir = store_dir
        if store_dir is not None:
            os.makedirs(store_dir, exist_ok=True)

        def _state(did: str) -> TableState:
            if store_dir is None:
                return TableState(did)
            return PersistentTableState(did, wal_path(store_dir, did))

        self.stores: Dict[str, LockedTableState] = {}
        self.faas: Dict[str, LocalFaaS] = {}
        for cname, c in self._config["clouds"].items():
            quota = cal.PAYLOAD_QUOTA.get(cname, cal.DEFAULT_PAYLOAD_QUOTA)
            for sysname, flavor in c.get("faas", {}).items():
                fid = shim.faas_id(cname, sysname)
                if isinstance(concurrency, Mapping):
                    conc = concurrency.get(fid, concurrency.get(cname, 8))
                else:
                    conc = concurrency
                self.faas[fid] = LocalFaaS(fid, cname, flavor, quota, conc)
            for t in c.get("tables", []):
                did = shim.ds_id(cname, t)
                self.stores[did] = LockedTableState(_state(did), cname, "table")
            for o in c.get("objects", []):
                did = shim.ds_id(cname, o)
                self.stores[did] = LockedTableState(_state(did), cname, "object")

        # durable execution: the ``journal`` capability is an *attribute*
        # (None when absent) so the Backend-protocol getattr probe is falsy
        # on a purely in-memory runner, whose journal dies with the process.
        # WAL-backed stores — or stores adopted from a live runner — qualify.
        self.journal: Optional[Callable[[], List[TableState]]] = (
            self._journal_tables if store_dir is not None else None)
        # signal latches: first delivery wins; the durable copy lives in the
        # canonical signal table so re-waits after a crash observe it
        self._signals: Dict[Tuple[str, str], Any] = {}
        self._signal_waiters: Dict[Tuple[str, str],
                                   List[Callable[[Any], None]]] = {}
        self._signal_table = min(
            (d for d, s in self.stores.items() if s.kind == "table"),
            default=None)

        # speculative pushes (the ``prefetch`` capability, same falsy-
        # attribute probe idiom as ``journal``): genuine worker threads copy
        # a *committed* checkpoint into a staging cache at upstream-dispatch
        # time; the consumer's DsGet joins the push (event wait) instead of
        # hitting the store.  The cache is read-only w.r.t. table state — a
        # push can never write through to a store, so a prefetched-but-
        # crashed attempt cannot leak partial inputs past the journal.
        self.prefetch: bool = bool(prefetch)
        self._prefetch_cache: Dict[Tuple[str, str], dict] = {}

        self.deployments: Dict[Tuple[str, str], Deployment] = {}
        self.records: List[ExecutionRecord] = []
        self.dropped: List[Tuple[str, str, Any]] = []   # (faas, function, payload)
        self.max_requeues = max_requeues
        self.retry_backoff_ms = retry_backoff_ms
        self.crash_policy: Optional[Callable[[LocalExecution, shim.Effect], bool]] = None
        self._errors: List[BaseException] = []   # fatal (non-Shim) attempt errors

        # scheduler state — everything below is guarded by ``_lock``
        self._lock = threading.RLock()
        self._quiesce = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {fid: deque() for fid in self.faas}
        self._qcond: Dict[str, threading.Condition] = {
            fid: threading.Condition(self._lock) for fid in self.faas}
        self._outstanding = 0        # logical invocations not yet terminal
        self._stop = False
        self._workers: List[threading.Thread] = []
        self._exec_ids = itertools.count()
        # reporting indexes (kept in lock-step with ``records``)
        self._by_function: Dict[str, List[ExecutionRecord]] = {}
        self._done_records: List[ExecutionRecord] = []
        self._wf_records: Dict[str, List[ExecutionRecord]] = {}
        self._wf_keys: List[str] = []            # sorted, for prefix queries

        # per-effect-type dispatch (same invariant as SimCloud: extend the
        # table, do not add isinstance chains)
        self._dispatch: Dict[type, Callable] = {
            shim.Now: self._perform_now,
            shim.Trace: self._perform_trace,
            shim.CreateClient: self._perform_create_client,
            shim.RunUser: self._perform_run_user,
            shim.Invoke: self._perform_invoke,
            shim.Parallel: self._perform_parallel,
            shim.DsCreate: self._perform_ds,
            shim.DsGet: self._perform_ds,
            shim.DsAppendGetList: self._perform_ds,
            shim.DsUpdateBitmap: self._perform_ds,
            shim.DsListPrefix: self._perform_ds,
            shim.DsDelete: self._perform_ds,
            shim.Sleep: self._perform_sleep,
            shim.WaitForSignal: self._perform_wait_signal,
            shim.Prefetch: self._perform_prefetch,
        }

    # ---- Backend protocol: deployment / invocation -------------------------

    def catalog(self):
        """Service directory of this substrate (Backend protocol), with the
        same catalog rules as every backend (``shim.build_catalog``)."""
        return shim.build_catalog(self.stores, self.faas)

    def deploy(self, dep: Deployment) -> None:
        if dep.faas not in self.faas:
            raise KeyError(f"unknown FaaS system {dep.faas}")
        self.deployments[(dep.faas, dep.function)] = dep

    def submit(self, faas: str, function: str, payload: Any, t: float = 0.0) -> None:
        """External client async-invokes ``function``.

        ``t`` is honored as a **wall-clock delay in milliseconds** before the
        invocation enters the FaaS queue (the Backend-protocol contract —
        SimCloud schedules the same delay in virtual time).  Negative values
        are rejected loudly.
        """
        if (faas, function) not in self.deployments:
            raise KeyError(f"function {function} not deployed on {faas}")
        if t < 0:
            raise ValueError(f"submit delay t={t} ms must be >= 0")
        with self._lock:
            self._outstanding += 1
        if t > 0:
            self._after_ms(t, self._enqueue, faas, function, payload, 0)
        else:
            self._enqueue(faas, function, payload, 0)

    def set_down(self, faas: str, down: bool = True, *,
                 kill_running: bool = False) -> None:
        """Take FaaS system(s) down (or back up).  ``faas`` matches an id
        ("aws/lambda") or a whole cloud ("aws").  While down, invocations to
        it raise :class:`InvocationError` and queued work is re-delivered
        with backoff until the requeue budget drops it.  With
        ``kill_running=True`` (an outage, not a drain) in-flight attempts on
        it are also aborted at their next effect boundary."""
        systems = [f for f in self.faas.values()
                   if f.id == faas or f.cloud == faas]
        if not systems:
            raise KeyError(f"no FaaS system matches {faas}")
        with self._lock:
            for f in systems:
                f.down = down
                f.kill_running = down and kill_running

    @property
    def drop_count(self) -> int:
        """Invocations abandoned after the requeue budget (also recorded as
        ``"dropped"`` ExecutionRecords)."""
        return len(self.dropped)

    # ---- scheduling internals ----------------------------------------------

    def _after_ms(self, ms: float, fn: Callable, *args: Any) -> None:
        timer = threading.Timer(ms / 1e3, fn, args=args)
        timer.daemon = True
        timer.start()

    def _enqueue(self, faas_id_: str, function: str, payload: Any,
                 attempt: int) -> None:
        """Queue an accepted async invocation (at-least-once delivery).
        The caller has already accounted it in ``_outstanding``."""
        rec = ExecutionRecord(next(self._exec_ids), function, faas_id_,
                              t_queued=_now_ms(), attempt=attempt,
                              payload=payload)
        with self._lock:
            self._index_record(rec)
            self._queues[faas_id_].append(rec)
            self._qcond[faas_id_].notify()

    def _index_record(self, rec: ExecutionRecord) -> None:
        """Mirror ``records`` into the query indexes (caller holds _lock)."""
        self.records.append(rec)
        bucket = self._by_function.get(rec.function)
        if bucket is None:
            self._by_function[rec.function] = bucket = []
        bucket.append(rec)
        payload = rec.payload
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
                insort(self._wf_keys, wfid)
            wbucket.append(rec)

    def _finalize(self) -> None:
        """One logical invocation reached a terminal state (caller holds
        _lock): wake ``run`` if the substrate is quiescent."""
        self._outstanding -= 1
        if self._outstanding <= 0:
            self._quiesce.notify_all()

    def _retry_or_drop(self, faas: LocalFaaS, rec: ExecutionRecord) -> None:
        """At-least-once redelivery after a crashed attempt, bounded by
        ``max_requeues``; exhaustion records a ``"dropped"`` trace."""
        with self._lock:
            if rec.attempt < self.max_requeues:
                self._after_ms(self.retry_backoff_ms, self._enqueue,
                               faas.id, rec.function, rec.payload,
                               rec.attempt + 1)
                return
            self.dropped.append((faas.id, rec.function, rec.payload))
            drop = ExecutionRecord(next(self._exec_ids), rec.function, faas.id,
                                   t_queued=_now_ms(), status="dropped",
                                   attempt=rec.attempt, payload=rec.payload)
            drop.t_end = drop.t_queued
            self._index_record(drop)
            self._finalize()

    # ---- main loop ---------------------------------------------------------

    def run(self, timeout_s: float = 120.0) -> float:
        """Start the per-FaaS worker pools and block until quiescent (no
        queued, delayed, or in-flight work).  Returns elapsed wall ms.
        Raises ``RuntimeError`` if work is still outstanding after
        ``timeout_s``, and re-raises the first non-Shim exception an attempt
        hit (user-code bugs surface to the caller, exactly as on SimCloud —
        a hang or a swallowed error is never silent)."""
        t0 = time.monotonic()
        self._start_workers()
        try:
            with self._quiesce:
                while self._outstanding > 0 and not self._errors:
                    remaining = timeout_s - (time.monotonic() - t0)
                    if remaining <= 0:
                        raise RuntimeError(
                            f"LocalRunner.run timed out after {timeout_s}s with "
                            f"{self._outstanding} invocation(s) outstanding")
                    self._quiesce.wait(min(remaining, 0.1))
        finally:
            self._stop_workers()
        if self._errors:
            raise self._errors[0]
        return (time.monotonic() - t0) * 1e3

    def _start_workers(self) -> None:
        with self._lock:
            self._stop = False
        for f in self.faas.values():
            for i in range(f.concurrency):
                th = threading.Thread(target=self._worker, args=(f,),
                                      name=f"local-{f.id}-{i}", daemon=True)
                th.start()
                self._workers.append(th)

    def _stop_workers(self) -> None:
        with self._lock:
            self._stop = True
            for cond in self._qcond.values():
                cond.notify_all()
        for th in self._workers:
            th.join(timeout=5.0)
        self._workers = []

    def _worker(self, faas: LocalFaaS) -> None:
        q = self._queues[faas.id]
        cond = self._qcond[faas.id]
        while True:
            resume = None
            with self._lock:
                while not q and not self._stop:
                    cond.wait()
                if self._stop:
                    return
                item = q.popleft()
                if type(item) is tuple:        # (_RESUME-style) parked wake
                    _, ex, value = item
                    rec = ex.record
                    resume = (ex, value)
                else:
                    rec = item
                if faas.down:
                    rec.status = "crashed"    # connection never established
                    rec.t_end = _now_ms()
            if rec.status == "crashed":
                # a parked attempt woken into an outage crashes like any
                # other in-flight attempt: generator abandoned, redelivered
                self._retry_or_drop(faas, rec)
                continue
            if resume is not None:
                ex, value = resume
                rec.status = "running"
                self._drive_attempt(faas, rec, ex, value)
            else:
                self._run_attempt(faas, rec)

    def _run_attempt(self, faas: LocalFaaS, rec: ExecutionRecord) -> None:
        dep = self.deployments[(faas.id, rec.function)]
        rec.t_start = _now_ms()
        rec.status = "running"
        ex = LocalExecution(self, dep, faas, rec)
        self._drive_attempt(faas, rec, ex, None)

    def _drive_attempt(self, faas: LocalFaaS, rec: ExecutionRecord,
                       ex: LocalExecution, value: Any) -> None:
        """Drive one attempt (fresh or woken) until it terminates or parks.
        Parking frees this worker thread: the generator stays alive inside
        ``ex`` and the suspension's ``arrange`` hook re-enqueues it."""
        try:
            result = ex.drive(value)
        except _Suspend as s:
            rec.status = "suspended"
            # NOT finalized: the invocation is still logically outstanding,
            # so ``run`` keeps waiting for the wake — but no worker thread
            # (= concurrency slot) is held while it sleeps
            s.arrange(lambda v: self._unpark(faas, ex, v))
            return
        except (_Killed, shim.ShimError):
            # the attempt died between effects (outage/injected crash) or a
            # shim error escaped the handler: at-least-once redelivery.
            # In-flight speculative pushes it issued are aborted first, so
            # nothing from the dead attempt outlives the journal.
            self._abort_prefetches(rec.exec_id)
            rec.t_end = _now_ms()
            rec.status = "crashed"
            self._retry_or_drop(faas, rec)
            return
        except BaseException as e:
            # user-code / interpreter bug: not a substrate fault, so no
            # redelivery — record it and fail run() loudly with the original
            # exception (the worker thread itself stays alive)
            rec.t_end = _now_ms()
            rec.status = "crashed"
            with self._lock:
                self._errors.append(e)
                self._finalize()
                self._quiesce.notify_all()
            return
        rec.t_end = _now_ms()
        rec.status = "done"
        rec.result = result
        with self._lock:
            self._done_records.append(rec)
            self._finalize()

    def _unpark(self, faas: LocalFaaS, ex: LocalExecution, value: Any) -> None:
        """Re-enqueue a parked attempt's continuation; the next free worker
        on its FaaS resumes the generator with ``value``."""
        with self._lock:
            self._queues[faas.id].append(("resume", ex, value))
            self._qcond[faas.id].notify()

    # ---- effect interpreter ------------------------------------------------

    def _apply(self, ex: LocalExecution, effect: shim.Effect) -> Any:
        handler = self._dispatch.get(effect.__class__)
        if handler is None:             # subclassed effect: nearest base
            for klass in effect.__class__.__mro__[1:]:
                handler = self._dispatch.get(klass)
                if handler is not None:
                    self._dispatch[effect.__class__] = handler
                    break
            else:
                raise TypeError(f"unknown effect {effect!r}")
        return handler(ex, effect)

    def _perform_now(self, ex: LocalExecution, effect: shim.Now) -> float:
        return _now_ms()

    def _perform_trace(self, ex: LocalExecution, effect: shim.Trace) -> None:
        ex.record.phases.append((_now_ms(), effect.phase))
        return None

    def _perform_create_client(self, ex: LocalExecution,
                               effect: shim.CreateClient) -> str:
        return effect.target

    def _perform_run_user(self, ex: LocalExecution, effect: shim.RunUser) -> Any:
        return ex.dep.workload.output(effect.data)

    def _perform_invoke(self, ex: LocalExecution, effect: shim.Invoke) -> bool:
        target = self.faas.get(effect.faas)
        if target is None:
            raise shim.InvocationError(f"unknown FaaS {effect.faas}")
        if target.down:
            raise shim.InvocationError(f"{effect.faas} is down")
        nbytes = effect.size_bytes or estimate_size(effect.payload)
        if nbytes > target.payload_quota:
            raise shim.PayloadTooLarge(
                f"{nbytes}B > quota {target.payload_quota}B on {effect.faas}")
        if (effect.faas, effect.function) not in self.deployments:
            raise shim.InvocationError(
                f"{effect.function} not deployed on {effect.faas}")
        with self._lock:
            self._outstanding += 1
        self._enqueue(effect.faas, effect.function, effect.payload, 0)
        return True

    def _perform_parallel(self, ex: LocalExecution,
                          effect: shim.Parallel) -> List[Any]:
        """Sub-effects genuinely fan out on threads (§4.1.2): one worker per
        sub-effect (the first runs on the calling thread), results or
        exception instances returned positionally."""
        subs = list(effect.effects)
        if not subs:
            return []
        if any(type(s) in (shim.Sleep, shim.WaitForSignal) for s in subs):
            # suspension parks the *whole attempt* — inside a Parallel that
            # would strand the sibling threads, so it is rejected loudly
            raise shim.ShimError(
                "Sleep/WaitForSignal cannot run inside Parallel")
        results: List[Any] = [None] * len(subs)
        fatal: List[BaseException] = []

        def work(i: int, sub: shim.Effect) -> None:
            try:
                results[i] = self._apply(ex, sub)
            except shim.ShimError as e:
                results[i] = e
            except BaseException as e:
                # non-Shim failure in a sub-thread: re-raised on the calling
                # thread after the join, same as a slot-0 failure
                fatal.append(e)

        threads = [threading.Thread(target=work, args=(i, sub), daemon=True)
                   for i, sub in enumerate(subs[1:], 1)]
        for th in threads:
            th.start()
        work(0, subs[0])
        for th in threads:
            th.join()
        if fatal:
            raise fatal[0]
        return results

    def _perform_prefetch(self, ex: LocalExecution,
                          effect: shim.Prefetch) -> bool:
        """Speculative push (the ``prefetch`` capability): a worker thread
        copies the committed value of ``ds[key]`` into the staging cache,
        started now — at upstream-dispatch time — and joined by the
        consumer's DsGet.  Semantics-preserving by construction:

        * the push reads the *committed* store value (§4.1 conditional
          creates make it immutable), so the cache can never go stale and
          never holds anything the journal has not seen;
        * idempotent per ``(ds, key)`` — a retried attempt re-yielding the
          push is a no-op (no double work);
        * abort-on-crash — entries issued by an attempt that dies before
          the copy lands are marked aborted and evicted
          (:meth:`_abort_prefetches`), so the consumer falls back to the
          authoritative store and a later retry may push again.
        """
        if not self.prefetch:
            raise shim.CapabilityError(
                "prefetch disabled on this LocalRunner "
                "(constructed with prefetch=False)")
        st = self.stores.get(effect.ds)
        if st is None:
            raise shim.DataStoreError(f"unknown datastore {effect.ds}")
        ckey = (effect.ds, effect.key)
        with self._lock:
            if ckey in self._prefetch_cache:
                return False                 # duplicate push: no-op
            ent = {"event": threading.Event(), "value": None, "ok": False,
                   "aborted": False, "exec": ex.record.exec_id}
            self._prefetch_cache[ckey] = ent

        def push() -> None:
            value = st.get(effect.key)
            with self._lock:
                if ent["aborted"]:
                    return                   # issuer crashed mid-push
                if value is None:
                    # not committed yet (mis-ordered directive): evict so a
                    # later push can retry; consumers use the store
                    self._prefetch_cache.pop(ckey, None)
                else:
                    ent["value"] = value
                    ent["ok"] = True
            ent["event"].set()

        th = threading.Thread(target=push, daemon=True,
                              name=f"prefetch-{effect.ds}-{effect.key}")
        th.start()
        return True

    def _abort_prefetches(self, exec_id: int) -> None:
        """Discard in-flight pushes issued by a crashed attempt: mark them
        aborted (the push thread then drops its copy) and evict, so
        consumers read the authoritative store and a retried attempt can
        push again.  Pushes that already landed stay — they hold a
        committed, immutable value, which a crash cannot invalidate."""
        with self._lock:
            stale = [(k, e) for k, e in self._prefetch_cache.items()
                     if e["exec"] == exec_id and not e["ok"]]
            for k, e in stale:
                e["aborted"] = True
                del self._prefetch_cache[k]
        for _, e in stale:
            e["event"].set()                 # release any joined consumer

    def _perform_ds(self, ex: LocalExecution, effect: shim.Effect) -> Any:
        st = self.stores.get(getattr(effect, "ds", None))
        if st is None:
            raise shim.DataStoreError(
                f"unknown datastore {getattr(effect, 'ds', None)}")
        klass = effect.__class__
        if klass is shim.DsCreate:
            return st.create_if_absent(effect.key, effect.value)
        if klass is shim.DsGet:
            # join an in-flight speculative push first (the consume-time
            # barrier); the empty-cache short-circuit keeps prefetch-off
            # reads byte-identical to previous releases
            if self._prefetch_cache:
                with self._lock:
                    ent = self._prefetch_cache.get((effect.ds, effect.key))
                if ent is not None:
                    ent["event"].wait(timeout=5.0)
                    if ent["ok"]:
                        return ent["value"]
                    # aborted / timed out: authoritative fallback below
            return st.get(effect.key)
        if klass is shim.DsAppendGetList:
            return st.append_and_get_list(effect.key, effect.items)
        if klass is shim.DsUpdateBitmap:
            return st.update_bitmap(effect.index, effect.key)
        if klass is shim.DsListPrefix:
            return st.list_prefix(effect.prefix)
        if klass is shim.DsDelete:
            return st.delete(effect.keys)
        raise TypeError(f"unknown datastore effect {effect!r}")

    # ---- durable execution: suspension, signals, journal -------------------

    def _perform_sleep(self, ex: LocalExecution, effect: shim.Sleep) -> None:
        if effect.ms <= 0:
            return None
        raise _Suspend(lambda resume:
                       self._after_ms(effect.ms, resume, None))

    def _perform_wait_signal(self, ex: LocalExecution,
                             effect: shim.WaitForSignal) -> Any:
        scope = effect.scope
        if not scope:
            raise shim.ShimError(
                f"WaitForSignal({effect.name!r}) reached the interpreter "
                f"with no workflow scope")
        key = (scope, effect.name)
        with self._lock:
            if key in self._signals:
                return self._signals[key]
        if self._signal_table is not None:
            # durable latch: a signal delivered before a crash is observed
            # by the re-delivered (or rehydrated) attempt
            stored = self.stores[self._signal_table].get(
                signal_key(scope, effect.name))
            if stored is not None:
                with self._lock:
                    self._signals.setdefault(key, stored["v"])
                    return self._signals[key]

        def arrange(resume: Callable[[Any], None]) -> None:
            # re-check under the lock: a delivery racing the park must not
            # be lost — either it latched already (wake immediately) or the
            # waiter is registered before the latch can be set
            with self._lock:
                if key not in self._signals:
                    self._signal_waiters.setdefault(key, []).append(resume)
                    return
                value = self._signals[key]
            resume(value)

        raise _Suspend(arrange)

    def signal(self, workflow_id: str, name: str, value: Any = True,
               t: float = 0.0) -> None:
        """Deliver a named signal to one workflow instance (Backend-protocol
        ``signal`` capability).  First delivery wins; ``t`` is a wall-clock
        delay in ms, same contract as ``submit(t=)``."""
        if t < 0:
            raise ValueError(f"signal delay t={t} ms must be >= 0")
        if t > 0:
            self._after_ms(t, self._deliver_signal, str(workflow_id),
                           name, value)
        else:
            self._deliver_signal(str(workflow_id), name, value)

    def _deliver_signal(self, wfid: str, name: str, value: Any) -> None:
        if self._signal_table is not None:
            st = self.stores[self._signal_table]
            if not st.create_if_absent(signal_key(wfid, name), {"v": value}):
                value = st.get(signal_key(wfid, name))["v"]   # first one won
        key = (wfid, name)
        with self._lock:
            value = self._signals.setdefault(key, value)
            waiters = self._signal_waiters.pop(key, [])
        for resume in waiters:
            resume(value)

    def _journal_tables(self) -> List[TableState]:
        """Raw table states holding the effect journal (``journal``
        capability; see ``repro_torch.core.durable.resume``)."""
        return [s.state for s in self.stores.values() if s.kind == "table"]

    def adopt_stores(self, other: "LocalRunner") -> None:
        """Share ``other``'s datastore contents (checkpoints + journal),
        modeling a fresh runner instance over the same persistent stores —
        which grants this runner the ``journal`` capability."""
        for did, store in self.stores.items():
            src = other.stores.get(did)
            if src is not None:
                store.state = src.state
        self.journal = self._journal_tables

    def close(self) -> None:
        """Release WAL file handles (no-op for in-memory stores)."""
        for store in self.stores.values():
            closer = getattr(store.state, "close", None)
            if closer is not None:
                closer()

    # ---- Backend protocol: record queries ----------------------------------

    def executions_of(self, function: str) -> List[ExecutionRecord]:
        with self._lock:
            return list(self._by_function.get(function, ()))

    def completed(self) -> List[ExecutionRecord]:
        with self._lock:
            return sorted(self._done_records, key=lambda r: r.exec_id)

    def workflow_records(self, prefix: str) -> List[ExecutionRecord]:
        """All execution records whose workflow id starts with ``prefix``
        (batch spin-offs carry a ``<wfid>-batchN`` id), by ``exec_id`` —
        a bisect over the sorted workflow-id index, not a record scan."""
        with self._lock:
            keys = self._wf_keys
            i = bisect_left(keys, prefix)
            out: List[ExecutionRecord] = []
            while i < len(keys) and keys[i].startswith(prefix):
                out.extend(self._wf_records[keys[i]])
                i += 1
        out.sort(key=lambda r: r.exec_id)
        return out


def deploy_local(runner: LocalRunner, spec, catalog=None):
    """Deploy a WorkflowSpec onto a LocalRunner — thin alias of the one
    backend-agnostic deploy path (``repro_torch.core.workflow.deploy``)."""
    from repro_torch.core.workflow import deploy
    return deploy(runner, spec, catalog)
