"""Distributed remote backend: broker-fed worker *processes* over a shared
durable store.

This is the protocol's first multi-process substrate — the production shape
where the paper's AWS/Aliyun deployment becomes "one more backend".  One
box runs several per-"cloud" process groups (``multiprocessing`` fork
workers, addressable by ``{cloud}-{index}`` and registered in
``<store_dir>/workers.json`` so real hosts can follow the same contract);
all coordination flows through **files**, never through in-process state:

* every datastore is a :class:`repro_torch.backends.datastore.SharedTableState` —
  a WAL-backed linearizable table safe for concurrent writers in multiple
  processes (flock + catch-up-then-append; see datastore.py);
* a dedicated ``__broker__`` table carries the delivery plane: immutable
  messages, mutable **leases** (visibility timeouts), acks, execution
  records, drop markers, chaos/stop/outage flags.

Delivery contract (at-least-once ⊕ §4.1 idempotent commits ⇒ exactly-once):

* ``submit``/``Invoke`` append an immutable message ``m/{seq}``; a worker
  *claims* it by writing lease ``l/{seq}`` (``deadline = now + lease_ms``)
  under one broker lock session — claim, exec-id allocation and the
  "running" record are a single atomic step.
* A worker that dies (``kill -9``) mid-attempt simply stops renewing
  nothing: its flock evaporates with the process and its lease expires, so
  any surviving worker of the same cloud re-claims the message with
  ``attempt + 1``.  Crashed attempts release their lease early with
  ``retry_backoff_ms``; ``attempt > max_requeues`` drops the invocation
  loudly (``d/{seq}`` + a ``"dropped"`` record), never silently.
* Completion writes the terminal record and the ack ``a/{seq}`` in one
  broker session.  Re-claimed duplicates re-run user code, but every
  externally visible write is a §4.1 conditional create, so data-layer
  effects stay exactly-once.

Suspension (``Sleep``/``WaitForSignal``) must survive ``kill -9`` too, so a
parked attempt holds **no worker and no lease**: the current message is
acked and a *wake* message is enqueued in the same broker session —
``not_before = now + ms`` for sleeps; ``kind = "signal"`` messages are
claimable only once the durable signal latch exists.  Redelivery restarts
the handler from the top: in durable mode the effect journal replays it to
the exact suspension point (the journaled absolute deadline sleeps only the
residual); in non-durable mode user functions may re-run but the data layer
stays exactly-once — a suspension is literally "a crash the workflow
planned for".

Capabilities: ``journal`` and ``signal`` are real (the stores are
WAL-persistent by construction, so a fresh ``RemoteRunner`` over the same
``store_dir`` can ``resume()``).  ``topology``, ``faas``, ``after`` and
``prefetch`` are deliberately absent — probes degrade to
:class:`repro_torch.backends.shim.CapabilityError` through the generic layer.

Scale note: the broker scan is O(messages) per claim, which is fine for the
conformance/chaos suites this substrate exists to serve; a real deployment
would shard ``m/`` by FaaS queue exactly like the per-FaaS deques of
:mod:`repro_torch.backends.localjax`.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
import signal as _signal
import tempfile
import threading
import time
import traceback
from typing import (Any, Callable, Dict, List, Mapping, Optional, Tuple,
                    Union)

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.backends.datastore import (SharedTableState, TableState,
                                      signal_key, wal_path)
from repro_torch.backends.shim import (Deployment, ExecutionRecord, Workload,
                                 estimate_size)

# broker key namespaces (all inside the one ``__broker__`` shared table)
_MSG = "m/"        # immutable delivery messages
_LEASE = "l/"      # mutable lease records (visibility timeout)
_ACK = "a/"        # terminal acks
_REC = "r/"        # execution records (the record-query surface)
_DROP = "d/"       # (faas, function, payload) of budget-exhausted drops
_ERR = "err/"      # fatal (non-Shim) attempt errors -> run() raises
_DOWN = "down/"    # outage flags per FaaS id
_STOP = "stop/"    # pool-generation shutdown flags
_CHAOS = "__chaos__/"   # once-only latches for cross-process crash policies
_CTR = "n/"        # counters: n/seq, n/exec
_DEDUP = "dd/"     # content-dedup index: invoke-hash -> message seq

_WORKERS_JSON = "workers.json"


def _wall_ms() -> float:
    """Wall-clock epoch ms: the one clock every process shares."""
    return time.time() * 1e3


class _Killed(BaseException):
    """The current attempt was aborted between two effects (outage /
    injected crash).  BaseException so orchestrator ``except ShimError``
    clauses cannot swallow it."""


class _Requeue(BaseException):
    """Suspension control flow: ack the current delivery and enqueue a wake
    message instead of holding a worker (the parked state lives entirely in
    the broker, so it survives ``kill -9`` of every process)."""

    def __init__(self, delay_ms: float, *, kind: str = "wake",
                 sleeps_done: int = 0,
                 wait: Optional[Tuple[str, str]] = None):
        self.delay_ms = delay_ms
        self.kind = kind
        self.sleeps_done = sleeps_done
        self.wait = wait            # (workflow_id, signal_name) for latches


class RemoteFaaS:
    """One FaaS system of the remote substrate (catalog entity only —
    workers of its cloud serve its queue; outage state lives in the
    broker's ``down/`` keys, not here)."""

    def __init__(self, id: str, cloud: str, flavor: cal.Flavor,
                 payload_quota: int):
        self.id = id
        self.cloud = cloud
        self.flavor = flavor
        self.payload_quota = payload_quota


class RemoteExecution:
    """One claimed attempt being driven inside a worker process.

    Exposes the same probe surface as the other substrates' executions
    (``dep`` / ``record`` / ``effect_index``) so crash policies are
    portable; additionally ``msg`` (the broker delivery envelope) lets
    chaos policies target e.g. wake redeliveries specifically."""

    __slots__ = ("runner", "dep", "record", "msg", "gen", "effect_index",
                 "sleeps_seen")

    def __init__(self, runner: "RemoteRunner", dep: Deployment,
                 record: ExecutionRecord, msg: dict):
        self.runner = runner
        self.dep = dep
        self.record = record
        self.msg = msg
        self.gen = dep.handler(record.payload)
        self.effect_index = 0
        self.sleeps_seen = 0

    def drive(self) -> Any:
        runner = self.runner
        value: Any = None
        exc: Optional[BaseException] = None
        while True:
            try:
                effect = self.gen.send(value) if exc is None else self.gen.throw(exc)
            except StopIteration as stop:
                return stop.value
            # kill checks between effects: a kill_running outage or a crash
            # policy aborts here — effects already committed stay committed,
            # the §4.1.2 duplicate hazard the protocol absorbs
            down = runner._down_state(self.record.faas)
            if down is not None and down.get("kill"):
                raise _Killed()
            cp = runner.crash_policy
            if cp is not None:
                verdict = cp(self, effect)
                if verdict == "kill":
                    # a *real* worker-process death, not an exception: the
                    # lease expires and a surviving process re-claims
                    os.kill(os.getpid(), _signal.SIGKILL)
                if verdict:
                    raise _Killed()
            self.effect_index += 1
            value, exc = None, None
            try:
                value = runner._apply(self, effect)
            except shim.ShimError as e:
                exc = e


class RemoteRunner:
    """Multi-process :class:`repro_torch.backends.shim.Backend` (see module doc).

    ``workers`` is processes per cloud (int, or mapping cloud -> count);
    each worker serves every FaaS queue of its cloud.  ``lease_ms`` is the
    visibility timeout: how long a claimed delivery stays invisible before
    a presumed-dead worker's message is re-claimed.  ``store_dir=None``
    creates (and owns) a temp directory; pass an existing directory to
    share state across runner instances — the durable-recovery idiom.
    """

    def __init__(self, config: Optional[dict] = None, *,
                 store_dir: Optional[str] = None,
                 workers: Union[int, Mapping[str, int]] = 2,
                 lease_ms: float = 15000.0, max_requeues: int = 8,
                 retry_backoff_ms: float = 25.0, poll_ms: float = 5.0):
        self._config = config or cal.default_jointcloud()
        self._owns_dir = store_dir is None
        self.store_dir = store_dir or tempfile.mkdtemp(prefix="jl-remote-")
        os.makedirs(self.store_dir, exist_ok=True)

        self.stores: Dict[str, SharedTableState] = {}
        self._faas: Dict[str, RemoteFaaS] = {}   # private: no `faas` probe
        for cname, c in self._config["clouds"].items():
            quota = cal.PAYLOAD_QUOTA.get(cname, cal.DEFAULT_PAYLOAD_QUOTA)
            for sysname, flavor in c.get("faas", {}).items():
                fid = shim.faas_id(cname, sysname)
                self._faas[fid] = RemoteFaaS(fid, cname, flavor, quota)
            for t in c.get("tables", []):
                did = shim.ds_id(cname, t)
                st = SharedTableState(did, wal_path(self.store_dir, did))
                st.cloud, st.kind = cname, "table"
                self.stores[did] = st
            for o in c.get("objects", []):
                did = shim.ds_id(cname, o)
                st = SharedTableState(did, wal_path(self.store_dir, did))
                st.cloud, st.kind = cname, "object"
                self.stores[did] = st
        self.broker = SharedTableState(
            "__broker__", os.path.join(self.store_dir, "__broker__.wal"))
        self._signal_table = min(
            (d for d, s in self.stores.items() if s.kind == "table"),
            default=None)

        self.deployments: Dict[Tuple[str, str], Deployment] = {}
        self.lease_ms = float(lease_ms)
        self.max_requeues = max_requeues
        self.retry_backoff_ms = retry_backoff_ms
        self.poll_ms = float(poll_ms)
        self._workers = workers
        self.crash_policy: Optional[
            Callable[[RemoteExecution, shim.Effect], Any]] = None
        self._procs: List[multiprocessing.process.BaseProcess] = []
        self._generation = 0
        # stop flags live in the shared broker, which outlives this runner:
        # scope them to this incarnation so a fresh pool over the same
        # store_dir (the recovery idiom) doesn't obey a dead runner's stop
        self._nonce = f"{os.getpid():x}-{os.urandom(4).hex()}"
        self._in_worker = False

        # per-effect-type dispatch (same invariant as the other substrates:
        # extend the table, never add isinstance chains)
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

    # ---- Backend protocol: execution surface -------------------------------

    def catalog(self):
        return shim.build_catalog(self.stores, self._faas)

    def deploy(self, dep: Deployment) -> None:
        if dep.faas not in self._faas:
            raise KeyError(f"unknown FaaS system {dep.faas}")
        if self._procs:
            # workers snapshot ``deployments`` at fork: registering after
            # the pool started would silently not propagate
            raise RuntimeError(
                "deploy() while the worker pool is running: deployments are "
                "snapshotted at fork — deploy before run()")
        self.deployments[(dep.faas, dep.function)] = dep

    def submit(self, faas: str, function: str, payload: Any,
               t: float = 0.0) -> None:
        """External async-invoke; ``t`` is the Backend-protocol wall-clock
        delay in ms, honored via the message's ``not_before`` claim gate."""
        if (faas, function) not in self.deployments:
            raise KeyError(f"function {function} not deployed on {faas}")
        if t < 0:
            raise ValueError(f"submit delay t={t} ms must be >= 0")
        now = _wall_ms()
        self._enqueue(faas, function, payload, attempt=0,
                      not_before=now + t, t_queued=now)

    def run(self, timeout_s: float = 120.0) -> float:
        """Fork the per-cloud worker pools and poll the broker until
        quiescent: every message acked, except signal waits whose latch has
        not arrived (those stay parked, exactly like SimCloud returning
        with a suspended workflow).  Returns elapsed wall ms; re-raises the
        first fatal (non-Shim) attempt error; raises ``RuntimeError`` on
        timeout or if the whole pool died with work outstanding."""
        t0 = time.monotonic()
        self._generation += 1
        gen = self._generation
        self._start_pool(gen)
        try:
            while True:
                pending, err = self._scan_pending()
                if err is not None:
                    raise RuntimeError(
                        f"remote attempt failed with a non-Shim error "
                        f"(user-code bug, not redelivered): {err['repr']}\n"
                        f"{err['tb']}")
                if pending == 0:
                    break
                if time.monotonic() - t0 > timeout_s:
                    raise RuntimeError(
                        f"RemoteRunner.run timed out after {timeout_s}s "
                        f"with {pending} delivery(ies) outstanding")
                if not any(p.is_alive() for p in self._procs):
                    raise RuntimeError(
                        f"remote worker pool died with {pending} "
                        f"delivery(ies) outstanding")
                time.sleep(max(self.poll_ms, 20.0) / 1e3)
        finally:
            self._stop_pool(gen)
        return (time.monotonic() - t0) * 1e3

    # ---- capabilities: journal / signal / outage / chaos -------------------

    def journal(self) -> List[TableState]:
        """``journal`` capability: the WAL-backed stores *are* the durable
        journal, so a fresh runner over the same ``store_dir`` can
        ``resume()``.  Syncs to the WAL tip so the recovery scan observes
        every process's commits."""
        out: List[TableState] = []
        for st in self.stores.values():
            if st.kind == "table":
                st.sync()
                out.append(st)
        return out

    def signal(self, workflow_id: str, name: str, value: Any = True,
               t: float = 0.0) -> None:
        """Deliver a named signal (Backend-protocol ``signal`` capability).
        First delivery wins via the durable latch; parked ``kind="signal"``
        messages become claimable the moment the latch exists."""
        if t < 0:
            raise ValueError(f"signal delay t={t} ms must be >= 0")
        if t > 0:
            timer = threading.Timer(t / 1e3, self._deliver_signal,
                                    args=(str(workflow_id), name, value))
            timer.daemon = True
            timer.start()
        else:
            self._deliver_signal(str(workflow_id), name, value)

    def _deliver_signal(self, wfid: str, name: str, value: Any) -> None:
        if self._signal_table is None:
            raise shim.ShimError("remote substrate has no table store")
        self.stores[self._signal_table].create_if_absent(
            signal_key(wfid, name), {"v": value})

    def _latch_present(self, wfid: str, name: str) -> bool:
        if self._signal_table is None:
            return False
        return self.stores[self._signal_table].get(
            signal_key(wfid, name)) is not None

    def set_down(self, faas: str, down: bool = True, *,
                 kill_running: bool = False) -> None:
        """Take FaaS system(s) down/up by id ("aws/lambda") or cloud
        ("aws").  While down, ``Invoke`` raises ``InvocationError`` and
        claims of its queue burn attempts with backoff until the requeue
        budget drops them; ``kill_running=True`` also aborts in-flight
        attempts at their next effect boundary (in every worker — the flag
        lives in the broker)."""
        systems = [f for f in self._faas.values()
                   if f.id == faas or f.cloud == faas]
        if not systems:
            raise KeyError(f"no FaaS system matches {faas}")
        for f in systems:
            if down:
                self.broker.put(_DOWN + f.id, {"kill": bool(kill_running)})
            else:
                self.broker.delete([_DOWN + f.id])

    def _down_state(self, fid: str) -> Optional[dict]:
        return self.broker.get(_DOWN + fid)

    def chaos_once(self, tag: str) -> bool:
        """Cross-process once-only latch for crash policies: exactly one
        worker (the first to ask) gets ``True`` per tag.  This is how the
        SIGKILL chaos suites arm "kill exactly one worker, once"."""
        return self.broker.create_if_absent(_CHAOS + tag, True)

    def worker_pids(self) -> Dict[str, int]:
        """Live pool registry ``{worker_name: pid}`` (also persisted to
        ``<store_dir>/workers.json`` so external harnesses can kill -9 a
        worker they did not fork)."""
        return {p.name: p.pid for p in self._procs if p.pid is not None}

    # ---- broker plumbing ----------------------------------------------------

    def _alloc(self, counter: str) -> int:
        with self.broker.locked():
            n = self.broker.get(_CTR + counter) or 0
            self.broker.put(_CTR + counter, n + 1)
            return n

    def _enqueue(self, faas: str, function: str, payload: Any, *,
                 attempt: int, not_before: float, t_queued: float,
                 kind: str = "invoke", sleeps_done: int = 0,
                 wait: Optional[Tuple[str, str]] = None) -> None:
        msg = {"faas": faas, "function": function, "payload": payload,
               "attempt": attempt, "not_before": not_before,
               "t_queued": t_queued, "kind": kind,
               "sleeps_done": sleeps_done}
        if wait is not None:
            msg["wait"] = wait
        with self.broker.locked():
            # Content-based delivery dedup (the SQS-FIFO idiom), the
            # delivery plane's half of §4.1 at-most-once invocation: the
            # orchestrator's ``-ivk`` checkpoint has a read→invoke race
            # window that two worker *processes* (e.g. redundant replicas
            # finishing together) can both pass — collapsing identical
            # invoke messages here closes it.  A prior identical delivery
            # suppresses this one unless it terminated in a ``drop``/
            # ``error`` ack, in which case a deliberate re-invocation
            # (durable ``resume()`` after budget exhaustion) goes through.
            dk = None
            if kind == "invoke":
                digest = hashlib.sha1(
                    repr((faas, function, payload)).encode()).hexdigest()
                dk = _DEDUP + digest
                prev = self.broker.get(dk)
                if prev is not None:
                    ack = self.broker.get(_ACK + prev)
                    if ack is None or ack.get("by") in ("done", "suspend"):
                        return
            seq = self._alloc("seq")
            if dk is not None:
                self.broker.put(dk, f"{seq:08d}")
            self.broker.put(f"{_MSG}{seq:08d}", msg)

    def _rec_put(self, rec: ExecutionRecord) -> None:
        d = {"exec_id": rec.exec_id, "function": rec.function,
             "faas": rec.faas, "t_queued": rec.t_queued,
             "t_start": rec.t_start, "t_end": rec.t_end,
             "status": rec.status, "attempt": rec.attempt,
             "payload": rec.payload, "result": rec.result,
             "phases": list(rec.phases)}
        self.broker.put(f"{_REC}{rec.exec_id:08d}", d)

    def _claim(self, worker: str, cloud: str):
        """Atomically claim the oldest due, unacked, unleased message of
        ``cloud``: write the lease + the "running" record in one broker
        session.  Returns ``(seq_key_suffix, msg, record)`` or ``None``."""
        now = _wall_ms()
        with self.broker.locked():
            for key in self.broker.list_prefix(_MSG):
                seq = key[len(_MSG):]
                if self.broker.get(_ACK + seq) is not None:
                    continue
                m = self.broker.get(key)
                fid = m["faas"]
                if shim.cloud_of(fid) != cloud:
                    continue
                if m["not_before"] > now:
                    continue
                if m["kind"] == "signal" and not self._latch_present(*m["wait"]):
                    continue            # parked until the latch arrives
                lease = self.broker.get(_LEASE + seq)
                if lease is not None and lease["deadline"] > now:
                    continue            # visibly claimed by a live worker
                attempt = (m.get("attempt", 0) if lease is None
                           else lease["attempt"] + 1)
                if attempt > self.max_requeues:
                    self._drop_locked(seq, m, attempt)
                    continue
                if self.broker.get(_DOWN + fid) is not None:
                    # the delivery connection fails while the system is
                    # down: burn the attempt, release with backoff
                    exec_id = self._alloc("exec")
                    rec = ExecutionRecord(
                        exec_id, m["function"], fid,
                        t_queued=m["t_queued"], status="crashed",
                        attempt=attempt, payload=m["payload"])
                    rec.t_end = now
                    self._rec_put(rec)
                    self.broker.put(_LEASE + seq, {
                        "deadline": now + self.retry_backoff_ms,
                        "attempt": attempt, "worker": worker})
                    continue
                exec_id = self._alloc("exec")
                rec = ExecutionRecord(
                    exec_id, m["function"], fid, t_queued=m["t_queued"],
                    attempt=attempt, payload=m["payload"])
                rec.t_start = now
                rec.status = "running"
                self._rec_put(rec)
                self.broker.put(_LEASE + seq, {
                    "deadline": now + self.lease_ms,
                    "attempt": attempt, "worker": worker})
                return seq, m, rec
        return None

    def _drop_locked(self, seq: str, m: dict, attempt: int) -> None:
        """Requeue budget exhausted: record the drop loudly and ack.
        Caller holds the broker lock."""
        self.broker.put(_DROP + seq,
                        (m["faas"], m["function"], m["payload"]))
        exec_id = self._alloc("exec")
        drop = ExecutionRecord(exec_id, m["function"], m["faas"],
                               t_queued=_wall_ms(), status="dropped",
                               attempt=attempt - 1, payload=m["payload"])
        drop.t_end = drop.t_queued
        self._rec_put(drop)
        self.broker.put(_ACK + seq, {"by": "drop"})

    # ---- worker processes ---------------------------------------------------

    def _worker_plan(self) -> List[Tuple[str, int]]:
        clouds = sorted({f.cloud for f in self._faas.values()})
        if isinstance(self._workers, Mapping):
            return [(c, int(self._workers.get(c, 1))) for c in clouds]
        return [(c, int(self._workers)) for c in clouds]

    def _start_pool(self, gen: int) -> None:
        # fork: handlers / Workload.fn are closures, so spawn cannot ship
        # them — the whole runner state is inherited copy-on-write instead
        ctx = multiprocessing.get_context("fork")
        self._procs = []
        for cloud, n in self._worker_plan():
            for i in range(n):
                name = f"{cloud}-{i}"
                p = ctx.Process(target=self._worker_main,
                                args=(gen, name, cloud),
                                name=name, daemon=True)
                p.start()
                self._procs.append(p)
        with open(os.path.join(self.store_dir, _WORKERS_JSON), "w") as f:
            json.dump(self.worker_pids(), f)

    def _stop_pool(self, gen: int) -> None:
        self.broker.put(f"{_STOP}{self._nonce}-{gen:04d}", True)
        for p in self._procs:
            p.join(timeout=5.0)
        for p in self._procs:
            if p.is_alive():        # wedged (should not happen): hard stop
                p.terminate()
                p.join(timeout=1.0)
        self._procs = []

    def _worker_main(self, gen: int, name: str, cloud: str) -> None:
        """Entry point inside a freshly forked worker process."""
        self._in_worker = True
        self._procs = []
        # inherited store views may be mid-mutation if another parent
        # thread held a lock at fork time: rebuild every view from its WAL
        for st in list(self.stores.values()) + [self.broker]:
            st.reset_after_fork()
        stop_key = f"{_STOP}{self._nonce}-{gen:04d}"
        try:
            while self.broker.get(stop_key) is None:
                claim = self._claim(name, cloud)
                if claim is None:
                    time.sleep(self.poll_ms / 1e3)
                    continue
                self._execute(*claim)
        except KeyboardInterrupt:   # pragma: no cover - interactive runs
            pass

    def _execute(self, seq: str, m: dict, rec: ExecutionRecord) -> None:
        dep = self.deployments.get((m["faas"], m["function"]))
        now = _wall_ms
        if dep is None:
            # enqueue-time checks make this unreachable unless a fresh pool
            # was started without re-registering deployments: fail loudly
            with self.broker.locked():
                rec.status = "crashed"
                rec.t_end = now()
                self._rec_put(rec)
                self.broker.put(_ERR + seq, {
                    "repr": f"KeyError: {m['function']} not deployed on "
                            f"{m['faas']} in this worker",
                    "tb": ""})
                self.broker.put(_ACK + seq, {"by": "error"})
            return
        ex = RemoteExecution(self, dep, rec, m)
        try:
            result = ex.drive()
        except _Requeue as rq:
            # park durably: terminal-ize this delivery and enqueue the wake
            # in one atomic broker session — no worker, no lease is held
            # while suspended, so kill -9 anywhere leaves a resumable store
            with self.broker.locked():
                rec.status = "suspended"
                rec.t_end = now()
                self._rec_put(rec)
                self._enqueue(m["faas"], m["function"], m["payload"],
                              attempt=rec.attempt,
                              not_before=now() + rq.delay_ms,
                              t_queued=m["t_queued"], kind=rq.kind,
                              sleeps_done=rq.sleeps_done, wait=rq.wait)
                self.broker.put(_ACK + seq, {"by": "suspend"})
        except (_Killed, shim.ShimError):
            # crashed between effects: release the lease early (with
            # backoff) so redelivery happens before the visibility timeout
            with self.broker.locked():
                rec.status = "crashed"
                rec.t_end = now()
                self._rec_put(rec)
                self.broker.put(_LEASE + seq, {
                    "deadline": now() + self.retry_backoff_ms,
                    "attempt": rec.attempt, "worker": "released"})
        except BaseException as e:
            # user-code / interpreter bug: not a substrate fault, no
            # redelivery — surface it to run() loudly
            with self.broker.locked():
                rec.status = "crashed"
                rec.t_end = now()
                self._rec_put(rec)
                self.broker.put(_ERR + seq, {
                    "repr": repr(e), "tb": traceback.format_exc()})
                self.broker.put(_ACK + seq, {"by": "error"})
        else:
            with self.broker.locked():
                rec.status = "done"
                rec.result = result
                rec.t_end = now()
                self._rec_put(rec)
                self.broker.put(_ACK + seq, {"by": "done"})

    # ---- quiescence ---------------------------------------------------------

    def _scan_pending(self) -> Tuple[int, Optional[dict]]:
        """(undelivered-or-unfinished message count, first fatal error).
        Signal waits with no latch are *parked*, not pending — ``run``
        returns with them suspended, exactly like SimCloud."""
        with self.broker.locked():
            pending = 0
            for key in self.broker.list_prefix(_MSG):
                seq = key[len(_MSG):]
                if self.broker.get(_ACK + seq) is not None:
                    continue
                m = self.broker.get(key)
                if m["kind"] == "signal" and not self._latch_present(*m["wait"]):
                    continue
                pending += 1
            errs = self.broker.items_prefix(_ERR)
            return pending, (errs[0][1] if errs else None)

    # ---- effect interpreter (runs inside workers) ---------------------------

    def _apply(self, ex: RemoteExecution, effect: shim.Effect) -> Any:
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

    def _perform_now(self, ex: RemoteExecution, effect: shim.Now) -> float:
        return _wall_ms()

    def _perform_trace(self, ex: RemoteExecution, effect: shim.Trace) -> None:
        ex.record.phases.append((_wall_ms(), effect.phase))
        return None

    def _perform_create_client(self, ex: RemoteExecution,
                               effect: shim.CreateClient) -> str:
        return effect.target

    def _perform_run_user(self, ex: RemoteExecution,
                          effect: shim.RunUser) -> Any:
        return ex.dep.workload.output(effect.data)

    def _perform_invoke(self, ex: RemoteExecution,
                        effect: shim.Invoke) -> bool:
        target = self._faas.get(effect.faas)
        if target is None:
            raise shim.InvocationError(f"unknown FaaS {effect.faas}")
        if self._down_state(effect.faas) is not None:
            raise shim.InvocationError(f"{effect.faas} is down")
        nbytes = effect.size_bytes or estimate_size(effect.payload)
        if nbytes > target.payload_quota:
            raise shim.PayloadTooLarge(
                f"{nbytes}B > quota {target.payload_quota}B on {effect.faas}")
        if (effect.faas, effect.function) not in self.deployments:
            raise shim.InvocationError(
                f"{effect.function} not deployed on {effect.faas}")
        now = _wall_ms()
        self._enqueue(effect.faas, effect.function, effect.payload,
                      attempt=0, not_before=now, t_queued=now)
        return True

    def _perform_parallel(self, ex: RemoteExecution,
                          effect: shim.Parallel) -> List[Any]:
        """Sub-effects fan out on threads inside this worker (the shared
        store's lock stack is thread-safe); suspension inside Parallel is
        rejected loudly — it would strand the sibling branches."""
        subs = list(effect.effects)
        if not subs:
            return []
        if any(type(s) in (shim.Sleep, shim.WaitForSignal) for s in subs):
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

    def _perform_prefetch(self, ex: RemoteExecution,
                          effect: shim.Prefetch) -> bool:
        raise shim.CapabilityError(
            "remote substrate has no prefetch capability "
            "(deploy with prefetch=False)")

    def _perform_ds(self, ex: RemoteExecution, effect: shim.Effect) -> Any:
        st = self.stores.get(getattr(effect, "ds", None))
        if st is None:
            raise shim.DataStoreError(
                f"unknown datastore {getattr(effect, 'ds', None)}")
        klass = effect.__class__
        if klass is shim.DsCreate:
            return st.create_if_absent(effect.key, effect.value)
        if klass is shim.DsGet:
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

    def _perform_sleep(self, ex: RemoteExecution, effect: shim.Sleep) -> None:
        if effect.ms <= 0:
            return None
        ex.sleeps_seen += 1
        if ex.sleeps_seen <= ex.msg.get("sleeps_done", 0):
            # non-durable redelivery re-runs the handler from the top: the
            # wake message says how many sleeps this delivery already paid
            return None
        raise _Requeue(effect.ms, sleeps_done=ex.sleeps_seen)

    def _perform_wait_signal(self, ex: RemoteExecution,
                             effect: shim.WaitForSignal) -> Any:
        scope = effect.scope
        if not scope:
            raise shim.ShimError(
                f"WaitForSignal({effect.name!r}) reached the interpreter "
                f"with no workflow scope")
        if self._signal_table is not None:
            stored = self.stores[self._signal_table].get(
                signal_key(scope, effect.name))
            if stored is not None:
                return stored["v"]
        raise _Requeue(0.0, kind="signal", sleeps_done=ex.sleeps_seen,
                       wait=(scope, effect.name))

    # ---- Backend protocol: record-query surface -----------------------------

    def _records(self) -> List[ExecutionRecord]:
        out = []
        for _, d in self.broker.items_prefix(_REC):
            out.append(ExecutionRecord(**d))
        return out                      # key order == exec_id order

    def executions_of(self, function: str) -> List[ExecutionRecord]:
        return [r for r in self._records() if r.function == function]

    def completed(self) -> List[ExecutionRecord]:
        return [r for r in self._records() if r.status == "done"]

    def workflow_records(self, prefix: str) -> List[ExecutionRecord]:
        out = []
        for r in self._records():
            payload = r.payload
            wfid = None
            if payload.__class__ is dict:
                ctl = payload.get("Control")
                if ctl.__class__ is dict:
                    wfid = ctl.get("workflowId")
                else:
                    wfid = payload.get("workflow_id")
            if wfid is not None and str(wfid).startswith(prefix):
                out.append(r)
        return out

    @property
    def dropped(self) -> List[Tuple[str, str, Any]]:
        """(faas, function, payload) of budget-exhausted invocations,
        served from the shared store (every process's drops included)."""
        return [v for _, v in self.broker.items_prefix(_DROP)]

    @property
    def drop_count(self) -> int:
        return len(self.dropped)

    def close(self) -> None:
        """Stop any live pool; remove the store directory iff we own it."""
        if self._procs:
            self._stop_pool(self._generation)
        if self._owns_dir:
            shutil.rmtree(self.store_dir, ignore_errors=True)


def deploy_remote(runner: RemoteRunner, spec, catalog=None):
    """Deploy a WorkflowSpec onto a RemoteRunner — thin alias of the one
    backend-agnostic deploy path (``repro_torch.core.workflow.deploy``)."""
    from repro_torch.core.workflow import deploy
    return deploy(runner, spec, catalog)
