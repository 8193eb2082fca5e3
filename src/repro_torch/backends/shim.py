"""Backend-Shim: the distributed compatibility layer (paper §3.2, Table 2).

The function-side orchestrator is written once as an *effect generator*: it
``yield``s small effect objects describing datastore accesses and function
invocations, and a backend interpreter executes them.  Two interpreters exist:

  * :mod:`repro_torch.backends.simcloud` — deterministic discrete-event Jointcloud
    simulator (virtual clock, latency + billing models, failure injection);
  * :mod:`repro_torch.backends.localjax` — real concurrent in-process execution
    where workflow nodes are actual (jitted) JAX calls on per-FaaS thread
    pools.

This mirrors the paper exactly: the orchestration *logic* is cloud-agnostic
and every cloud interaction goes through the shim's Table-2 API surface:

    DSBackend:   store_output_data, get_value, create_invocation_list,
                 append_and_get_list, create_bitmap, update_bitmap
    FaaSBackend: create, async_invoke

Effects carry backend *ids* of the form ``"cloud/service"`` (e.g.
``"aws/dynamodb"``, ``"aliyun/fc_gpu"``); resolution to a concrete client is
the interpreter's job — user code and the orchestrator never see cloud SDKs.

The Backend protocol (the invariant new substrates implement)
-------------------------------------------------------------
The deploy/runtime layer above the shim (:mod:`repro_torch.core.workflow`) is
substrate-blind: it talks to any object satisfying the :class:`Backend`
protocol defined at the bottom of this module.  A new backend (a real AWS
driver, a Ray cluster, ...) must provide

  1. the **Table-2 execution surface** — ``deploy(Deployment)``,
     ``submit(faas, function, payload, t=0.0)``, ``run(...)`` — backed by an
     interpreter for the effect classes below, and
  2. the **record-query surface** — ``catalog()``, ``executions_of(fn)``,
     ``completed()``, ``workflow_records(wfid_prefix)``, ``dropped`` — over
     :class:`ExecutionRecord` instances, so ``DeployedWorkflow``'s
     makespan / result / trace extraction works unchanged.

The full authoring guide (semantics, capability table, checklist) is
``docs/backends.md``.

Optional **capabilities** (``topology``, ``faas`` flavor maps) are *probed*
by ``DeployedWorkflow.replan()`` with ``getattr`` — a backend that lacks
them degrades to a :class:`CapabilityError`, never an ``AttributeError``.
The shared runtime types (:class:`Workload`, :class:`Deployment`,
:class:`ExecutionRecord`, :class:`Blob`, :func:`estimate_size`) live here so
neither the generic layer nor a backend has to import another backend.
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Generator, List, Mapping, Optional,
                    Protocol, Sequence, Tuple, runtime_checkable)

from repro_torch.backends import calibration as cal


# ==========================================================================
# Errors (the failure surface the failover path reacts to — paper Fig 10)
# ==========================================================================


class ShimError(Exception):
    """Base class for errors surfaced to the orchestrator."""


class InvocationError(ShimError):
    """async_invoke failed (FaaS system down / network partition)."""


class DataStoreError(ShimError):
    """Datastore unreachable (its cloud is down)."""


class PayloadTooLarge(ShimError):
    """Direct-transfer payload exceeds the FaaS async quota (§4.3.1)."""


class CapabilityError(ShimError):
    """An optional :class:`Backend` capability (e.g. ``topology``) was
    requested from a backend that does not provide it.  Raised by the
    generic layer's capability probes (``DeployedWorkflow.replan()``)
    instead of letting an ``AttributeError`` escape."""


# ==========================================================================
# Effects
# ==========================================================================


@dataclass
class Effect:
    """Base effect. ``result`` semantics are documented per subclass."""


# ---- DSBackend ops (Table 2) -------------------------------------------


@dataclass
class DsCreate(Effect):
    """Conditionally create ``key`` := ``value`` (create-if-not-exists).

    Backs ``store_output_data`` (value = output blob),
    ``create_invocation_list`` (value = []) and ``create_bitmap``
    (value = [False]*size).  Atomic.  Result: ``True`` iff created.
    """

    ds: str
    key: str
    value: Any
    size_bytes: int = 0


@dataclass
class DsGet(Effect):
    """Strongly-consistent read. Result: stored value or ``None``."""

    ds: str
    key: str


@dataclass
class DsAppendGetList(Effect):
    """Atomically append ``items`` to the list at ``key`` and return it.

    Matches ``append_and_get_list`` in Table 2 (invocation checkpoints and
    ByBatch/ByRedundant coordination points).
    """

    ds: str
    key: str
    items: Sequence[Any]


@dataclass
class DsUpdateBitmap(Effect):
    """Set bit ``index`` of the bitmap at ``key``; returns the updated bitmap
    (a strongly-consistent read-after-write, as used by fan-in, §4.3.2)."""

    ds: str
    key: str
    index: int


@dataclass
class DsListPrefix(Effect):
    """List keys with ``prefix`` (GC support, §4.4). Result: list[str]."""

    ds: str
    prefix: str


@dataclass
class DsDelete(Effect):
    """Delete ``keys`` (GC). Result: number deleted."""

    ds: str
    keys: Sequence[str]


# ---- FaaSBackend ops -----------------------------------------------------


@dataclass
class CreateClient(Effect):
    """Construct an SDK client for ``target`` (a FaaS or datastore id).

    Modelled explicitly because client construction is the dominant cost of
    failover (§5.3: ≈78 ms ≈ client creation + one cross-cloud invocation).
    Result: opaque handle (the id itself).
    """

    target: str


@dataclass
class Invoke(Effect):
    """Asynchronous HTTP invocation of ``function`` deployed on ``faas``.

    Raises :class:`InvocationError` into the generator if the target FaaS
    system is unreachable.  Result: ``True`` (accepted).
    """

    faas: str
    function: str
    payload: Any
    size_bytes: int = 0


@dataclass
class RunUser(Effect):
    """Execute the user function of the current node with ``data``.

    The interpreter either advances virtual time per the node's workload
    model (SimCloud) or actually calls the node's Python/JAX callable
    (localjax).  Result: the user function output.
    """

    data: Any


@dataclass
class Prefetch(Effect):
    """Speculatively push ``ds[key]`` toward cloud ``dest`` *now* — before
    the downstream consumer asks for it — so the eventual ``DsGet`` pays
    only the residual wire time (GeoFF-style data pre-fetching).

    Contract (the ``prefetch`` capability; see ``docs/backends.md``):

    * **flow-open**: the push is a real transfer that opens a flow through
      the substrate's contention accounting at yield time, stretching
      concurrent flows honestly — never free bandwidth;
    * **best-effort hint**: it must not change workflow *semantics* — the
      consuming ``DsGet`` still returns the authoritative store value, and
      a lost/aborted push degrades to a plain on-demand transfer;
    * **mis-prediction fallback**: ``size_bytes`` is the planner's
      prediction; when the actual value is larger, the consumer pays a
      residual on-demand transfer for the shortfall;
    * **abort-on-crash**: a push issued by an attempt that later crashes
      must be cleanly discarded — it may never leak partial inputs past
      the §4.1 checkpoints / durable journal;
    * **idempotent**: re-yielding (at-least-once retry) for the same
      ``(ds, key, dest)`` must not double-transfer or double-bill.

    Result: ``True`` iff a push was started (``False``: duplicate,
    intra-cloud, or value not yet present).
    """

    ds: str
    key: str
    dest: str               # destination *cloud* name
    size_bytes: int = 0     # predicted wire size (0: size at push time)


@dataclass
class Parallel(Effect):
    """Execute sub-effects concurrently (the 10-thread fan-out of §4.1.2).

    Elapsed time is the max of the children; each child's result (or
    exception instance) is returned positionally.  Exceptions are *returned*,
    not raised, so the orchestrator can fail over per-branch.
    """

    effects: Sequence[Effect]


@dataclass
class Sleep(Effect):
    """Suspend the current execution for ``ms`` (virtual or wall) without
    occupying a concurrency slot.

    The interpreter MUST release the execution's slot/worker for the whole
    duration and re-acquire one at wake-up — a sleeping workflow costs no
    capacity and (SimCloud) no GB·s billing.  Result: ``None``.
    """

    ms: float


@dataclass
class WaitForSignal(Effect):
    """Suspend until ``backend.signal(workflow_id, name)`` delivers ``name``.

    Signals are per-workflow latches: delivery before the wait resolves the
    wait immediately (no lost-wakeup), the first delivery wins, and the
    latch is durable (journal-capable backends persist it so a replayed
    workflow observes the same value).  Like :class:`Sleep`, a waiting
    execution occupies zero concurrency slots.  Result: the signal value.
    """

    name: str
    scope: str = ""          # workflow id; interpreters fill it from context


@dataclass
class Now(Effect):
    """Current time in ms (virtual or wall). Result: float."""


@dataclass
class Trace(Effect):
    """Attribute elapsed-time bookkeeping to a named phase (Fig 20 traces)."""

    phase: str


EffectGen = Generator[Effect, Any, Any]


# ==========================================================================
# Abstract backend interfaces (Table 2) — implemented by interpreters
# ==========================================================================


class DSBackend(abc.ABC):
    """Datastore client contract. All ops atomic; reads strongly consistent."""

    @abc.abstractmethod
    def store_output_data(self, key: str, data: Any) -> bool:
        """Conditionally create an item/object; True iff created."""

    @abc.abstractmethod
    def get_value(self, key: str) -> Any:
        """Strong-consistency read; None if absent."""

    @abc.abstractmethod
    def create_invocation_list(self, key: str) -> bool:
        """Conditionally create an empty string list."""

    @abc.abstractmethod
    def append_and_get_list(self, key: str, items: Sequence[Any]) -> list:
        """Append items, return the latest list."""

    @abc.abstractmethod
    def create_bitmap(self, size: int, key: str) -> bool:
        """Conditionally create a bitmap of ``size`` False bits."""

    @abc.abstractmethod
    def update_bitmap(self, index: int, key: str) -> list:
        """Set bit ``index``; return the updated bitmap."""


class FaaSBackend(abc.ABC):
    """FaaS client contract."""

    @abc.abstractmethod
    def async_invoke(self, function: str, payload: Any) -> bool:
        """Asynchronous HTTP invocation; raises InvocationError when down."""


def ds_id(cloud: str, store: str) -> str:
    """Canonical datastore backend id, e.g. ``ds_id("aws", "dynamodb")``."""
    return f"{cloud}/{store}"


def faas_id(cloud: str, system: str) -> str:
    """Canonical FaaS backend id, e.g. ``faas_id("aliyun", "fc_gpu")``."""
    return f"{cloud}/{system}"


def cloud_of(backend_id: str) -> str:
    """The cloud part of a ``"cloud/service"`` backend id."""
    return backend_id.split("/", 1)[0]


def build_catalog(stores: Mapping[str, Any], faas: Mapping[str, Any]) -> Any:
    """Service directory over a substrate's entity maps (Backend protocol's
    ``catalog()``): first store of each kind per cloud, the tightest payload
    quota per cloud, and the cheapest-flavor GC host per cloud.  One body so
    every backend applies identical catalog rules — stores need ``.kind`` /
    ``.cloud``, FaaS entries ``.cloud`` / ``.payload_quota`` /
    ``.flavor.price_per_gb_s``."""
    from repro_torch.core import subgraph as sg   # lazy: core imports backends
    tables: Dict[str, str] = {}
    objects: Dict[str, str] = {}
    quotas: Dict[str, int] = {}
    gc_faas: Dict[str, str] = {}
    for did, store in stores.items():
        target = tables if store.kind == "table" else objects
        target.setdefault(store.cloud, did)
    for fid, f in faas.items():
        quotas.setdefault(f.cloud, f.payload_quota)
        quotas[f.cloud] = min(quotas[f.cloud], f.payload_quota)
        # GC prefers the cheapest (CPU) flavor in each cloud
        cur = gc_faas.get(f.cloud)
        if cur is None or f.flavor.price_per_gb_s < faas[cur].flavor.price_per_gb_s:
            gc_faas[f.cloud] = fid
    return sg.Catalog(tables, objects, quotas, gc_faas)


# ==========================================================================
# Shared runtime types — backend-agnostic, consumed by every interpreter
# (SimCloud re-exports them for backward compatibility)
# ==========================================================================


@dataclass(frozen=True)
class Blob:
    """Opaque data of a known size (video chunk, tensor, document...).

    Workloads pass Blobs around so egress/quota accounting sees realistic
    byte counts without materializing data.
    """

    nbytes: int
    tag: str = ""

    def __repr__(self) -> str:  # keep repr small: Blob is sized explicitly
        return f"Blob({self.nbytes}b,{self.tag})"


# Container sizes are memoized by identity with a top-level ``len`` guard:
# stored lists may grow via append (len changes ⇒ recompute) but must not be
# structurally resized at constant length — the only such pattern in the
# repo, bitmap bit flips, is size-neutral (bool stays 5 bytes).  Entries keep
# a strong reference to the container so ids cannot be recycled while cached;
# the table is cleared wholesale when it fills.
_SIZE_MEMO: Dict[int, Tuple[Any, int, int]] = {}
_SIZE_MEMO_MAX = 1 << 16


def estimate_size(obj: Any) -> int:
    """Rough wire size of a payload value, honoring explicit Blob sizes."""
    t = obj.__class__
    if t is Blob:
        return obj.nbytes
    if t is bytes:
        return len(obj)
    if t is str:
        # UTF-8 length; the ascii flag is O(1) and covers nearly every key
        return len(obj) if obj.isascii() else len(obj.encode())
    if t is bool:
        return 5
    if t is int or t is float:
        return 8
    if obj is None:
        return 4
    if t is dict or t is list or t is tuple:
        key = id(obj)
        hit = _SIZE_MEMO.get(key)
        if hit is not None and hit[0] is obj and hit[1] == len(obj):
            return hit[2]
        if t is dict:
            size = 2
            for k, v in obj.items():
                size += estimate_size(k) + estimate_size(v) + 2
        else:
            size = 2
            for v in obj:
                size += estimate_size(v) + 1
        if len(_SIZE_MEMO) >= _SIZE_MEMO_MAX:
            _SIZE_MEMO.clear()
        _SIZE_MEMO[key] = (obj, len(obj), size)
        return size
    # rare subclassed/odd types: original isinstance-chain semantics
    if isinstance(obj, Blob):
        return obj.nbytes
    if isinstance(obj, bytes):
        return len(obj)
    if isinstance(obj, str):
        return len(obj.encode())
    if isinstance(obj, bool):
        return 5
    if isinstance(obj, (int, float)):
        return 8
    if isinstance(obj, dict):
        return 2 + sum(estimate_size(k) + estimate_size(v) + 2 for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return 2 + sum(estimate_size(v) + 1 for v in obj)
    return len(repr(obj))


@dataclass
class Workload:
    """Reference duration model for a workflow node's user function.

    ``compute_ms`` scales with the flavor speed (Fig 1 heterogeneity);
    ``fixed_ms`` does not (I/O, (de)serialization).  ``fn`` produces the
    value-level output; if omitted the input is forwarded.

    ``accel`` marks GPU-amenable compute (BERT/ResNet class): on a GPU
    flavor a non-accel stage runs at CPU-reference speed — video splitting
    does not get 15× faster by renting a GPU.  ``out_bytes`` is a static
    hint of the output's wire size, consumed by the placement planner
    (runtime sizing still uses the actual value via ``estimate_size``);
    ``out_bytes_std`` is the declared *uncertainty* of that hint (std-dev),
    the confidence figure the prefetch planner gates speculation on —
    ``None`` means "exact" (the default for static hints).

    Interpreters use the two halves differently: SimCloud advances virtual
    time by ``duration_ms`` and calls ``fn`` for the value; the local
    backend runs ``fn`` for real and measures wall-clock.
    """

    compute_ms: float = 0.0
    fixed_ms: float = 0.0
    fn: Optional[Callable[[Any], Any]] = None
    out_bytes: Optional[int] = None
    accel: bool = True
    out_bytes_std: Optional[float] = None

    def duration_ms(self, flavor: cal.Flavor) -> float:
        """Reference duration on ``flavor``: the compute half scales with
        flavor speed (GPU speedup only for ``accel`` work), the fixed half
        does not."""
        speed = 1.0 if (flavor.gpu and not self.accel) else flavor.speed
        return self.compute_ms / max(speed, 1e-9) + self.fixed_ms

    def output(self, data: Any) -> Any:
        """Value-level output of the user function (input forwarded when no
        ``fn`` is declared)."""
        return self.fn(data) if self.fn is not None else data


@dataclass
class Deployment:
    """A function deployed on one FaaS system."""

    function: str
    faas: str                                  # "cloud/system"
    handler: Callable[[Any], Generator]        # event -> effect generator
    workload: Workload = field(default_factory=Workload)
    memory_gb: Optional[float] = None          # default: flavor memory
    max_retries: int = cal.MAX_RETRIES


@dataclass
class ExecutionRecord:
    """One attempt of a deployed function, as every backend reports it.

    ``status`` ∈ queued|running|suspended|done|crashed|aborted|dropped —
    ``dropped`` marks an invocation abandoned after the substrate's retry
    budget was exhausted (it must be *recorded*, never silently discarded);
    ``suspended`` marks an attempt parked on ``Sleep``/``WaitForSignal``,
    holding no concurrency slot until its wake condition fires."""

    exec_id: int
    function: str
    faas: str
    t_queued: float
    t_start: float = math.nan
    t_end: float = math.nan
    status: str = "queued"
    attempt: int = 0
    payload: Any = None
    result: Any = None
    phases: List[Tuple[float, str]] = field(default_factory=list)

    def phase_breakdown(self) -> Dict[str, float]:
        """Per-phase elapsed time (Fig-20-style decomposition)."""
        out: Dict[str, float] = {}
        marks = self.phases + [(self.t_end, "_end")]
        for (t0, name), (t1, _) in zip(marks, marks[1:]):
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out


# ==========================================================================
# The Backend protocol — what repro_torch.core.workflow deploys onto
# ==========================================================================


@runtime_checkable
class Backend(Protocol):
    """Structural contract every workflow substrate implements.

    ``repro_torch.core.workflow.deploy`` / :class:`DeployedWorkflow` only ever
    call this surface, so the same workflow artifact runs unchanged on any
    implementation (SimCloud, LocalRunner, a future real-cloud driver).

    **Execution surface**

    * ``deploy(dep)`` — register a :class:`Deployment` under
      ``(dep.faas, dep.function)`` in ``deployments``.
    * ``submit(faas, function, payload, t=0.0)`` — external async-invoke.
      ``t`` is a *delay in milliseconds* relative to the backend's clock
      (virtual time on SimCloud, wall-clock on the local runner).  A backend
      that cannot schedule into the future MUST either honor the delay or
      reject a non-zero ``t`` loudly — silently ignoring it is a bug.
    * ``run(...)`` — drive the substrate until quiescent (no queued or
      in-flight work).  Backend-specific limits (virtual-time horizon,
      wall-clock timeout) are keyword arguments.

    **Record-query surface** (serves indexes, never record scans)

    * ``catalog()`` — the :class:`repro_torch.core.subgraph.Catalog` describing
      this substrate's stores/quotas/GC hosts; the single input the
      sub-graph compiler needs.
    * ``executions_of(function)`` — all attempts of one function.
    * ``completed()`` — all ``done`` records, sorted by ``exec_id``.
    * ``workflow_records(prefix)`` — all records whose workflow id starts
      with ``prefix`` (``-batchN`` spin-offs included), by ``exec_id``.
    * ``dropped`` — invocations abandoned after the retry budget; an empty
      list on a healthy run.

    **Optional capabilities** — probed via ``getattr``, never assumed:
    ``topology`` (a :class:`repro_torch.core.costmodel.Topology`) and ``faas``
    (a mapping ``faas_id -> object`` with ``.flavor``/``.cloud``) enable
    ``DeployedWorkflow.replan()``/``learn_profiles()``; backends without
    them get a :class:`CapabilityError` instead of an ``AttributeError``.

    The durable-execution pair (probed the same way):

    * ``journal`` — truthy iff the backend's datastores persist the
      ``{function_id}#j/…`` effect journal across backend instances (see
      ``docs/backends.md`` §"Durable execution").  Enables
      ``DeployedWorkflow.resume()``: a fresh backend constructed over the
      same stores replays journaled effects through the unchanged handler
      code, suppressing live side effects until the journal is exhausted.
    * ``signal(workflow_id, name, value=True, t=0.0)`` — deliver a named
      signal to a workflow, resolving any :class:`WaitForSignal` on it.
      ``t`` is a delay in ms, same contract as ``submit(t=)``.  Backends
      without it get a :class:`CapabilityError` from
      ``DeployedWorkflow.signal()`` and ``traffic.LoadRunner``.

    The speculative-transfer capability:

    * ``prefetch`` — truthy iff the backend interprets the
      :class:`Prefetch` effect per its contract (flow-open accounting,
      mis-prediction residual fallback, abort-on-crash, idempotent pushes;
      see ``docs/backends.md`` §"Prefetch").  Probed by
      ``workflow.deploy(prefetch=True)``, which degrades to a
      :class:`CapabilityError` on backends without it — handlers on a
      non-capable backend never yield :class:`Prefetch`.
    """

    deployments: Dict[Tuple[str, str], Deployment]
    dropped: List[Any]

    def deploy(self, dep: Deployment) -> None:
        """Register ``dep`` under ``(dep.faas, dep.function)``; re-deploying
        the same key replaces it (how re-planning swaps placements in)."""
        ...

    def submit(self, faas: str, function: str, payload: Any,
               t: float = 0.0) -> None:
        """External async-invoke after a delay of ``t`` ms relative to this
        backend's clock.  Honor the delay or reject non-zero ``t`` loudly;
        negative ``t`` is always a ``ValueError``."""
        ...

    def run(self, *args: Any, **kwargs: Any) -> Any:
        """Drive the substrate until quiescent; limits (``t_max=``,
        ``timeout_s=``) are backend-specific keywords."""
        ...

    def catalog(self) -> Any:
        """This substrate's service directory (``subgraph.Catalog``); build
        it with :func:`build_catalog` for uniform rules."""
        ...

    def executions_of(self, function: str) -> List[ExecutionRecord]:
        """All attempts of one function, from an index (never a scan)."""
        ...

    def completed(self) -> List[ExecutionRecord]:
        """All ``done`` records, sorted by ``exec_id``."""
        ...

    def workflow_records(self, prefix: str) -> List[ExecutionRecord]:
        """All records whose workflow id starts with ``prefix``
        (``-batchN`` spin-offs included), sorted by ``exec_id``."""
        ...
