"""The function-side workflow orchestrator (paper §3.3–§4).

This is the code that ships *inside every function's wrapper*.  It is written
once as an effect generator (see :mod:`repro_torch.backends.shim`) and runs
unchanged on the SimCloud and local-JAX backends.

Execution of one function attempt (Figs 7 & 8):

    1. Unwrap the incoming JointλObject (entry functions mint the Control).
    2. Output-checkpoint protocol — *at-most-once data production*:
       conditional-create ``<fid>-output``; re-executions reuse the stored
       value, so duplicates cannot change the workflow's data.
    3. Wrap — *at-most-once invocation*: the ``<fid>-ivk`` string list records
       which successors were already invoked; fan-outs > 10 are invoked with
       10-way parallelism and checkpointed in groups of 10 (§4.1.2).
    4. Failover (Fig 10): an invocation error triggers client creation for the
       backup FaaS system and re-invocation there.
    5. Coordination (§4.3.2): fan-in peers meet at a strongly-consistent
       bitmap; ByBatch/ByRedundant use a shared list/first-wins checkpoints.
    6. Terminal functions trigger per-cloud GC (§4.4).

Combined with the substrate's at-least-once delivery this yields the paper's
exactly-once execution semantics — property-tested under random crash
schedules in ``tests/test_exactly_once.py``.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Any, Dict, Generator, List, Optional, Sequence, Tuple

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.backends.datastore import (JOURNAL_DONE, JOURNAL_SEP,
                                      JOURNAL_START, SIGNAL_NS)
from repro_torch.backends.shim import (CreateClient, DsAppendGetList, DsCreate, DsDelete,
                                 DsGet, DsListPrefix, DsUpdateBitmap, Invoke,
                                 InvocationError, Parallel, Prefetch, RunUser,
                                 Sleep, Trace, WaitForSignal)
from repro_torch.core import subgraph as sg
from repro_torch.core.jlobject import JLObject, fits_quota
from repro_torch.core.naming import (BITMAP_SUFFIX, IVK_SUFFIX, OUTPUT_SUFFIX,
                               Control, collaboration_key)

# Interned Trace effects: phase markers are yielded a handful of times per
# function attempt (millions of times per sweep), every interpreter only ever
# *reads* ``.phase``, and the phase vocabulary is closed — so one shared
# instance per phase replaces a per-yield allocation (profile-driven;
# ``tests/test_simcloud_engine.py`` digests pin that timelines are unchanged).
_TR_UNWRAP = Trace("unwrap")
_TR_OUTPUT_CKP = Trace("output_ckp")
_TR_SUSPEND = Trace("suspend")
_TR_USER_EXEC = Trace("user_exec")
_TR_IVK_CKP = Trace("ivk_ckp")
_TR_INVOKE = Trace("invoke")
_TR_COORD = Trace("coordination")
_TR_FAILOVER = Trace("failover")
_TR_GC = Trace("gc")


# value envelope so a stored ``None`` output is distinguishable from "absent"
def _env(value: Any) -> dict:
    return {"v": value}


def _unenv(stored: Any) -> Any:
    return stored["v"] if isinstance(stored, dict) and set(stored) == {"v"} else stored


class WorkflowState:
    """Runtime state of the current function (paper Fig 4)."""

    def __init__(self, view: sg.NodeView, jl: JLObject):
        self.view = view
        self.jl = jl
        self.control = jl.control
        fid = self.control.function_id(view.name)   # built once, not thrice
        self.function_id = fid
        self.output_key = fid + OUTPUT_SUFFIX
        self.ivk_key = fid + IVK_SUFFIX
        self.output_ds = view.output_ds
        self.table = view.home_table
        self.output_ckp_hit = False


@dataclass
class _Planned:
    """One successor invocation the Wrap step intends to make."""

    key: str                 # name recorded in the invocation checkpoint
    name: str                # target function
    faas: str
    failover: Tuple[str, ...]
    event: dict
    nbytes: int = 0


# ==========================================================================
# Entry point: the wrapper around every user function
# ==========================================================================


def make_handler(view: sg.NodeView):
    """Bind a NodeView into a SimCloud/local deployment handler.

    Durable nodes get the event-sourced journal wrapper from
    :mod:`repro_torch.core.durable` interposed — same effect language, so the
    choice is invisible to every backend interpreter."""
    if view.durable:
        from repro_torch.core.durable import journaled_handle

        def handler(event: Any) -> Generator:
            return journaled_handle(view, event)

        return handler

    def handler(event: Any) -> Generator:
        return handle(view, event)

    return handler


def handle(view: sg.NodeView, event: Any) -> Generator:
    yield _TR_UNWRAP
    jl = _parse_event(view, event)
    wfs = WorkflowState(view, jl)

    # ---- Fig 7: output data checkpoint (at-most-once data production) ------
    yield _TR_OUTPUT_CKP
    ckp1 = yield DsGet(wfs.output_ds, wfs.output_key)
    if ckp1 is not None:
        output = _unenv(ckp1)
        wfs.output_ckp_hit = True
    else:
        # Declarative suspension points run before the user function and only
        # when the output is not yet checkpointed (a retried attempt that
        # already produced data must not wait again).  Both effects release
        # the execution's concurrency slot for the whole suspension.
        if view.wait_signal:
            yield _TR_SUSPEND
            yield WaitForSignal(view.wait_signal, wfs.control.workflow_id)
        if view.sleep_ms:
            yield _TR_SUSPEND
            yield Sleep(view.sleep_ms)
        yield _TR_UNWRAP
        data = yield from _unwrap(jl)
        yield _TR_USER_EXEC
        output = yield RunUser(data)
        yield _TR_OUTPUT_CKP
        yield DsCreate(wfs.output_ds, wfs.output_key, _env(output))
        # fan-in peer with an armed prefetch directive: our output lives in
        # the group datastore (output_ds == fanin.ds by compilation) and the
        # aggregator's read key is this very checkpoint — push it toward the
        # aggregator's cloud while the slower peers still compute.
        if view.fanin is not None and view.fanin.prefetch_bytes:
            yield Prefetch(wfs.output_ds, wfs.output_key,
                           shim.cloud_of(view.fanin.agg_faas),
                           view.fanin.prefetch_bytes)

    # ---- Fig 8: Wrap — invoke successors with invocation checkpoints --------
    yield from _wrap(view, wfs, output)
    return output


def _parse_event(view: sg.NodeView, event: Any) -> JLObject:
    """Entry functions mint the Control; downstream hops carry one."""
    if isinstance(event, dict) and "Control" in event:
        return JLObject.from_event(event)
    if not view.is_entry:
        raise ValueError(f"{view.name}: non-entry function received a raw event")
    if isinstance(event, dict):
        wfid = event.get("workflow_id") or uuid.uuid4().hex
        value = event.get("input", event)
    else:
        wfid, value = uuid.uuid4().hex, event
    return JLObject.direct(Control(wfid, step=view.level), value)


def _unwrap(jl: JLObject) -> Generator:
    """Fetch the user input (pull indirect data from the datastore)."""
    if not jl.is_indirect:
        return jl.direct_value
    keys = jl.indirect_keys
    results = yield Parallel([DsGet(jl.indirect_ds, k) for k in keys])
    vals = []
    for k, r in zip(keys, results):
        if isinstance(r, BaseException):
            raise r
        if r is None:
            raise shim.DataStoreError(f"missing indirect input {k}")
        vals.append(_unenv(r))
    if "select" in jl.meta:                       # Map branch: index parent output
        return vals[0][jl.meta["select"]]
    if jl.meta.get("fanin_inputs"):
        return vals
    return vals[0] if len(vals) == 1 else vals


# ==========================================================================
# Wrap: invocation planning + checkpointed execution
# ==========================================================================


def _wrap(view: sg.NodeView, wfs: WorkflowState, output: Any) -> Generator:
    if view.fanin is None and not view.next_funcs:
        yield from _run_gc(view, wfs)
        return

    yield _TR_IVK_CKP
    yield DsCreate(wfs.table, wfs.ivk_key, [])          # create_invocation_list
    ckp2: List[str] = (yield DsGet(wfs.table, wfs.ivk_key)) or []

    planned: List[_Planned] = []

    # -- Cycle edges take priority: while the guard holds, loop back ----------
    cycle_taken = False
    for info in view.next_funcs:
        if info.mode == sg.CYCLE and info.predicate is not None and info.predicate(output):
            ctl = wfs.control.next_iteration(info.step)
            planned += yield from _plan_one(wfs, info, ctl, output, key=f"{info.name}~it")
            cycle_taken = True
            break

    if not cycle_taken:
        parallel_idx = 0
        choice_done = False
        for info in view.next_funcs:
            if info.mode == sg.CYCLE:
                continue
            if info.mode == sg.SEQUENCE:
                ctl = wfs.control.advance(info.step)
                planned += yield from _plan_one(wfs, info, ctl, output, key=info.name)
            elif info.mode == sg.CHOICE:
                if choice_done:
                    continue
                if info.predicate is None or info.predicate(output):
                    ctl = wfs.control.advance(info.step)
                    planned += yield from _plan_one(wfs, info, ctl, output, key=info.name)
                    choice_done = True
            elif info.mode == sg.PARALLEL:
                ctl = wfs.control.push_branch(parallel_idx, info.step)
                planned += yield from _plan_one(wfs, info, ctl, output,
                                                key=f"{info.name}#{parallel_idx}")
                parallel_idx += 1
            elif info.mode == sg.MAP:
                if not isinstance(output, (list, tuple)):
                    raise TypeError(f"{view.name}: Map successor requires list output")
                planned += yield from _plan_map(wfs, info, output)
            elif info.mode == sg.BY_REDUNDANT:
                planned += yield from _plan_redundant(wfs, info, output)
            elif info.mode == sg.BY_BATCH:
                planned += yield from _plan_batch(view, wfs, info, output)
            else:
                raise ValueError(f"unknown invocation mode {info.mode}")

    yield from _invoke_planned(wfs, planned, ckp2)

    # -- fan-in coordination after successors (this node feeds an aggregator) --
    if view.fanin is not None:
        yield from _fanin(view, wfs, output, ckp2)

    if view.is_terminal:
        yield from _run_gc(view, wfs)


# ---- planning helpers ------------------------------------------------------


def _plan_one(wfs: WorkflowState, info: sg.NextFunctionInfo, ctl: Control,
              value: Any, key: str, select: Optional[int] = None,
              faas: Optional[str] = None) -> Generator:
    """Build the JointλObject for one successor (direct vs indirect, §4.3.1)."""
    meta: Dict[str, Any] = {"source": wfs.view.name}
    if "fanin_size" in wfs.jl.meta:               # propagate dynamic fan-in size
        meta["fanin_size"] = wfs.jl.meta["fanin_size"]
    by_ds = info.transfer_by_ds
    if by_ds is None:
        by_ds = not fits_quota(value if select is None else value[select], info.quota)
    if not by_ds:
        payload = value if select is None else value[select]
        jl = JLObject.direct(ctl, payload, meta)
    else:
        # indirect: the output checkpoint *is* the transfer; copy it to the
        # majority-rule store if that differs from where we checkpointed
        if info.ds != wfs.output_ds:
            yield DsCreate(info.ds, wfs.output_key, _env(value))
        # prefetch directive armed (core.prefetch): the value is committed
        # and its key early-bound, so push it toward the consumer's cloud
        # now — the eventual DsGet pays only the residual wire time.  One
        # push per key (a Map's branches all read the same parent output).
        if info.prefetch_bytes and select in (None, 0):
            yield Prefetch(info.ds, wfs.output_key,
                           shim.cloud_of(faas or info.faas),
                           info.prefetch_bytes)
        if select is not None:
            meta["select"] = select
        jl = JLObject.indirect(ctl, info.ds, [wfs.output_key], meta)
    ev = jl.to_event()
    return [_Planned(key=key, name=info.name, faas=faas or info.faas,
                     failover=info.failover, event=ev, nbytes=jl.wire_size())]


def _plan_map(wfs: WorkflowState, info: sg.NextFunctionInfo, output: Sequence) -> Generator:
    planned: List[_Planned] = []
    n = len(output)
    vals = list(output)        # one shared snapshot for all branches (O(n), not O(n²))
    for j in range(n):
        ctl = wfs.control.push_branch(j, info.step)
        p = yield from _plan_one(wfs, info, ctl, vals, key=f"{info.name}#{j}",
                                 select=j)
        p[0].event["Meta"]["fanin_size"] = n       # dynamic fan-in sizing
        planned += p
    return planned


def _plan_redundant(wfs: WorkflowState, info: sg.NextFunctionInfo, output: Any) -> Generator:
    """ByRedundant: race the same logical invocation on several FaaS systems.

    All replicas share one Control ⇒ identical checkpoint keys ⇒ the first
    finisher wins every conditional create; stragglers' effects collapse.
    """
    planned: List[_Planned] = []
    ctl = wfs.control.advance(info.step)
    for replica in info.replicas:
        p = yield from _plan_one(wfs, info, ctl, output,
                                 key=f"{info.name}@{replica}", faas=replica)
        planned += p
    return planned


def _plan_batch(view: sg.NodeView, wfs: WorkflowState, info: sg.NextFunctionInfo,
                output: Any) -> Generator:
    """ByBatch: cross-workflow accumulation at a shared coordination point.

    The coordination list lives in the *target's* cloud table (§4.3.2) under a
    key concatenating the sub-graph's function names — deliberately not
    workflow-prefixed, so parallel workflow instances meet there.
    """
    yield _TR_COORD
    ck = collaboration_key("batch", [view.name, info.name])
    # idempotent contribution: value parked under a per-function-id key (not
    # workflow-prefixed ⇒ GC-safe), membership recorded once in the shared list
    contrib_key = f"{ck}/{wfs.function_id}"
    yield DsCreate(info.table, contrib_key, _env(output))
    acc: List[str] = (yield DsGet(info.table, ck)) or []
    if wfs.function_id not in acc:
        acc = yield DsAppendGetList(info.table, ck, [wfs.function_id])
    # batch membership is decided by this contribution's *position*, which is
    # stable across retries even if other workflows appended since
    idx = acc.index(wfs.function_id)
    if (idx + 1) % info.batch_size != 0:
        return []
    batch_no = (idx + 1) // info.batch_size
    keys = [f"{ck}/{fid}" for fid in acc[idx + 1 - info.batch_size: idx + 1]]
    ctl = Control(f"{wfs.control.workflow_id}-batch{batch_no}", step=info.step)
    jl = JLObject.indirect(ctl, info.table, keys,
                           {"source": view.name, "batch": batch_no,
                            "fanin_inputs": True})
    return [_Planned(key=f"{info.name}%batch{batch_no}", name=info.name,
                     faas=info.faas, failover=info.failover,
                     event=jl.to_event(), nbytes=jl.wire_size())]


# ---- checkpointed invocation (Fig 8) + failover (Fig 10) ---------------------


def _invoke_planned(wfs: WorkflowState, planned: List[_Planned],
                    ckp2: List[str]) -> Generator:
    pending = [p for p in planned if p.key not in ckp2]
    if not pending:
        return
    yield _TR_INVOKE
    if len(planned) > cal.FANOUT_CHUNK:
        # grouped checkpointing: 10-way parallel invoke, append names per chunk
        for i in range(0, len(pending), cal.FANOUT_CHUNK):
            chunk = pending[i:i + cal.FANOUT_CHUNK]
            results = yield Parallel([
                Invoke(p.faas, p.name, p.event, p.nbytes) for p in chunk])
            done_keys = []
            for p, r in zip(chunk, results):
                if isinstance(r, BaseException):
                    yield from _failover_invoke(p, r)
                done_keys.append(p.key)
            yield _TR_IVK_CKP
            ckp2 = yield DsAppendGetList(wfs.table, wfs.ivk_key, done_keys)
            yield _TR_INVOKE
    else:
        for p in pending:
            try:
                yield Invoke(p.faas, p.name, p.event, p.nbytes)
            except (InvocationError, shim.PayloadTooLarge) as exc:
                yield from _failover_invoke(p, exc)
            yield _TR_IVK_CKP
            ckp2 = yield DsAppendGetList(wfs.table, wfs.ivk_key, [p.key])
            yield _TR_INVOKE


def _failover_invoke(p: _Planned, primary_exc: BaseException) -> Generator:
    """Fig 10: walk the pre-deployed backups through fresh shim clients."""
    yield _TR_FAILOVER
    last: BaseException = primary_exc
    for backup in p.failover:
        if backup == p.faas:
            continue
        yield CreateClient(backup)
        try:
            yield Invoke(backup, p.name, p.event, p.nbytes)
            return backup
        except (InvocationError, shim.PayloadTooLarge) as exc:
            last = exc
    raise last


# ---- fan-in coordination (§4.3.2) ---------------------------------------------


def _fanin(view: sg.NodeView, wfs: WorkflowState, output: Any,
           ckp2: Sequence[str]) -> Generator:
    fi = view.fanin
    assert fi is not None
    yield _TR_COORD
    size = fi.size if fi.size is not None else int(wfs.jl.meta.get("fanin_size", 0))
    if size <= 0:
        raise ValueError(f"{view.name}: dynamic fan-in without fanin_size meta")
    agg_ctl = wfs.control.pop_to_depth(fi.agg_depth, fi.agg_step)
    bitmap_key = agg_ctl.function_id(fi.agg_name) + BITMAP_SUFFIX
    yield DsCreate(fi.table, bitmap_key, [False] * size)
    my_index = fi.my_index if fi.my_index >= 0 else wfs.control.branch[-1]
    bitmap = yield DsUpdateBitmap(fi.table, bitmap_key, my_index)
    if not all(bitmap):
        return
    if fi.agg_name in ckp2:
        # a retried attempt: this peer already invoked the aggregator
        return
    # This peer observed completion — it invokes the aggregator (§4.3.2).
    prefix = agg_ctl.branch
    if fi.size is None:      # dynamic: same peer fn at indices 0..size-1
        keys = [Control(wfs.control.workflow_id, wfs.control.step,
                        prefix + (i,), wfs.control.iteration).output_key(view.name)
                for i in range(size)]
    else:
        keys = [Control(wfs.control.workflow_id, peer.step,
                        prefix + peer.rel_stack, wfs.control.iteration).output_key(peer.name)
                for peer in fi.peers]
    jl = JLObject.indirect(agg_ctl, fi.ds, keys,
                           {"source": view.name, "fanin_inputs": True})
    p = _Planned(key=fi.agg_name, name=fi.agg_name, faas=fi.agg_faas,
                 failover=fi.agg_failover, event=jl.to_event(), nbytes=jl.wire_size())
    yield _TR_INVOKE
    try:
        yield Invoke(p.faas, p.name, p.event, p.nbytes)
    except (InvocationError, shim.PayloadTooLarge) as exc:
        yield from _failover_invoke(p, exc)
    yield _TR_IVK_CKP
    yield DsAppendGetList(wfs.table, wfs.ivk_key, [p.key])


# ---- GC (§4.4) -------------------------------------------------------------------


def _run_gc(view: sg.NodeView, wfs: WorkflowState) -> Generator:
    if not view.gc_enabled or not view.gc:
        return
    yield _TR_GC
    prefix = wfs.control.workflow_id + "/"
    payload = [{"prefix": prefix, "stores": list(t.stores)} for t in view.gc]
    results = yield Parallel([
        Invoke(t.faas, sg.GC_FUNCTION, ev, 600)
        for t, ev in zip(view.gc, payload)])
    for r in results:
        if isinstance(r, BaseException):
            # GC is best-effort: a down cloud sweeps on its next workflow
            continue


def gc_handler(event: dict) -> Generator:
    """The GC function deployed once per cloud: prefix-sweep its stores.

    Journal-aware: a function id with a started-but-unfinished journal
    (``…#j/start`` without ``…#j/done``) is live or suspended — sleeping,
    waiting on a signal, or awaiting crash-recovery replay — so *all* its
    keys (journal entries, ``-output``/``-ivk`` checkpoints) must survive
    the sweep, as must the workflow's signal latches while anything is
    still open.  GC is best-effort, so the skipped keys are reclaimed by a
    later sweep once the journals close."""
    start_suffix = JOURNAL_SEP + JOURNAL_START
    for ds in event["stores"]:
        keys = yield DsListPrefix(ds, event["prefix"])
        if not keys:
            continue
        keyset = set(keys)
        open_fids = [
            k[: -len(start_suffix)] for k in keys
            if k.endswith(start_suffix)
            and k[: -len(start_suffix)] + JOURNAL_SEP + JOURNAL_DONE not in keyset
        ]
        if open_fids:
            signal_prefix = event["prefix"] + SIGNAL_NS + "/"
            keys = [k for k in keys
                    if not k.startswith(signal_prefix)
                    and not any(k.startswith(fid) for fid in open_fids)]
        if keys:
            yield DsDelete(ds, keys)
    return len(event["stores"])
