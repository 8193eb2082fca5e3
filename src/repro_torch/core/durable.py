"""Durable execution: the event-sourced effect journal + replay recovery.

This layer turns the effect interpreter contract into an event-sourced,
replayable runtime *without touching any backend's interpreter loop*: the
:func:`journaled_handle` wrapper generator sits between a backend and the
ordinary :func:`repro_torch.core.orchestrator.handle` generator and journals every
effect the handler yields through plain ``DsGet``/``DsCreate`` effects —
so journal writes flow down the same shim path as workflow data and inherit
each substrate's latency, billing, and persistence for free.

Protocol (per function attempt, keys in the node's home table):

1. ``{fid}#j/start`` is conditionally created with the delivery envelope
   (``faas``/``function``/``event``) — this is what :func:`resume`
   re-submits on a fresh backend.
2. Every effect gets a deterministic per-attempt sequence id.  Before the
   inner generator is resumed with a result, that result is committed to
   ``{fid}#j/e{seq:06d}`` (``create_if_absent`` ⇒ first-commit-wins under
   racing duplicate attempts; the loser adopts the stored result).
3. A re-delivered attempt starts in *replay* mode: journal entries are read
   back and fed to the generator while the live effects are suppressed.
   The first missing entry ends replay — execution continues live from the
   exact suspension point.  Because the handler is deterministic given its
   effect results (all nondeterminism — ``RunUser``, ``Now``, datastore
   reads — is journaled), replay reconstructs the identical generator
   state on any backend instance over the same stores.
4. ``{fid}#j/done`` marks terminal completion; :func:`resume` re-delivers
   exactly the attempts with a start marker and no done marker.

``Sleep`` journals its *absolute deadline* instead of a result, so a replay
after a crash (or a wake on a fresh backend) sleeps only the remaining
time — a suspension is just a crash the workflow planned for.
``WaitForSignal`` is performed live each time until it resolves (the
backend's durable signal latch makes re-waits after a crash observe an
already-delivered signal); its resolved value is then journaled like any
other result.

Exactly-once across the crash boundary follows from the same §4.1 algebra
as within one backend: replayed effects are *not* re-executed (at-most-once
for everything the journal committed), and the one possibly-duplicated
window — a crash between a live effect and its journal commit — re-runs an
effect whose externally-visible writes are conditional creates, which
collapse.  ``tests/test_durable.py`` and the hypothesis schedules in
``tests/test_exactly_once_prop.py`` hold this under adversarial crashes.
"""

from __future__ import annotations

from typing import Any, Generator, List

from repro_torch.backends import shim
from repro_torch.backends.datastore import (incomplete_starts, journal_done_key,
                                      journal_entry_key, journal_start_key)
from repro_torch.backends.shim import (DsCreate, DsDelete, DsGet, Now, Sleep, Trace,
                                 WaitForSignal)

# ShimError reconstruction registry: journal entries persist raised shim
# errors as ["TypeName", "message"] so replay re-throws the same class.
_ERROR_TYPES = {
    cls.__name__: cls
    for cls in (shim.ShimError, shim.InvocationError, shim.DataStoreError,
                shim.PayloadTooLarge, shim.CapabilityError)
}


def _encode_result(value: Any) -> dict:
    if isinstance(value, BaseException):
        return {"e": [type(value).__name__, str(value)]}
    if isinstance(value, (list, tuple)) and any(
            isinstance(v, BaseException) for v in value):
        # Parallel results: exceptions are returned positionally, not raised
        return {"p": [_encode_result(v) for v in value]}
    return {"r": value}


def _decode_result(rec: dict) -> Any:
    if "e" in rec:
        etype, msg = rec["e"]
        return _ERROR_TYPES.get(etype, shim.ShimError)(msg)
    if "p" in rec:
        return [_decode_result(r) for r in rec["p"]]
    return rec["r"]


def journaled_handle(view, event: Any) -> Generator:
    """Wrap :func:`orchestrator.handle` in the effect journal (see module
    docstring for the protocol).  Yields the same effect language, so every
    backend interprets journaled workflows unchanged."""
    from repro_torch.core.orchestrator import _parse_event, handle

    jl = _parse_event(view, event)
    fid = jl.control.function_id(view.name)
    table = view.home_table

    yield DsCreate(table, journal_start_key(fid),
                   {"faas": view.faas, "function": view.name, "event": event})

    gen = handle(view, event)
    seq = 0
    replaying = True            # probe journal entries until the first miss
    last_seq = 0                # seq of the last journaled delivery (0 = none)
    to_send: Any = None
    to_throw: BaseException | None = None
    while True:
        try:
            if to_throw is not None:
                exc, to_throw = to_throw, None
                eff = gen.throw(exc)
            else:
                eff = gen.send(to_send)
        except StopIteration as stop:
            yield DsCreate(table, journal_done_key(fid),
                           _encode_result(stop.value))
            return stop.value
        except shim.ShimError:
            # The handler did not absorb this error: the attempt is about
            # to crash and at-least-once will re-deliver it.  Retract the
            # journal entry that delivered the error — the failure is
            # transient (an outage the retry may outlive); pinning it in
            # the journal would poison every future replay with it.
            if last_seq:
                yield DsDelete(table, [journal_entry_key(fid, last_seq)])
            raise

        if type(eff) is Trace:              # pure bookkeeping: never journaled
            to_send = yield eff
            continue

        seq += 1
        jkey = journal_entry_key(fid, seq)
        rec = (yield DsGet(table, jkey)) if replaying else None
        if rec is None:
            replaying = False

        if type(eff) is Sleep:
            # journal the absolute deadline; live or replayed, sleep only
            # what remains of it (a crash mid-sleep resumes the countdown)
            now = yield Now()
            if rec is None:
                rec = {"deadline": now + eff.ms}
                if not (yield DsCreate(table, jkey, rec)):
                    rec = yield DsGet(table, jkey)
            remaining = rec["deadline"] - now
            if remaining > 0:
                yield Sleep(remaining)
            to_send = None
            last_seq = 0        # a deadline entry is never worth retracting
            continue

        if rec is not None:                 # replay: suppress the live effect
            value = _decode_result(rec)
            last_seq = seq
            if isinstance(value, BaseException):
                to_throw = value
            else:
                to_send = value
            continue

        if type(eff) is WaitForSignal and not eff.scope:
            eff = WaitForSignal(eff.name, jl.control.workflow_id)

        try:
            result = yield eff
        except shim.ShimError as live_exc:
            rec = _encode_result(live_exc)
        else:
            rec = _encode_result(result)
        if not (yield DsCreate(table, jkey, rec)):
            rec = yield DsGet(table, jkey)       # racing duplicate won; adopt
        value = _decode_result(rec)
        last_seq = seq
        if isinstance(value, BaseException):
            to_throw = value
        else:
            to_send = value


def resume(backend) -> List[str]:
    """Rehydrate every started-but-unfinished journaled attempt on
    ``backend`` by re-submitting its stored delivery envelope; replay takes
    it from there.  Returns the re-delivered function ids.  Requires the
    ``journal`` capability (a fresh backend constructed over the same
    stores — via persistent WALs or ``adopt_stores`` — qualifies)."""
    tables = getattr(backend, "journal", None)
    if not tables:
        raise shim.CapabilityError(
            "backend has no 'journal' capability: its datastores do not "
            "persist the effect journal, so there is nothing to replay "
            "from (see docs/backends.md, 'Durable execution')")
    seen = set()
    fids: List[str] = []
    for state in tables():
        for fid, start in incomplete_starts(state):
            if fid in seen:
                continue
            seen.add(fid)
            backend.submit(start["faas"], start["function"], start["event"])
            fids.append(fid)
    return fids
