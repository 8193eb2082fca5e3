"""Strongly-consistent datastore state machines (DynamoDB / TableStore class).

This module is the *pure* state layer: a linearizable key-value table with the
conditional-create / append / bitmap primitives of Table 2.  Interpreters wrap
it with latency and billing.  Linearizability falls out of the single-threaded
event loop: every operation executes atomically at one point in virtual time.

The paper's correctness argument (§4.1) leans on exactly two properties, both
enforced here:
  1. ``create_if_absent`` is atomic — duplicate executions cannot both create
     an output checkpoint;
  2. ``append_and_get_list`` is atomic read-modify-write — concurrent fan-out
     groups see each other's committed invocations.
"""

from __future__ import annotations

import copy
import io
import os
import pickle
import threading
from bisect import bisect_left, insort
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

try:                        # POSIX-only; the remote substrate requires it
    import fcntl
except ImportError:         # pragma: no cover - non-POSIX fallback
    fcntl = None

# Isolation copies (puts/gets copy the value so callers can't alias store
# state).  ``copy.deepcopy`` is the semantic model but far too slow for the
# simulator's hot path; this copier returns immutable values (including
# frozen dataclasses such as SimCloud's Blob) by reference and only
# recursively copies mutable containers.  Anything exotic falls back to
# deepcopy.
_IMMUTABLE = (str, int, float, bool, bytes, type(None), frozenset)


def _copy_value(v: Any) -> Any:
    cls = v.__class__
    if cls in _IMMUTABLE:
        return v
    if cls is list:
        return [_copy_value(x) for x in v]
    if cls is dict:
        return {k: _copy_value(x) for k, x in v.items()}
    if cls is tuple:
        return tuple(_copy_value(x) for x in v)
    params = getattr(cls, "__dataclass_params__", None)
    if params is not None and params.frozen:
        return v
    return copy.deepcopy(v)


@dataclass
class TableState:
    """One table/object-store namespace inside one cloud.

    A sorted key index rides along with ``items`` so ``list_prefix`` (the GC
    sweep) is a bisect + contiguous slice instead of an all-keys scan —
    mutate keys only through the primitives below, never via ``items``
    directly, or the index desyncs.
    """

    name: str
    items: Dict[str, Any] = field(default_factory=dict)
    # op counters for billing / Fig-20 style breakdowns
    writes: int = 0
    reads: int = 0

    def __post_init__(self):
        self._sorted_keys: List[str] = sorted(self.items)

    # -- Table 2 primitives -------------------------------------------------

    def create_if_absent(self, key: str, value: Any) -> bool:
        """Atomic conditional create. True iff the key was absent."""
        self.writes += 1
        if key in self.items:
            return False
        self.items[key] = _copy_value(value)
        insort(self._sorted_keys, key)
        return True

    def put(self, key: str, value: Any) -> None:
        """Unconditional last-writer-wins set.

        NOT part of the Table-2 workflow surface (workflow state must go
        through the conditional primitives above for §4.1 exactly-once);
        this exists for backend-internal namespaces — broker leases,
        execution records, counters — that live in the same linearizable
        store but are mutable by design.
        """
        self.writes += 1
        if key not in self.items:
            insort(self._sorted_keys, key)
        self.items[key] = _copy_value(value)

    def get(self, key: str) -> Any:
        """Strongly-consistent read (returns an isolated copy; None if absent)."""
        self.reads += 1
        val = self.items.get(key)
        return _copy_value(val)

    def append_and_get_list(self, key: str, items: Sequence[Any]) -> List[Any]:
        """Atomically append ``items`` to the list at ``key`` and return it.

        Creates the list if absent (matches the create-then-append idiom in
        Fig 8 being safe even if the create was lost to a crash).
        """
        self.writes += 1
        if key in self.items:
            cur = self.items[key]
        else:                       # absent (a stored None is NOT absent)
            self.items[key] = cur = []
            insort(self._sorted_keys, key)
        if not isinstance(cur, list):
            raise TypeError(f"{self.name}[{key}] is not a list")
        cur.extend([_copy_value(x) for x in items])
        return _copy_value(cur)

    def update_bitmap(self, index: int, key: str) -> List[bool]:
        """Atomically set bit ``index`` and return the bitmap (strong read)."""
        self.writes += 1
        bm = self.items.get(key)
        if bm is None:
            raise KeyError(f"bitmap {key} not created")
        bm[index] = True
        return list(bm)

    # -- GC support (§4.4) ----------------------------------------------------

    def list_prefix(self, prefix: str) -> List[str]:
        self.reads += 1
        sk = self._sorted_keys
        i = bisect_left(sk, prefix)
        out: List[str] = []
        while i < len(sk) and sk[i].startswith(prefix):
            out.append(sk[i])
            i += 1
        return out

    def delete(self, keys: Sequence[str]) -> int:
        n = 0
        sk = self._sorted_keys
        for k in keys:
            if k in self.items:
                del self.items[k]
                i = bisect_left(sk, k)
                if i < len(sk) and sk[i] == k:
                    sk.pop(i)
                n += 1
        self.writes += len(list(keys))
        return n

    # -- introspection ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.items)


# ==========================================================================
# Durable-execution journal: key scheme + recovery scanner (substrate-blind)
# ==========================================================================
#
# The effect journal reuses this module's linearizable-table machinery: each
# journaled attempt owns the ``{function_id}#j/`` key range in its node's
# home table.  ``#`` cannot appear in function ids (naming.py builds them
# from ``{wfid}/{name}_{step}`` plus ``-itN``/``-bindex-N``), so the range is
# collision-free, and because function ids start with ``{wfid}/`` the GC's
# workflow-prefix sweep naturally *sees* journal keys — ``gc_handler`` must
# therefore check ``journal_is_open`` before deleting (see orchestrator.py).
#
#   {fid}#j/start      — {"faas":…, "function":…, "event":…}; created before
#                        the first live effect, consumed by resume()
#   {fid}#j/e{seq:06d} — envelope of effect #seq's committed result:
#                        {"r": value} | {"e": [etype, msg]} | {"deadline": t}
#   {fid}#j/done       — terminal marker; attempts with start-but-no-done
#                        are the incomplete set a fresh backend re-delivers
#
# First-commit-wins: entries are written with ``create_if_absent``; a racing
# duplicate attempt that loses the create adopts the stored result, which is
# what keeps replay deterministic across concurrent retries.

JOURNAL_SEP = "#j/"
JOURNAL_START = "start"
JOURNAL_DONE = "done"
SIGNAL_NS = "__signal__"


def journal_entry_key(function_id: str, seq: int) -> str:
    return f"{function_id}{JOURNAL_SEP}e{seq:06d}"


def journal_start_key(function_id: str) -> str:
    return f"{function_id}{JOURNAL_SEP}{JOURNAL_START}"


def journal_done_key(function_id: str) -> str:
    return f"{function_id}{JOURNAL_SEP}{JOURNAL_DONE}"


def signal_key(workflow_id: str, name: str) -> str:
    """Durable per-workflow signal latch key (first delivery wins)."""
    return f"{workflow_id}/{SIGNAL_NS}/{name}"


def journal_is_open(state: TableState, function_id: str) -> bool:
    """True iff ``function_id`` has a started-but-not-finished journal in
    ``state`` — i.e. the attempt is live or suspended and its keys must
    survive GC."""
    return (journal_start_key(function_id) in state.items
            and journal_done_key(function_id) not in state.items)


def incomplete_starts(state: TableState) -> List[Tuple[str, Any]]:
    """All ``(function_id, start_record)`` pairs in ``state`` whose journal
    is open.  This is the recovery scan ``resume()`` runs over a journal-
    capable backend's tables — a cold-path full-key walk, not something the
    event loop ever does."""
    suffix = JOURNAL_SEP + JOURNAL_START
    out: List[Tuple[str, Any]] = []
    for key in state._sorted_keys:
        if key.endswith(suffix):
            fid = key[: -len(suffix)]
            if journal_done_key(fid) not in state.items:
                out.append((fid, state.get(key)))
    return out


# ==========================================================================
# Cross-process file lock (flock-based)
# ==========================================================================


class FileLock:
    """A re-entrant cross-process mutex over ``fcntl.flock``.

    Design points that matter for the remote substrate:

    * the lock file is opened **per acquisition** (never cached), so a
      forked child does not share a parent's open file description — each
      process's lock is independent;
    * ``flock`` locks die with the process, so a ``kill -9`` mid-critical-
      section can never wedge the store (this is what makes lease expiry,
      not lock recovery, the failure-handling story);
    * a ``threading.RLock`` fronts the flock so threads inside one process
      (LocalRunner-style ``Parallel`` workers, submit timers) serialize
      correctly too — flock alone is per-process, not per-thread.
    """

    def __init__(self, path: str):
        if fcntl is None:  # pragma: no cover - non-POSIX
            raise RuntimeError("FileLock requires fcntl (POSIX)")
        self.path = path
        self._tlock = threading.RLock()
        self._depth = 0
        self._fh: Optional[io.FileIO] = None

    def acquire(self) -> None:
        self._tlock.acquire()
        self._depth += 1
        if self._depth == 1:
            fh = open(self.path, "ab")
            try:
                fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
            except BaseException:
                fh.close()
                self._tlock.release()
                self._depth -= 1
                raise
            self._fh = fh

    def release(self) -> None:
        if self._depth == 1 and self._fh is not None:
            try:
                fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            finally:
                self._fh.close()
                self._fh = None
        self._depth -= 1
        self._tlock.release()

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def reset_after_fork(self) -> None:
        """Discard inherited thread-lock state in a freshly forked child.

        If the parent forked while another of its threads held the lock,
        the child's copy would be locked forever (the owning thread does
        not exist in the child).  Children call this before first use."""
        self._tlock = threading.RLock()
        self._depth = 0
        self._fh = None


def lock_path(store_dir: str, table_name: str) -> str:
    """Canonical lock file guarding a table's WAL (``<wal>.lock``)."""
    return wal_path(store_dir, table_name) + ".lock"


# ==========================================================================
# Write-ahead-logged table: TableState that survives process death
# ==========================================================================


def _apply_logged_op(state: TableState, op: Tuple) -> None:
    """Apply one WAL record to ``state`` via the un-logged base primitives."""
    tag = op[0]
    if tag == "c":
        TableState.create_if_absent(state, op[1], op[2])
    elif tag == "a":
        TableState.append_and_get_list(state, op[1], op[2])
    elif tag == "b":
        TableState.update_bitmap(state, op[2], op[1])
    elif tag == "d":
        TableState.delete(state, op[1])
    elif tag == "p":
        TableState.put(state, op[1], op[2])


class PersistentTableState(TableState):
    """A :class:`TableState` whose every mutation is appended to a pickle
    write-ahead log before it is applied, and which rebuilds itself by
    replaying that log on open.

    ``flush()`` after each record moves the bytes into the kernel page
    cache, so state survives ``kill -9`` of the owning process (the
    durability the ``--durability-smoke`` gate exercises); surviving a
    machine crash would need fsync, which this deliberately skips for
    speed.  A torn tail record (the process died mid-append) is tolerated:
    replay stops at the last complete record and the file is truncated
    back to it.

    Replay and append both run under a cross-process :class:`FileLock`
    (``<path>.lock``) so two processes sharing one WAL cannot interleave
    half-written records or truncate a tail another writer is extending.
    The flock makes the *file* safe under concurrent writers, but each
    ``PersistentTableState`` still only sees its own mutations — its
    in-memory view is single-logical-writer.  For a genuinely shared
    multi-writer view use :class:`SharedTableState`.
    """

    def __init__(self, name: str, path: str):
        super().__init__(name)
        self.path = path
        self._log: Optional[io.BufferedWriter] = None
        self._flock = FileLock(path + ".lock")
        with self._flock:
            self._replay()
        self._log = open(path, "ab")

    def _replay(self) -> None:
        """Rebuild state from the WAL. Caller must hold ``self._flock``."""
        if not os.path.exists(self.path):
            return
        good = 0
        with open(self.path, "rb") as f:
            while True:
                try:
                    op = pickle.load(f)
                except EOFError:
                    break
                except Exception:      # torn tail: stop at last whole record
                    break
                self._apply_op(op)
                good = f.tell()
        size = os.path.getsize(self.path)
        if good != size:
            with open(self.path, "ab") as f:
                f.truncate(good)

    def _apply_op(self, op: Tuple) -> None:
        _apply_logged_op(self, op)

    def _append(self, op: Tuple) -> None:
        if self._log is not None:
            with self._flock:
                pickle.dump(op, self._log)
                self._log.flush()

    # -- logged mutations ----------------------------------------------------

    def create_if_absent(self, key: str, value: Any) -> bool:
        created = super().create_if_absent(key, value)
        if created:
            self._append(("c", key, value))
        return created

    def append_and_get_list(self, key: str, items: Sequence[Any]) -> List[Any]:
        out = super().append_and_get_list(key, items)
        self._append(("a", key, list(items)))
        return out

    def update_bitmap(self, index: int, key: str) -> List[bool]:
        out = super().update_bitmap(index, key)
        self._append(("b", key, index))
        return out

    def delete(self, keys: Sequence[str]) -> int:
        n = super().delete(keys)
        self._append(("d", list(keys)))
        return n

    def put(self, key: str, value: Any) -> None:
        super().put(key, value)
        self._append(("p", key, value))

    def close(self) -> None:
        if self._log is not None:
            self._log.flush()
            self._log.close()
            self._log = None


def wal_path(store_dir: str, table_name: str) -> str:
    """Canonical WAL file for a table id (``aws/dynamodb`` → ``aws__dynamodb.wal``)."""
    return os.path.join(store_dir, table_name.replace("/", "__") + ".wal")


# ==========================================================================
# Shared multi-writer table: the remote substrate's linearizable store
# ==========================================================================


class SharedTableState(TableState):
    """A WAL-backed :class:`TableState` safe for **concurrent writers in
    multiple processes**.

    The WAL file is the single source of truth; each process keeps a local
    materialized view plus ``_pos``, the byte offset up to which it has
    applied the log.  Every operation runs as::

        with flock(<path>.lock):          # cross-process + cross-thread
            catch up: pickle.load new records from _pos, apply, advance
            (truncate a torn tail back to the last whole record)
            perform the op on the in-memory view
            append its WAL record, flush; _pos = tell()

    Because catch-up and append happen under one exclusive lock session,
    every operation observes *all* previously committed operations from
    every process — the table is linearizable: the WAL order is the single
    total order, and each op is atomic at its append point.  ``flock``
    locks evaporate on process death, so a worker killed mid-section
    leaves at most a torn tail, which the next writer truncates.

    ``locked()`` is public: backends compose several primitives into one
    atomic step (the broker's claim-scan-lease sequence) by holding the
    session open across them.
    """

    def __init__(self, name: str, path: str):
        super().__init__(name)
        self.path = path
        self._pos = 0
        self._lock = FileLock(path + ".lock")
        with self.locked():
            pass                        # initial catch-up

    # -- lock session --------------------------------------------------------

    @contextmanager
    def locked(self):
        """Exclusive cross-process session; syncs to WAL tip on entry.

        Re-entrant: nested ``locked()`` (or primitive calls inside one)
        reuse the held session and skip the redundant re-sync."""
        self._lock.acquire()
        try:
            if self._lock._depth == 1:
                self._sync_locked()
            yield self
        finally:
            self._lock.release()

    def sync(self) -> None:
        """Catch the local view up to the WAL tip (read-your-writes for
        other processes' commits)."""
        with self.locked():
            pass

    def reset_after_fork(self) -> None:
        """Make a forked child's copy safe to use: drop inherited lock
        state and rebuild the view from the WAL from scratch (the parent
        may have forked mid-mutation in another thread)."""
        self._lock.reset_after_fork()
        self.items = {}
        self._sorted_keys = []
        self._pos = 0

    def _sync_locked(self) -> None:
        if not os.path.exists(self.path):
            return
        size = os.path.getsize(self.path)
        if size == self._pos:
            return
        if size < self._pos:            # WAL replaced/truncated under us
            self.items = {}
            self._sorted_keys = []
            self._pos = 0
        good = self._pos
        with open(self.path, "rb") as f:
            f.seek(self._pos)
            while True:
                try:
                    op = pickle.load(f)
                except EOFError:
                    break
                except Exception:      # torn tail from a killed writer
                    break
                _apply_logged_op(self, op)
                good = f.tell()
        if good != size:
            with open(self.path, "ab") as f:
                f.truncate(good)
        self._pos = good

    def _append(self, op: Tuple) -> None:
        with open(self.path, "ab") as f:
            pickle.dump(op, f)
            f.flush()
            self._pos = f.tell()

    # -- primitives: each is one atomic WAL-ordered step ---------------------

    def create_if_absent(self, key: str, value: Any) -> bool:
        with self.locked():
            created = super().create_if_absent(key, value)
            if created:
                self._append(("c", key, value))
            return created

    def get(self, key: str) -> Any:
        with self.locked():
            return super().get(key)

    def append_and_get_list(self, key: str, items: Sequence[Any]) -> List[Any]:
        with self.locked():
            out = super().append_and_get_list(key, items)
            self._append(("a", key, list(items)))
            return out

    def update_bitmap(self, index: int, key: str) -> List[bool]:
        with self.locked():
            out = super().update_bitmap(index, key)
            self._append(("b", key, index))
            return out

    def list_prefix(self, prefix: str) -> List[str]:
        with self.locked():
            return super().list_prefix(prefix)

    def delete(self, keys: Sequence[str]) -> int:
        with self.locked():
            n = super().delete(keys)
            self._append(("d", list(keys)))
            return n

    def put(self, key: str, value: Any) -> None:
        with self.locked():
            super().put(key, value)
            self._append(("p", key, value))

    # -- bulk reads (record-query surface) ------------------------------------

    def items_prefix(self, prefix: str) -> List[Tuple[str, Any]]:
        """All ``(key, value)`` pairs under ``prefix`` in one lock session."""
        with self.locked():
            return [(k, _copy_value(self.items[k]))
                    for k in TableState.list_prefix(self, prefix)]

    def close(self) -> None:
        pass                            # nothing cached between sessions


class InMemoryDS:
    """A concrete :class:`repro_torch.backends.shim.DSBackend` over ``TableState``.

    Used directly by the local (real-execution) backend and by unit tests;
    SimCloud talks to ``TableState`` through its event loop instead.
    """

    def __init__(self, state: TableState | None = None):
        self.state = state or TableState("local")

    # Table 2 surface
    def store_output_data(self, key: str, data: Any) -> bool:
        return self.state.create_if_absent(key, data)

    def get_value(self, key: str) -> Any:
        return self.state.get(key)

    def create_invocation_list(self, key: str) -> bool:
        return self.state.create_if_absent(key, [])

    def append_and_get_list(self, key: str, items: Sequence[Any]) -> list:
        return self.state.append_and_get_list(key, items)

    def create_bitmap(self, size: int, key: str) -> bool:
        return self.state.create_if_absent(key, [False] * size)

    def update_bitmap(self, index: int, key: str) -> list:
        return self.state.update_bitmap(index, key)

    def list_prefix(self, prefix: str) -> list:
        return self.state.list_prefix(prefix)

    def delete(self, keys: Sequence[str]) -> int:
        return self.state.delete(keys)
