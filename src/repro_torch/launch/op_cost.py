"""Op-level cost of one call traced on fake tensors.

The counterpart of :mod:`repro.launch.hlo_cost`.  The reference walks
optimized HLO text with trip counts, because XLA's ``cost_analysis()``
counts a ``while`` body once.  Here the layer loop is Python and every op
reaches the dispatcher, so one ``TorchDispatchMode`` (:class:`OpCounter`),
run inside ``FlopCounterMode``, tallies a step as it runs on fake tensors
(``FakeTensorMode``: no card, no memory):

* ``flops`` — ``FlopCounterMode``'s count, the kernels' own formulas
  (:mod:`repro_torch.kernels.library`) included;
* ``bytes_read`` / ``bytes_written`` — each op's tensor inputs and outputs,
  views free: in eager PyTorch nothing fuses, so this is the step's HBM
  traffic, not a bound;
* ``ops`` — ops dispatched, views, allocations that launch nothing and
  queries (``prim.device``: no tensor out) left out: it stands in for
  launches;
* ``peak_bytes`` — the most bytes the call held at once beyond its
  arguments: each new storage rounded up to 512 bytes, as the caching
  allocator does, and freed when it dies (``weakref.finalize`` on the
  storage).  What an operator's implementation allocates inside itself
  (the kernels' scratch) reaches no dispatch mode; a fake implementation
  reports it through :data:`repro_torch.kernels.library.allocation_hooks`;
* the collectives of a rank traced on a fake process group
  (:func:`repro_torch.launch.mesh.traced_mesh`), from
  :data:`repro_torch.parallel.mesh_ctx.collective_tallies`: each logical
  collective's calls and operand bytes by kind, and its wire bytes by the
  ring model (:func:`repro_torch.launch.hlo_analysis.wire_bytes`); and the
  gloo all-reduces that emulate them (``gloo_calls``, ``gloo_bytes``, as
  ``mesh_ctx.collective_stats`` counts them on the ranks).

The reference's ``Cost.as_dict()`` fields, mapped onto :meth:`Cost.as_dict`:
``flops`` → ``flops``; ``transcendentals`` → none (``FlopCounterMode``
counts products only); ``bytes_accessed`` → ``bytes_accessed`` (read +
written); ``bytes_fused`` → ``bytes_accessed`` (nothing fuses);
``wire_bytes``, ``collective_ops``, ``collective_bytes`` → the same names
(0 and empty on one card).
"""

from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import library
from repro_torch.launch.hlo_analysis import wire_bytes
from repro_torch.parallel import mesh_ctx

#: the caching allocator's rounding of a block
BLOCK = 512

_aten = torch.ops.aten
#: ops that allocate or relabel and launch nothing
_NO_LAUNCH = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
              _aten.new_empty.default, _aten.new_empty_strided.default,
              _aten._unsafe_view.default, _aten.lift_fresh.default}


def rounded(nbytes: int) -> int:
    """Bytes the caching allocator hands out for ``nbytes`` (0 for none)."""
    return -(-nbytes // BLOCK) * BLOCK


def tensors(tree: Any) -> list:
    """The tensors of ``tree``, a DTensor as its local block."""
    out = [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]
    if not any(isinstance(t, DTensor) for t in out):
        return out
    with torch.no_grad():
        return [t.to_local() if isinstance(t, DTensor) else t for t in out]


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storages(tree: Any) -> Dict[int, int]:
    """The distinct storages of the tensors of ``tree`` (a DTensor's local
    block): key → bytes, unrounded, as the reference's
    ``memory_analysis()`` counts its arguments and outputs."""
    return {storage_key(t): t.untyped_storage().nbytes() for t in tensors(tree)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class Cost:
    """What :func:`count` tallied over one call."""

    flops: float = 0.0
    bytes_read: int = 0
    bytes_written: int = 0
    ops: int = 0
    peak_bytes: int = 0                      # beyond the arguments
    by_op: Dict[str, dict] = field(default_factory=dict)
    #: (kind, group size) → [calls, operand bytes a rank]
    collectives: Dict[Tuple[str, int], list] = field(default_factory=dict)
    gloo_calls: int = 0
    gloo_bytes: int = 0

    @property
    def bytes_accessed(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def wire_bytes(self) -> float:
        return sum(wire_bytes(kind, nbytes, n) for (kind, n), (_, nbytes)
                   in self.collectives.items())

    def _by_kind(self, i: int) -> Dict[str, int]:
        out: Counter = Counter()
        for (kind, _), c in self.collectives.items():
            out[kind] += c[i]
        return dict(out)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "bytes_read": self.bytes_read, "bytes_written": self.bytes_written,
                "ops": self.ops, "peak_bytes": self.peak_bytes,
                "wire_bytes": self.wire_bytes, "collective_ops": self._by_kind(0),
                "collective_bytes": self._by_kind(1), "gloo_calls": self.gloo_calls,
                "gloo_bytes": self.gloo_bytes}


class OpCounter(TorchDispatchMode):
    """Counts ops and bytes and tracks live storages; ``arguments`` are the
    storages the call starts with (they are never counted as new)."""

    def __init__(self, arguments: Iterable[int] = ()):
        super().__init__()
        self.arguments = set(arguments)
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.calls: Counter = Counter()
        self.op_bytes: Counter = Counter()
        self._live: Dict[int, int] = {}
        self._zeros = None          # the storage of the last ``new_zeros``

    def track(self, ts: Iterable[torch.Tensor], known: Iterable[int] = ()) -> None:
        """Count each storage of ``ts`` that is new (not an argument, not in
        ``known``, not already live) as allocated."""
        known = set(known)
        for t in ts:
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._live or key in self.arguments:
                continue
            n = rounded(st.nbytes())
            if not n:
                continue
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _in_place(self, src: torch.Tensor, out: torch.Tensor) -> None:
        """Count ``out`` as the storage of ``src`` (which dies with the op
        that wrote it): an in-place write where eager code makes one."""
        n = self._live.pop(storage_key(src), 0)
        if n:
            key = storage_key(out)
            self._live[key] = n
            weakref.finalize(out.untyped_storage(), self._free, key)

    def __enter__(self):
        library.allocation_hooks.append(self.track)
        return super().__enter__()

    def __exit__(self, *exc):
        library.allocation_hooks.remove(self.track)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = tensors((args, kwargs)), tensors(out)
        if func is _aten.scatter_add.default and storage_key(args[0]) == self._zeros:
            # gather's backward: eager runs new_zeros(...).scatter_add_(...) in
            # place; on a tensor subclass (a fake tensor) it takes the
            # out-of-place scatter_add, whose input dies at once
            self._in_place(args[0], out)
        self._zeros = storage_key(out) if func is _aten.new_zeros.default else None
        self.track(outs, known={storage_key(t) for t in ins})
        if func.is_view or func in _NO_LAUNCH or not outs:    # no tensor out: a query
            return out
        name = str(func.overloadpacket)
        moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.ops += 1
        self.bytes_read += sum(_nbytes(t) for t in ins)
        self.bytes_written += sum(_nbytes(t) for t in outs)
        self.calls[name] += 1
        self.op_bytes[name] += moved
        return out


def count(fn: Callable, *args) -> Tuple[Any, Cost]:
    """Run ``fn(*args)`` (under an active ``FakeTensorMode``, so nothing runs
    on a device) and tally it; returns (its output, the :class:`Cost`).
    Collectives are never timed while it runs: timing synchronises the
    card."""
    flop_counter = FlopCounterMode(display=False)
    counter = OpCounter(storages(args))
    stats = mesh_ctx.collective_stats
    timed, calls, nbytes = stats["timed"], stats["calls"], stats["bytes"]
    tally: Dict[Tuple[str, int], list] = {}
    stats["timed"] = False
    mesh_ctx.collective_tallies.append(tally)
    try:
        with flop_counter, counter:
            out = fn(*args)
    finally:
        mesh_ctx.collective_tallies.remove(tally)
        stats["timed"] = timed
    flops_by_op = {str(op): n for op, n in flop_counter.get_flop_counts()["Global"].items()}
    by_op = {name: {"calls": counter.calls[name], "bytes": counter.op_bytes[name],
                    "flops": flops_by_op.get(name, 0)} for name in counter.calls}
    return out, Cost(flops=float(flop_counter.get_total_flops()),
                     bytes_read=counter.bytes_read, bytes_written=counter.bytes_written,
                     ops=counter.ops, peak_bytes=counter.peak, by_op=by_op,
                     collectives=tally, gloo_calls=stats["calls"] - calls,
                     gloo_bytes=stats["bytes"] - nbytes)
