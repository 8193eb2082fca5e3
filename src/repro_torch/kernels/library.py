"""The port's kernels as ``torch.library`` operators, and their launch counts.

Each hand-written kernel is an operator ``repro_torch::<name>`` with three
parts, registered by :func:`register` from the kernel's module:

* the CUDA implementation: the ``ctypes`` launch on the calling thread's
  current stream, which adds one to the kernel's count in :data:`launches`
  (and to its variant's in :data:`variant_launches`) and is the only place
  that counts;
* the fake implementation: it allocates what the launch allocates, outputs
  and scratch, from the same buffer function, and launches and counts
  nothing, so a step traces on fake tensors (``FakeTensorMode``) or on the
  ``meta`` device;
* a FLOP formula registered with :mod:`torch.utils.flop_counter`, the same
  function the kernel table's bounds use.

The operators are defined with ``torch.library.Library`` and ``impl``, not
``torch.library.custom_op``, whose Python autograd layer costs every call
more.  Every call on the card goes through the operator.  No operator has
an autograd formula: the scans' gradients come from the
``autograd.Function``\\ s in :mod:`repro_torch.kernels.ops`, and flash
attention's from :mod:`repro_torch.models.flash`.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")

#: called with the tensors a fake implementation allocates, outputs and
#: scratch in the launch's order (:mod:`repro_torch.launch.op_cost` adds
#: one while it traces: ops run inside an operator's implementation do not
#: reach a dispatch mode)
allocation_hooks: List[Callable] = []

#: kernel name → launches since the last :func:`reset`
launches: Dict[str, int] = {}
#: kernel name → variant → its share of ``launches[name]``
variant_launches: Dict[str, Dict[str, int]] = {}
_count_lock = threading.Lock()      # decode replicas launch from worker threads


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes a kernel: a CUDA tensor, or a fake tensor on the
    ``meta`` device, which stands for a card tensor where torch is built
    without CUDA (such a build has no CUDA device guard, so autograd on a
    fake CUDA tensor cannot run: :mod:`repro_torch.launch.dryrun`)."""
    return t.device.type == "cuda" or (t.device.type == "meta" and isinstance(t, FakeTensor))


def counter(name: str, variants: Sequence[str]) -> None:
    """Start the counts of kernel ``name`` and its variants at 0."""
    launches[name] = 0
    variant_launches[name] = dict.fromkeys(variants, 0)


def counted(name: str, variant: str) -> None:
    """One launch of ``name`` by ``variant``: called by a CUDA
    implementation after its launch returned."""
    with _count_lock:
        launches[name] += 1
        variant_launches[name][variant] += 1


def fake_allocated(*tensors: Optional[torch.Tensor]) -> None:
    """Report what a fake implementation allocated (Nones skipped)."""
    for hook in allocation_hooks:
        hook([t for t in tensors if t is not None])


def reset() -> None:
    with _count_lock:
        for counts in (launches, *variant_launches.values()):
            for name in counts:
                counts[name] = 0


def register(schema: str, cuda: Callable, fake: Callable,
             flops: Callable) -> torch._ops.OpOverload:
    """Define ``repro_torch::<schema>`` with its CUDA and fake
    implementations and its FLOP formula (called with the tensors' shapes in
    their places, as ``register_flop_formula`` passes them); returns the
    operator."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet)(flops)
    return packet.default
