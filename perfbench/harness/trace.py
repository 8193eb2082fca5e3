"""The traced window: a ``torch.profiler`` trace reduced to what the per-layer
metrics read.

``CLASSES``, :func:`kernel_class` and :func:`union_us` are frozen copies of
``repro_torch.launch.profile_serve`` (the kernel classes by name, and the
device's busy time as the union of kernel intervals): the port may change its
own copy, the yardstick stays.  The MoE ranges' scope classes are left out:
no cell runs the MoE layer.

The benchmark's own host-side spans (``record_function`` ranges named
``bench.*``, opened by the drivers around their calls into the port) label
the device's idle gaps by what the host was doing.  Nothing here reaches
into the port.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

#: kernel class by substring of the kernel's name (first match wins)
CLASSES = [
    ("ssd_scan_bwd", ("ssd_bwd_",)),                       # the SSD backward's 7 kernels
    ("rglru_scan_bwd", ("rglru_scan_bwd_kernel",)),
    ("flash_attention_bwd", ("flash_bwd_",)),              # delta, dk/dv and dq kernels
    ("flash_attention", ("flash_fwd_kernel",)),
    ("ssd_scan", ("ssd_scan_kernel", "ssd_sm90::")),      # fma; mma's three kernels
    ("rglru_scan", ("rglru_scan_kernel",)),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("elementwise/cast", ("elementwise", "copy", "cast", "fill", "where")),
    ("reduction/softmax", ("reduce", "softmax", "norm")),
    ("index/sort/cat", ("index", "cat", "gather", "scatter", "roll", "pad", "sort", "radix",
                        "topk", "searchsorted")),
]

#: profiler activity types that are work on the device
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
OP_PREFIX = "repro_torch::"


def kernel_class(name: str) -> str:
    """The class of a device operation by its name."""
    low = name.lower()
    return next((c for c, keys in CLASSES if any(k in low for k in keys)), "other")


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of ``intervals``."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def span(name: str):
    """A host-side span of the benchmark (``bench.<name>``)."""
    return record_function(SPAN_PREFIX + name)


@dataclass
class OpCall:
    """One call of a port operator (``repro_torch::*``) as the trace
    recorded it: its input shapes, dtypes and scalar arguments (None in a
    tensor's place)."""
    name: str
    shapes: List[List[int]]
    dtypes: List[str]
    scalars: List[Any]


@dataclass
class TraceData:
    """What the per-layer metric readers get: the first traced chunk's device
    operations, spans and window (traced without the operators' input
    shapes, whose recording slows the host), and the second chunk's port
    operator calls with their shapes beside its device operations (for the
    kernels' rooflines, which read device time only)."""
    window_s: float
    device_ops: List[Tuple[str, int, int]]           # (name, start ns, end ns)
    spans: List[Tuple[str, int, int]]
    window_ns: Tuple[int, int]
    ops: List[OpCall] = field(default_factory=list)
    shaped_device_ops: List[Tuple[str, int, int]] = field(default_factory=list)
    work: Dict[str, Any] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)
    kind: str = ""                                     # the device's name

    @property
    def busy_s(self) -> float:
        return union_us([(s / 1e3, e / 1e3) for _, s, e in self.device_ops]) / 1e6

    def class_s(self) -> Dict[str, float]:
        """Device seconds by kernel class in the first chunk."""
        return _class_s(self.device_ops)

    def shaped_class_s(self) -> Dict[str, float]:
        """Device seconds by kernel class in the chunk whose operator calls
        :attr:`ops` holds."""
        return _class_s(self.shaped_device_ops)

    def calls(self, op: str) -> List[OpCall]:
        return [c for c in self.ops if c.name == OP_PREFIX + op]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the device's idle
        time by the benchmark span the host was in at each gap's middle."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device_ops:
            by_name[name[:160]] += (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, float] = defaultdict(float)
        for a, b in self.idle_gaps():
            gaps[self.span_at((a + b) // 2)] += (b - a) / 1e9
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in
                              sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """The intervals of the traced window in which no device operation ran."""
        w0, w1 = self.window_ns
        out, end = [], w0
        for s, e in sorted((s, e) for _, s, e in self.device_ops):
            if s > end:
                out.append((end, min(s, w1)))
            end = max(end, e)
        if end < w1:
            out.append((end, w1))
        return [(a, b) for a, b in out if b > a]

    def span_at(self, t: int) -> str:
        """The innermost benchmark span (other than the window's) holding ``t``."""
        best = None
        for name, s, e in self.spans:
            if s <= t <= e and name != SPAN_PREFIX + "window":
                if best is None or e - s < best[2] - best[1]:
                    best = (name, s, e)
        return best[0] if best else "outside the benchmark's spans"


def _class_s(device_ops) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for name, s, e in device_ops:
        out[kernel_class(name)] += (e - s) / 1e9
    return dict(out)


def _activity(e) -> str:
    """The kind of a profiler event, from what every torch of the cards
    reports (``activity_type`` is missing in some)."""
    cuda = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return "gpu_user_annotation" if cuda else "user_annotation"
    return "kernel" if cuda else "cpu_op"


def _events(prof):
    """(device operations, benchmark spans, port operator calls) of a trace."""
    device_ops, spans, ops = [], [], []
    for e in prof.profiler.kineto_results.events():
        act, name = _activity(e), e.name()
        if act in DEVICE_ACTIVITIES:
            device_ops.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif act == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif act == "cpu_op" and name.startswith(OP_PREFIX):
            ops.append(OpCall(name, [list(x) for x in e.shapes()], list(e.dtypes()),
                              list(e.concrete_inputs())))
    return device_ops, spans, ops


class Chunks:
    """The traced run's two chunks of a driver's items (requests or steps):
    items ``lo … lo+n−1`` traced plainly, then ``lo+n … lo+2n−1`` with the
    operators' input shapes.  The driver calls :meth:`enter` before item
    ``i`` (it makes a chunk's inputs first, outside the trace) and
    :meth:`leave` after it."""

    def __init__(self, device: torch.device, lo: int, n: int, enabled: bool):
        self.device, self.lo, self.n, self.enabled = device, lo, n, enabled
        self.profs: List[profile] = []
        self._span = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def enter(self, i: int, make: Callable[[int], Any]) -> Dict[int, Any]:
        """At a chunk's first item: its items' inputs by ``make``, then the
        profiler started.  Elsewhere nothing."""
        if not self.enabled or i not in (self.lo, self.lo + self.n):
            return {}
        ahead = {j: make(j) for j in range(i, i + self.n)}
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, record_shapes=i != self.lo)
        self._sync()
        prof.__enter__()
        self._span = span("window")
        self._span.__enter__()
        self.profs.append(prof)
        return ahead

    def leave(self, i: int) -> None:
        if self.enabled and i in (self.lo + self.n - 1, self.lo + 2 * self.n - 1):
            self._sync()
            self._span.__exit__(None, None, None)
            self.profs[-1].__exit__(None, None, None)

    def done(self, i: int) -> bool:
        """Whether every traced item is before ``i``."""
        return not self.enabled or i >= self.lo + 2 * self.n

    def data(self, work: Dict[str, Any], config: Dict[str, Any], kind: str) -> TraceData:
        device_ops, spans, _ = _events(self.profs[0])
        shaped_ops, _, ops = _events(self.profs[1])
        window = next((s[1:] for s in spans if s[0] == SPAN_PREFIX + "window"), None)
        if window is None:
            raise RuntimeError("the trace holds no bench.window span")
        return TraceData(window_s=(window[1] - window[0]) / 1e9, device_ops=device_ops,
                         spans=spans, window_ns=window, ops=ops,
                         shaped_device_ops=shaped_ops, work=work, config=config, kind=kind)
