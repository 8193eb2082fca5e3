"""Loading a cell by name and running it: everything behind ``perfbench/run.py``.

A cell (``workloads/<cell>.json``) names its configuration and its traffic
mix; the mix names its driver.  The driver builds the port's model, warms up
the cell's own shapes, measures for ``--seconds``, checks what the timed path
produced against the plain reference and returns a :class:`Result`.  This
module turns it into the run's last line: the end-to-end metrics of an
untraced run, or, with ``--trace 1``, the per-layer metrics that
``BENCHMARK.json`` lists for the cell, each read by ``metrics/<name>.py``.

A driver reports quantities by name (``train_tokens_per_s``); an end-to-end
metric ``<quantity>.<group>`` is the same quantity in the cells of a group
that keeps a bound of its own (``train_tokens_per_s.host_paced``).

A configuration runs at its published depth (``num_hidden_layers`` or
``n_layer``) unless its ``layers`` entry cuts the depth for a driver.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

import torch

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: top-level module names no benchmark run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the keys a published configuration states its depth under
DEPTH_KEYS = ("num_hidden_layers", "n_layer", "num_layers")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def _named(kind: str, name: str, suffix: str = ".json") -> Path:
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = PERFBENCH / kind / (name + suffix)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return path


def workload_file(name: str) -> Dict[str, Any]:
    return load_json(_named("workloads", name))


def config_file(name: str) -> Dict[str, Any]:
    return load_json(_named("configs", name))


def traffic_file(name: str) -> Dict[str, Any]:
    return load_json(_named("traffic", name))


def file_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = _named(kind, name, ".py")
    modname = f"perfbench_{kind}_" + re.sub(r"\W", "_", name)
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: Dict[str, Any], cell: str, section: str) -> List[Dict[str, Any]]:
    """The entries of ``spec[section]`` that cell ``cell`` reports: those
    whose ``workloads`` list it, or, without such a list, every end-to-end
    metric and every per-layer metric whose ``moves`` the cell reports."""
    e2e = {m["name"] for m in cell_metrics(spec, cell, "end_to_end")} \
        if section == "per_layer" else set()
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


@dataclass
class Check:
    """One number compared with the reference, and its limit (the number
    has to be at most the limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Result:
    """What a driver returns."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    trace: Any = None                      # trace.TraceData of a traced run
    lines: List[str] = field(default_factory=list)


@dataclass
class Bench:
    """One run of one cell, as the driver sees it."""
    cell: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                                     # process start, perf_counter
    model_cfg: Any = None                         # the port's ModelConfig
    window_t0: Optional[float] = None

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    @property
    def layers(self) -> int:
        """The depth this driver runs: the configuration's cut for it, or
        the published depth."""
        return self.config.get("layers", {}).get(self.driver) or published_depth(self.config)

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    def reference(self) -> ModuleType:
        return file_module("reference", self.config["reference"])

    def dims(self) -> Dict[str, Any]:
        """The configuration as the reference reads it, at the driver's depth."""
        return {**self.config, "num_layers": self.layers}

    def start_window(self, t: float) -> None:
        self.window_t0 = t

    @property
    def setup_s(self) -> float:
        return self.window_t0 - self.t0


def published_depth(config: Dict[str, Any]) -> int:
    for key in DEPTH_KEYS:
        if key in config:
            return config[key]
    raise KeyError(f"{config['name']}: no depth under any of {DEPTH_KEYS}")


def port_config(config: Dict[str, Any], layers: int, base: Any = None):
    """The port's ModelConfig of a configuration file at ``layers`` blocks:
    the arch's structure from the port's registry (or ``base``), and every
    key that the file's ``port.keys`` maps set to the file's value."""
    from repro_torch import configs
    cfg = base if base is not None else configs.get(config["port"]["arch"])
    for key, attr in config["port"]["keys"].items():
        cfg = _set(cfg, attr.split("."), config[key])
    return cfg.replace(n_layers=layers)


def _set(obj: Any, parts: List[str], value: Any) -> Any:
    inner = value if len(parts) == 1 else _set(getattr(obj, parts[0]), parts[1:], value)
    return dataclasses.replace(obj, **{parts[0]: inner})


def make_bench(cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
               t0: float) -> Bench:
    wl = workload_file(cell)
    config = config_file(wl["config"])
    traffic = traffic_file(wl["traffic"])
    b = Bench(cell=cell, workload=wl, config=config, traffic=traffic, seed=seed,
              seconds=seconds, trace=trace, device=device, t0=t0)
    b.model_cfg = port_config(config, b.layers)
    return b


def run_bench(b: Bench) -> Result:
    return file_module("drivers", b.driver).run(b)


def _device_info(b: Bench, r: Result) -> Dict[str, Any]:
    info: Dict[str, Any] = {"platform": "gpu" if b.device.type == "cuda" else b.device.type,
                            "kind": (torch.cuda.get_device_name(b.device)
                                     if b.device.type == "cuda" else "cpu"),
                            "count": 1, "memory_peak_bytes": r.memory_peak_bytes}
    if r.trace is not None:
        info["busy_s"] = r.trace.busy_s
        info["window_s"] = r.trace.window_s
    return info


def report(b: Bench, r: Result, spec: Dict[str, Any]) -> Tuple[Dict[str, Any], List[str]]:
    """The result line's object, and the lines for standard error (the
    numbers compared, each beside its limit, last)."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if not b.trace:
        values = dict(r.end_to_end, setup_s=b.setup_s)
        for m in cell_metrics(spec, b.cell, "end_to_end"):
            quantity = m["name"].split(".")[0]
            if quantity not in values:
                raise KeyError(f"{b.driver} driver gives no {quantity} for {b.cell}")
            metrics[m["name"]] = {"value": values[quantity], "unit": m["unit"]}
    else:
        for m in cell_metrics(spec, b.cell, "per_layer"):
            value = file_module("metrics", m["name"]).read(r.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(r.checks) and all(c.ok for c in r.checks) and r.failed == 0
    out: Dict[str, Any] = {"correct": correct, "attempted": r.attempted, "failed": r.failed,
                           "metrics": metrics, "device": _device_info(b, r)}
    if r.trace is not None:
        out["breakdown"] = r.trace.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in r.checks}
    err = [f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}"
           for c in r.checks]
    return out, err
