"""Managed state-machine orchestration (AWS Step Functions / AliYun CloudFlow).

Centralized: every edge of the workflow is a *state transition* through the
managed service — one service hop of latency (``cal.ASF_TRANSITION_MS``) and
one $25/1M charge per transition (paper §2.2).  Payloads flow through the
service (function → service → function), which is the extra communication
link of Fig 3.  Exactly-once is the service's guarantee (the paper grants
both ASF standard and AC this), so no checkpoints are modelled.

Single-cloud by design: all functions must live on FaaS systems of the
orchestrator's cloud (ASF cannot invoke AliYun FC) — enforcing the paper's
vendor-lock-in premise.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.backends.simcloud import Deployment, SimCloud, Workload
from repro_torch.core import subgraph as sg


def wire_value(store: str, quota: int, prefix: str, counter, out):
    """Effect generator: replace over-quota values (or list elements) by
    object-store references, returning the wire-safe representation."""
    from repro_torch.backends.simcloud import estimate_size

    def put(value):
        key = f"{prefix}/{next(counter)}"
        return key

    if isinstance(out, (list, tuple)):
        wired = []
        for item in out:
            if estimate_size(item) > quota:
                key = put(item)
                yield shim.DsCreate(store, key, item)
                wired.append({"__ref__": (store, key)})
            else:
                wired.append(item)
        return wired
    if estimate_size(out) > quota:
        key = put(out)
        yield shim.DsCreate(store, key, out)
        return {"__ref__": (store, key)}
    return out


def resolve_refs(sim_stores, data, *, gen):
    """Dereference ``{"__ref__": (ds, key)}`` payloads (ASF S3-ARN style)."""
    if isinstance(data, dict) and "__ref__" in data:
        ds, key = data["__ref__"]
        val = yield shim.DsGet(ds, key)
        return val
    if isinstance(data, list):
        out = []
        for item in data:
            v = yield from resolve_refs(sim_stores, item, gen=gen)
            out.append(v)
        return out
    return data


class StateMachineOrchestrator:
    """Deploy a WorkflowSpec behind an ASF/AC-class service on one cloud."""

    def __init__(self, sim: SimCloud, spec: sg.WorkflowSpec, *, cloud: str,
                 name: str = "asf", transition_ms: Optional[float] = None):
        self.sim = sim
        self.spec = spec
        self.cloud = cloud
        self.name = name
        self.transition_ms = (cal.ASF_TRANSITION_MS if transition_ms is None
                              else transition_ms)
        self._obj_store = next(d for d, s in sorted(sim.stores.items())
                               if s.cloud == cloud and s.kind == "object")
        self._ids2 = itertools.count()
        self._runs: Dict[str, Dict[str, Any]] = {}
        self._ids = itertools.count()
        self._out_edges: Dict[str, List[sg.Edge]] = {n: [] for n in spec.functions}
        self._in_deg: Dict[str, int] = {n: 0 for n in spec.functions}
        for e in spec.edges:
            if e.back_edge:
                continue
            self._out_edges[e.src].append(e)
            self._in_deg[e.dst] += 1
        for f in spec.functions.values():
            if shim.cloud_of(f.faas) != cloud:
                raise ValueError(
                    f"{name}: {f.name} on {f.faas} — single-cloud services "
                    f"cannot orchestrate across clouds (paper §2.2)")
        self._deploy()

    # ---- deployment -------------------------------------------------------

    def _deploy(self) -> None:
        for f in self.spec.functions.values():
            def handler(event, _f=f):
                data = yield from resolve_refs(self.sim.stores, event["data"],
                                               gen=True)
                out = yield shim.RunUser(data)
                # payloads over the async quota pass by object-store reference
                # (the S3-ARN idiom real ASF users rely on)
                quota = cal.PAYLOAD_QUOTA.get(self.cloud,
                                              cal.DEFAULT_PAYLOAD_QUOTA) // 2
                out_wire = yield from wire_value(
                    self._obj_store, quota, f"{event['run']}/{_f.name}",
                    self._ids2, out)
                # report back to the service (the Fig-3 extra link)
                yield shim.Invoke(_service_faas(self.sim, self.cloud),
                                  f"__svc__{self.name}",
                                  {"type": "done", "run": event["run"],
                                   "fn": _f.name, "data": out_wire})
                return out

            self.sim.deploy(Deployment(
                function=f.name, faas=f.faas, handler=handler,
                workload=f.workload if isinstance(f.workload, Workload)
                else Workload(fn=f.workload), memory_gb=f.memory_gb))

        def svc_handler(event):
            yield shim.Trace("orchestrate")
            yield shim.RunUser(None)        # the service's transition latency
            self._on_event(event)
            return True

        self.sim.deploy(Deployment(
            function=f"__svc__{self.name}",
            faas=_service_faas(self.sim, self.cloud),
            handler=svc_handler,
            workload=Workload(fixed_ms=self.transition_ms)))

    # ---- control flow (runs inside the service function) --------------------

    def start(self, input_value: Any = None) -> str:
        run = f"{self.name}-{next(self._ids):06d}"
        self._runs[run] = {"done": {}, "dispatched": set()}
        self.sim.submit(_service_faas(self.sim, self.cloud),
                        f"__svc__{self.name}",
                        {"type": "start", "run": run, "data": input_value})
        return run

    def _transition(self, run: str, fn: str, data: Any) -> None:
        """One state transition: bill + dispatch the function."""
        self.sim.bill.charge_transition(self.cloud)
        st = self._runs[run]
        st["dispatched"].add(fn)
        self.sim.after(0.0, lambda: self.sim.submit(
            self.spec.functions[fn].faas, fn, {"run": run, "data": data}))

    def _on_event(self, event: dict) -> None:
        run = event["run"]
        st = self._runs[run]
        if event["type"] == "start":
            self._transition(run, self.spec.entry, event["data"])
            return
        fn, out = event["fn"], event["data"]
        st["done"][fn] = out
        for e in self._out_edges[fn]:
            if e.mode == sg.CHOICE and e.predicate is not None \
                    and not e.predicate(out):
                continue
            if e.mode == sg.MAP and isinstance(out, (list, tuple)):
                for item in out:
                    self.sim.bill.charge_transition(self.cloud)
                    self.sim.submit(self.spec.functions[e.dst].faas, e.dst,
                                    {"run": run, "data": item})
                st["dispatched"].add(e.dst)
                continue
            dst = e.dst
            if dst in st["dispatched"]:
                continue
            need = [x.src for x in self.spec.edges
                    if x.dst == dst and not x.back_edge]
            if all(s in st["done"] for s in need):
                data = ([st["done"][s] for s in need] if len(need) > 1
                        else st["done"][need[0]])
                self._transition(run, dst, data)

    # ---- reporting -----------------------------------------------------------

    def makespan_ms(self, run: str) -> float:
        recs = [r for r in self.sim.records
                if isinstance(r.payload, dict) and r.payload.get("run") == run
                and r.status == "done"]
        if not recs:
            return float("nan")
        return max(r.t_end for r in recs) - min(r.t_queued for r in recs)


def _service_faas(sim: SimCloud, cloud: str) -> str:
    """The FaaS id hosting the managed service's logic in ``cloud``."""
    for fid, f in sorted(sim.faas.items()):
        if f.cloud == cloud and not f.flavor.gpu:
            return fid
    raise KeyError(f"no CPU FaaS in {cloud}")
