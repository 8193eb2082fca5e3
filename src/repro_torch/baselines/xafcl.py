"""xAFCL-class centralized cross-cloud middleware (paper baseline, §5).

Master-worker: an orchestrator process on a long-running VM
(``cal.ORCH_VM``) schedules functions across multiple FaaS systems; every
function completion reports back to the orchestrator (one cross-cloud hop),
and intermediate data passes through a self-hosted datastore VM
(``cal.DS_VM``).  Cost model per the paper's Table-3 method:
``(unit_price · M · T)/N`` — VM-hours amortized over workflow concurrency N
assuming 100% utilization.

The centralized-bottleneck effect (paper §5.4, Fig 19b) is modelled by a
serial dispatch cost per invocation at the orchestrator
(``DISPATCH_MS``) — concurrent branch completions queue at the master.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.backends.simcloud import Deployment, SimCloud, Workload
from repro_torch.core import subgraph as sg

DISPATCH_MS = 5.0          # orchestrator serial work per dispatch
RECEIVE_MS = 6.0           # orchestrator serial work per completion event
DB_RW_MS = cal.TABLE_WRITE_MS + cal.TABLE_READ_MS


class XAFCLOrchestrator:
    def __init__(self, sim: SimCloud, spec: sg.WorkflowSpec, *,
                 orch_cloud: str, name: str = "xafcl"):
        self.sim = sim
        self.spec = spec
        self.cloud = orch_cloud
        self.name = name
        self._runs: Dict[str, Dict[str, Any]] = {}
        self._ids = itertools.count()
        self._busy_until = 0.0
        self._out_edges: Dict[str, List[sg.Edge]] = {n: [] for n in spec.functions}
        for e in spec.edges:
            if not e.back_edge:
                self._out_edges[e.src].append(e)
        self._deploy()

    def _deploy(self) -> None:
        from repro_torch.baselines.statemachine import resolve_refs
        # the self-hosted datastore node lives next to the orchestrator: ALL
        # intermediate data passes through it (worker→DB and DB→worker are
        # cross-cloud round trips for remote workers — the paper's "increased
        # cross-cloud transfers" that grow with pipeline length)
        self._db = next(d for d, s in sorted(self.sim.stores.items())
                        if s.cloud == self.cloud and s.kind == "table")
        self._ids2 = itertools.count()

        for f in self.spec.functions.values():
            def handler(event, _f=f):
                data = yield from resolve_refs(self.sim.stores, event["data"],
                                               gen=True)
                out = yield shim.RunUser(data)
                key = f"{event['run']}/{_f.name}/{next(self._ids2)}"
                yield shim.DsCreate(self._db, key, out)      # worker → DB node
                yield shim.Invoke(_orch_faas(self.sim, self.cloud),
                                  f"__orch__{self.name}",
                                  {"type": "done", "run": event["run"],
                                   "fn": _f.name,
                                   "data": {"__ref__": (self._db, key)}})
                return out

            self.sim.deploy(Deployment(
                function=f.name, faas=f.faas, handler=handler,
                workload=f.workload if isinstance(f.workload, Workload)
                else Workload(fn=f.workload), memory_gb=f.memory_gb))

        def orch_handler(event):
            # master-worker serialization: one dispatcher thread
            yield shim.Trace("orchestrate")
            yield shim.RunUser(None)        # ingress + DB state + egress time
            self._on_event(event)
            return True

        # per event: public-endpoint ingress (fn→VM) + state write to the DB
        # node + public-endpoint dispatch (VM→FaaS) on the way out
        self.sim.deploy(Deployment(
            function=f"__orch__{self.name}",
            faas=_orch_faas(self.sim, self.cloud),
            handler=orch_handler,
            workload=Workload(fixed_ms=DB_RW_MS + 2 * cal.PUBLIC_ENDPOINT_MS)))

    def start(self, input_value: Any = None) -> str:
        run = f"{self.name}-{next(self._ids):06d}"
        self._runs[run] = {"done": {}, "dispatched": set(),
                           "map_expected": {}, "map_out": {}}
        self.sim.submit(_orch_faas(self.sim, self.cloud), f"__orch__{self.name}",
                        {"type": "start", "run": run, "data": input_value})
        return run

    def _dispatch(self, run: str, fn: str, data: Any) -> None:
        st = self._runs[run]
        st["dispatched"].add(fn)
        # serialization at the master: dispatches queue behind each other
        t = max(self.sim.now, self._busy_until) + DISPATCH_MS
        self._busy_until = t
        self.sim.at(t, lambda: self.sim.submit(
            self.spec.functions[fn].faas, fn, {"run": run, "data": data}))

    def _on_event(self, event: dict) -> None:
        # single middleware process: completion handling serializes too —
        # this is the centralized bottleneck that caps branch scaling (Fig 19b)
        t = max(self.sim.now, self._busy_until) + RECEIVE_MS
        self._busy_until = t
        self.sim.at(t, lambda: self._process(event))

    def _process(self, event: dict) -> None:
        run = event["run"]
        st = self._runs[run]
        if event["type"] == "start":
            self._dispatch(run, self.spec.entry, event["data"])
            return
        fn, out = event["fn"], event["data"]
        if isinstance(out, dict) and "__ref__" in out:
            # the orchestrator is co-located with the DB node: control-flow
            # decisions (Choice predicates, Map expansion, map-fan-in
            # collection) read it locally
            ds, key = out["__ref__"]
            peek = self.sim.stores[ds].state.get(key)
            if peek is not None:
                out = peek
        if fn in st["map_expected"]:
            # one completion of a mapped function: collect until all arrive
            st["map_out"].setdefault(fn, []).append(out)
            if len(st["map_out"][fn]) < st["map_expected"][fn]:
                return
            out = st["map_out"][fn]
        st["done"][fn] = out
        for e in self._out_edges[fn]:
            if e.mode == sg.CHOICE and e.predicate is not None \
                    and not e.predicate(out):
                continue
            if e.mode == sg.MAP and isinstance(out, (list, tuple)):
                st["map_expected"][e.dst] = len(out)
                for item in out:
                    self._dispatch(run, e.dst, item)
                continue
            dst = e.dst
            if dst in st["dispatched"]:
                continue
            need = [x.src for x in self.spec.edges
                    if x.dst == dst and not x.back_edge]
            if all(s in st["done"] for s in need):
                data = ([st["done"][s] for s in need] if len(need) > 1
                        else st["done"][need[0]])
                self._dispatch(run, dst, data)

    # ---- reporting / cost -------------------------------------------------

    def makespan_ms(self, run: str) -> float:
        recs = [r for r in self.sim.records
                if isinstance(r.payload, dict) and r.payload.get("run") == run
                and r.status == "done"]
        if not recs:
            return float("nan")
        return max(r.t_end for r in recs) - min(r.t_queued for r in recs)

    def charge_vms(self, makespan_ms: float, invocations: int = 1_000_000,
                   concurrency: int = 2) -> float:
        """Table-3 VM cost: (unit price · M · T) / N, at 100% utilization."""
        hours = (makespan_ms / 3.6e6) * invocations / concurrency
        c = self.sim.bill.charge_vm(cal.ORCH_VM, hours)
        c += self.sim.bill.charge_vm(cal.DS_VM, hours)
        return c


def _orch_faas(sim: SimCloud, cloud: str) -> str:
    for fid, f in sorted(sim.faas.items()):
        if f.cloud == cloud and not f.flavor.gpu:
            return fid
    raise KeyError(f"no CPU FaaS in {cloud}")
