"""Lithops-class homogeneous worker pool (paper baseline, §5).

Functions are generic *workers* ("cloud threads"): a driver VM scatters
tasks; every worker pays runtime initialization (≈500 ms, paper §5.4), pulls
code+data from object storage, computes, and writes its result back; the
driver polls storage for results and aggregates.  Centralized: scatter and
gather both serialize at the driver.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.backends.simcloud import Deployment, SimCloud, Workload

_ids = itertools.count()

# The Lithops driver is the user's machine outside the cloud: every task
# dispatch is an HTTP call through the public FaaS endpoint (serialized with
# connection reuse), and results are downloaded back over the same path.
DRIVER_DISPATCH_MS = 18.0      # per-task public-endpoint dispatch
RESULT_FETCH_MS = 4.0          # per-result download at the driver
POLL_INTERVAL_MS = 10.0        # driver polling period for results


def run_lithops_map(sim: SimCloud, faas: str, task: Workload, n_tasks: int,
                    agg: Optional[Workload] = None, *,
                    store: Optional[str] = None, t: float = 0.0) -> str:
    """Scatter ``n_tasks`` workers + aggregate. Returns the run id."""
    run = f"lithops-{next(_ids):06d}"
    cloud = shim.cloud_of(faas)
    store = store or next(d for d, s in sorted(sim.stores.items())
                          if s.cloud == cloud and s.kind == "table")

    def worker_handler(event):
        # worker init + code/data pull from storage
        yield shim.Trace("init")
        yield shim.DsGet(store, f"{run}/code")
        yield shim.DsGet(store, f"{run}/task{event['i']}")
        yield shim.Trace("user_exec")
        out = yield shim.RunUser(event["data"])
        yield shim.DsCreate(store, f"{run}/result{event['i']}", {"v": out})
        return out

    worker_wl = Workload(compute_ms=task.compute_ms,
                         fixed_ms=task.fixed_ms + cal.LITHOPS_WORKER_INIT_MS,
                         fn=task.fn)
    sim.deploy(Deployment(function=f"{run}-worker", faas=faas,
                          handler=worker_handler, workload=worker_wl))

    if agg is not None:
        def agg_handler(event):
            vals = yield shim.Parallel([
                shim.DsGet(store, f"{run}/result{i}") for i in range(n_tasks)])
            out = yield shim.RunUser([v and v.get("v") for v in vals])
            yield shim.DsCreate(store, f"{run}/final", {"v": out})
            return out

        sim.deploy(Deployment(function=f"{run}-agg", faas=faas,
                              handler=agg_handler, workload=agg))

    # driver: seed storage, scatter serially, poll for completion
    def seed():
        sim.stores[store].state.create_if_absent(f"{run}/code", {"sz": 1})
        for i in range(n_tasks):
            sim.stores[store].state.create_if_absent(f"{run}/task{i}", {"i": i})
            sim.bill.charge_ds_write(cloud, 2)
        for i in range(n_tasks):
            sim.at(sim.now + (i + 1) * DRIVER_DISPATCH_MS,
                   lambda i=i: sim.submit(faas, f"{run}-worker",
                                          {"run": run, "i": i, "data": i}))
        if agg is not None:
            poll()

    def poll():
        st = sim.stores[store].state
        sim.bill.charge_ds_read(cloud, 1)
        done = all(f"{run}/result{i}" in st.items for i in range(n_tasks))
        if done:
            # driver downloads every result before aggregating
            sim.after(RESULT_FETCH_MS * n_tasks,
                      lambda: sim.submit(faas, f"{run}-agg", {"run": run}))
        else:
            sim.after(POLL_INTERVAL_MS, poll)

    sim.at(t, seed)
    return run


def lithops_makespan_ms(sim: SimCloud, run: str) -> float:
    recs = [r for r in sim.records
            if r.function.startswith(run) and r.status == "done"]
    if not recs:
        return float("nan")
    return max(r.t_end for r in recs) - min(r.t_queued for r in recs)


def charge_driver_vm(sim: SimCloud, makespan_ms: float,
                     invocations: int = 1_000_000, concurrency: int = 2) -> float:
    hours = (makespan_ms / 3.6e6) * invocations / concurrency
    return sim.bill.charge_vm(cal.LITHOPS_VM, hours)
