"""XFaaS-class connector chaining (paper baseline, §5).

Cross-platform sequences built from *existing cloud orchestration services*
joined by queue connectors: each hop costs 3 state transitions (paper §5.4:
"XFaaS uses ASF and AC, which involves 3 state transitions at an
invocation") plus the connector queue dwell.  Linear (sequence) workflows
only — the paper evaluates XFaaS on the IoT pipeline alone.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.backends.simcloud import Deployment, SimCloud, Workload

_ids = itertools.count()

CONNECTOR_QUEUE_MS = 12.0      # queue hop between per-cloud state machines


def run_xfaas_sequence(sim: SimCloud, stages: Sequence[Tuple[str, Workload]],
                       input_value: Any = None, *, name: Optional[str] = None,
                       t: float = 0.0) -> str:
    """Deploy+launch a linear chain. ``stages`` = [(faas_id, workload), ...]."""
    run = name or f"xfaas-{next(_ids):06d}"
    n = len(stages)

    for i, (faas, wl) in enumerate(stages):
        fname = f"{run}-s{i}"

        def handler(event, _i=i, _n=n, _run=run):
            out = yield shim.RunUser(event["data"])
            here_cloud = shim.cloud_of(stages[_i][0])
            # three state transitions per hop through the local service
            for _ in range(cal.XFAAS_TRANSITIONS_PER_HOP):
                sim.bill.charge_transition(here_cloud)
            if _i + 1 < _n:
                yield shim.Trace("connector")
                # service latency + connector queue, then invoke next stage
                yield shim.CreateClient(stages[_i + 1][0])
                yield shim.Invoke(stages[_i + 1][0], f"{_run}-s{_i+1}",
                                  {"run": _run, "data": out})
            return out

        self_wl = Workload(compute_ms=wl.compute_ms,
                           fixed_ms=wl.fixed_ms
                           + cal.XFAAS_TRANSITIONS_PER_HOP * cal.ASF_TRANSITION_MS
                           + CONNECTOR_QUEUE_MS,
                           fn=wl.fn)
        sim.deploy(Deployment(function=fname, faas=faas, handler=handler,
                              workload=self_wl))

    sim.submit(stages[0][0], f"{run}-s0", {"run": run, "data": input_value}, t=t)
    return run


def xfaas_makespan_ms(sim: SimCloud, run: str) -> float:
    recs = [r for r in sim.records
            if r.function.startswith(run) and r.status == "done"]
    if not recs:
        return float("nan")
    return max(r.t_end for r in recs) - min(r.t_queued for r in recs)
