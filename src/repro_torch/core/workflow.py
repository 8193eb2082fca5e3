"""Deploy compiled workflows onto any Backend and launch instances.

``deploy`` compiles the WorkflowSpec into per-function NodeViews, then
registers one deployment per (function × FaaS system) — primaries *and*
pre-deployed failover backups share the same NodeView, because checkpoint
keys must be attempt-location-independent (§4.2).  A GC function is deployed
once per cloud (§4.4).

This layer is **substrate-blind**: it only calls the
:class:`repro_torch.backends.shim.Backend` protocol surface (``deploy`` /
``submit`` / ``catalog`` / the record-query methods), so the same workflow
artifact deploys unchanged on SimCloud, the concurrent local runner, or any
future backend.  Optional capabilities (``topology``, ``faas`` flavors) are
probed with ``getattr`` — never assumed — and their absence surfaces as a
:class:`repro_torch.backends.shim.CapabilityError`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, Optional

from repro_torch.backends import shim
from repro_torch.backends.shim import Backend, Deployment, Workload
from repro_torch.core import orchestrator as orch
from repro_torch.core import subgraph as sg


@dataclass
class DeployedWorkflow:
    """A compiled workflow living on one Backend: launch instances
    (:meth:`start`), extract results/makespans from the record-query
    surface, and re-place it at runtime (:meth:`replan`,
    :meth:`learn_profiles` — both need optional backend capabilities)."""

    spec: sg.WorkflowSpec
    views: Dict[str, sg.NodeView]
    backend: Backend
    _ids: itertools.count = None  # type: ignore[assignment]

    def __post_init__(self):
        self._ids = itertools.count()

    @property
    def sim(self) -> Backend:
        """Legacy alias from when SimCloud was the only substrate."""
        return self.backend

    @property
    def entry(self) -> sg.NodeView:
        """Compiled view of the workflow's entry function — the node
        external clients (``start``) address."""
        assert self.spec.entry is not None
        return self.views[self.spec.entry]

    def mint_workflow_id(self) -> str:
        """Reserve the next workflow id without starting anything — the
        lazy-submission path (``LoadRunner.submit_lazy``) mints ids upfront
        so callers can index results while arrivals are still being fed."""
        return f"{self.spec.name}-{next(self._ids):06d}"

    def start(self, input_value: Any = None, *, workflow_id: Optional[str] = None,
              t: float = 0.0) -> str:
        """Async-invoke the entry function after a delay of ``t`` ms
        (virtual time on SimCloud, wall-clock on the local runner)."""
        wfid = workflow_id or self.mint_workflow_id()
        self.backend.submit(self.entry.faas, self.entry.name,
                            {"workflow_id": wfid, "input": input_value}, t=t)
        return wfid

    # ---- result extraction -------------------------------------------------

    def executions(self, workflow_id: str):
        """All execution records belonging to one workflow instance
        (including ``-batchN`` spin-offs) — served from the backend's
        workflow-id index, not a scan over every record."""
        return self.backend.workflow_records(str(workflow_id))

    def makespan_ms(self, workflow_id: str, *, include_gc: bool = False) -> float:
        """End-to-end latency of one instance: first queue time to last
        completion over its ``done`` records (GC excluded by default).
        NaN while nothing has completed."""
        recs = [r for r in self.executions(workflow_id)
                if r.status == "done" and (include_gc or r.function != sg.GC_FUNCTION)]
        if not recs:
            return float("nan")
        t0 = min(r.t_queued for r in recs)
        t1 = max(r.t_end for r in recs)
        return t1 - t0

    def result_of(self, workflow_id: str, function: str) -> Any:
        """Latest ``done`` result of ``function`` in one instance (None if
        it never completed) — exactly-once means retries agree on it."""
        done = [r for r in self.executions(workflow_id)
                if r.function == function and r.status == "done"]
        return done[-1].result if done else None

    # ---- durable execution (journal replay + signals) ----------------------

    def signal(self, workflow_id: str, name: str, value: Any = True, *,
               t: float = 0.0) -> None:
        """Deliver a named signal to one workflow instance, resolving any
        ``WaitForSignal(name)`` it is (or will be) suspended on.  ``t`` is a
        delay in ms, same contract as ``start(t=)``.  Requires the optional
        ``signal`` capability."""
        send = self._capability(
            "signal", why="deliver WaitForSignal wake-ups")
        send(str(workflow_id), name, value, t=t)

    def resume(self) -> list:
        """Rehydrate every started-but-unfinished journaled attempt on this
        backend by replaying its effect journal (see
        ``repro_torch.core.durable.resume``).  The idiom: construct a fresh
        backend over the same stores (persistent WALs or ``adopt_stores``),
        re-``deploy`` the spec, then ``resume()`` — suspended workflows
        replay to their exact suspension point and continue, exactly-once
        preserved.  Requires the optional ``journal`` capability."""
        from repro_torch.core.durable import resume as _resume
        return _resume(self.backend)

    # ---- runtime re-planning (outage-aware, trace-calibrated) --------------

    def _capability(self, name: str, *, why: str) -> Any:
        value = getattr(self.backend, name, None)
        if not value:
            raise shim.CapabilityError(
                f"{type(self.backend).__name__} provides no '{name}' "
                f"capability, required to {why} (see the Backend protocol "
                f"in repro_torch.backends.shim)")
        return value

    def learn_profiles(self):
        """Trace-calibrated workload profiles from this backend's completed
        executions (``EdgeProfiles.from_records``) — the pilot-run feedback
        the planner consumes via ``plan_workflow(profiles=...)``."""
        from repro_torch.core.costmodel import EdgeProfiles
        self._capability("faas", why="map records onto flavors")
        return EdgeProfiles.from_records(self.backend)

    def replan(self, *, excluded_clouds: Any = (), objective: str = "makespan",
               weight: Any = None, flavors: Any = None, profiles: Any = None,
               candidates: Any = None) -> "DeployedWorkflow":
        """Re-place this workflow for *future* instances and redeploy.

        The outage path (§4.2/Fig 10): when a monitor observes a cloud
        outage it calls ``replan(excluded_clouds={cloud})`` — the planner
        solves the placement problem over the surviving clouds (seeded with
        profiles learned from the traces so far) and the new assignment,
        with ranked failover orders, replaces the deployments in place.
        In-flight instances are unaffected: checkpoint keys are
        attempt-location-independent, so they complete under either
        placement.  Returns the re-deployed workflow (same backend).

        Requires the optional ``topology`` and ``faas`` capabilities: on a
        backend without a network model (e.g. the local runner) this raises
        a clear :class:`repro_torch.backends.shim.CapabilityError` instead of
        re-planning over a substrate it cannot cost.
        """
        from repro_torch.core import placement
        topology = self._capability(
            "topology", why="cost candidate placements for replan()")
        faas_map = self._capability(
            "faas", why="enumerate candidate flavors for replan()")
        if profiles is None:
            profiles = self.learn_profiles()
        if flavors is None:
            # candidates must mirror the backend's *actual* substrate — the
            # global default config may lack clouds this jointcloud has
            # (and the excluded-cloud filter would then fall back to pins
            # on the very cloud being excluded)
            flavors = {fid: f.flavor for fid, f in faas_map.items()}
        plan = placement.plan_workflow(
            self.spec, flavors, objective=objective, weight=weight,
            profiles=profiles, candidates=candidates,
            excluded_clouds=tuple(excluded_clouds),
            topology=topology, with_failover=True)
        return deploy(self.backend, self.spec, plan=plan)


def deploy(backend: Backend, spec: sg.WorkflowSpec,
           catalog: Optional[sg.Catalog] = None, *,
           plan: Any = None, durable: bool = False,
           prefetch: bool = False, profiles: Any = None) -> DeployedWorkflow:
    """Compile and deploy ``spec`` onto any Backend-protocol substrate.
    ``plan`` — a ``placement.PlacementPlan`` (or any object with
    ``.overrides()``) — re-places the workflow's nodes before compilation;
    the returned DeployedWorkflow carries the re-placed spec so
    makespan/bill queries see the effective placement.

    ``durable=True`` interposes the event-sourced effect journal
    (:mod:`repro_torch.core.durable`) on every node: each effect's result is
    committed to the node's home table before the handler resumes, making
    instances replayable via :meth:`DeployedWorkflow.resume` at the cost of
    roughly one extra table write per effect.  Strictly opt-in — the
    default path yields byte-identical effect streams to previous
    releases.

    ``prefetch=True`` runs the :mod:`repro_torch.core.prefetch` planner pass over
    the compiled views and arms speculative-push directives on every edge
    it enables (``profiles`` — an ``EdgeProfiles`` — sharpens the size
    predictions).  The backend must provide the ``prefetch`` capability
    (probed here, per the Backend protocol): armed handlers yield
    :class:`~repro_torch.backends.shim.Prefetch` effects, so deploying them on a
    non-capable backend degrades to a :class:`CapabilityError` at deploy
    time, never an interpreter crash mid-workflow.  Also strictly opt-in —
    with ``prefetch=False`` every directive stays at its inert default and
    effect streams are byte-identical to previous releases."""
    if plan is not None:
        spec = sg.apply_placement(spec, plan.overrides())
    catalog = catalog or backend.catalog()
    views = sg.compile_workflow(spec, catalog)
    if durable:
        for view in views.values():
            view.durable = True
    if prefetch:
        if not getattr(backend, "prefetch", None):
            raise shim.CapabilityError(
                f"{type(backend).__name__} provides no 'prefetch' "
                f"capability, required to interpret speculative Prefetch "
                f"effects (see the Backend protocol in repro_torch.backends.shim)")
        from repro_torch.core.prefetch import annotate_views
        annotate_views(views, spec, profiles=profiles)
    # ByRedundant replicas are additional deployment targets of the dst fn
    replica_targets: dict = {}
    for view in views.values():
        for info in view.next_funcs:
            if info.mode == sg.BY_REDUNDANT:
                replica_targets.setdefault(info.name, set()).update(info.replicas)
    for name, view in views.items():
        f = spec.functions[name]
        workload = f.workload if isinstance(f.workload, Workload) else Workload(fn=f.workload)
        targets = {view.faas, *view.failover, *replica_targets.get(name, ())}
        for faas in sorted(targets):
            backend.deploy(Deployment(
                function=name, faas=faas, handler=orch.make_handler(view),
                workload=workload, memory_gb=f.memory_gb))
    for cloud, faas in catalog.gc_faas.items():
        if (faas, sg.GC_FUNCTION) not in backend.deployments:
            backend.deploy(Deployment(function=sg.GC_FUNCTION, faas=faas,
                                      handler=orch.gc_handler, workload=Workload()))
    return DeployedWorkflow(spec, views, backend)
