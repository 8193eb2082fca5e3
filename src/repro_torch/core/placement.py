"""Data placement policies (paper §4.3.1) + heterogeneity-aware placement (§2.1).

The *majority rule*: for indirect transfers feeding a fan-out/fan-in group,
put the datastore in the cloud hosting the plurality of the group's
functions — every colocated access is then intra-cloud and only the minority
pays egress (Fig 11, right).

Stage placement: given per-flavor duration and price models, pick the FaaS
system minimizing makespan (or cost) for a compute stage — the mechanism
behind the paper's Figs 1–2 observations, used by the crosscloud-inference
example and the heterogeneity benchmarks.

DAG placement (:func:`plan_workflow`): assign *every* node of a WorkflowSpec
to a FaaS system jointly, optimizing the whole-workflow makespan or cost —
critical-path-aware dynamic programming over topological levels, followed by
a majority-rule datastore co-placement pass for fan-out/fan-in groups and a
coordinate-descent refinement.  :func:`pareto_frontier` sweeps the
makespan↔cost scalarization weight and returns the non-dominated plans.
The resulting :class:`PlacementPlan` feeds ``subgraph.apply_placement`` /
``workflow.deploy(plan=...)``.

All latency/egress arithmetic goes through the shared
:class:`repro_torch.core.costmodel.CostModel` — the same object SimCloud's effect
interpreter charges with — so the planner's analytic estimates and the
simulator's timelines come from one model, not two hand-synchronized copies.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.core import prefetch as pf
from repro_torch.core.costmodel import CostModel, EdgeProfiles, Topology, stage_cost


def majority_cloud(clouds: Sequence[str]) -> Optional[str]:
    """Most frequent cloud; deterministic (alphabetical) tie-break."""
    if not clouds:
        return None
    counts = Counter(clouds)
    top = max(counts.values())
    return sorted(c for c, n in counts.items() if n == top)[0]


def egress_transfers(group_clouds: Sequence[str], placed_at: str) -> int:
    """Number of cross-cloud transfers a placement incurs (Fig 11 counting)."""
    return sum(1 for c in group_clouds if c != placed_at)


def best_placement(group_clouds: Sequence[str]) -> Tuple[str, int]:
    """(cloud, egress transfer count) minimizing cross-cloud movement."""
    cloud = majority_cloud(group_clouds)
    assert cloud is not None
    return cloud, egress_transfers(group_clouds, cloud)


# --------------------------------------------------------------------------
# Heterogeneity-aware stage placement (Observation 1 & 2)
# --------------------------------------------------------------------------


def choose_flavor(flavors: Dict[str, cal.Flavor], compute_ms: float,
                  fixed_ms: float = 0.0, objective: str = "makespan",
                  memory_gb: Optional[float] = None,
                  accel: bool = True) -> Tuple[str, float, float]:
    """Pick the FaaS system minimizing ``objective`` ∈ {makespan, cost}.

    Returns (faas_id, duration_ms, usd). Deterministic tie-break by id.
    """
    scored = []
    for fid, fl in sorted(flavors.items()):
        dur, usd = stage_cost(fl, compute_ms, fixed_ms, memory_gb, accel)
        key = dur if objective == "makespan" else usd
        scored.append((key, fid, dur, usd))
    key, fid, dur, usd = min(scored)
    return fid, dur, usd


# --------------------------------------------------------------------------
# DAG-level jointcloud placement (the Backend-Shim heterogeneity optimizer)
# --------------------------------------------------------------------------

# Invocation-primitive names, mirrored from core.subgraph (which imports this
# module — the strings are the stable contract between the two).
_GROUPED = {"Parallel", "Map", "FanIn"}
_FANIN = "FanIn"

# Placement-independent per-hop overhead — defined by the shared CostModel
# (queue dwell + control-plane accept + wrapper bookkeeping + the two §4.1
# checkpoint writes); kept as a module constant for callers of the old name.
HOP_OVERHEAD_MS = CostModel().hop_overhead_ms
_DEFAULT_BYTES = 4096
# Control metadata that rides every hop (JLObject wrapper, checkpoint
# records, bitmap updates) — egress-billed when the hop crosses clouds.
_CTRL_BYTES = 2048


def flavors_from_config(config: Optional[dict] = None) -> Dict[str, cal.Flavor]:
    """faas-id ("cloud/system") → Flavor, from a jointcloud config dict."""
    config = config or cal.default_jointcloud()
    out: Dict[str, cal.Flavor] = {}
    for cname, c in config["clouds"].items():
        for sysname, fl in c.get("faas", {}).items():
            out[shim.faas_id(cname, sysname)] = fl
    return out


def rtt_fn_from_config(config: Optional[dict] = None) -> Callable[[str, str], float]:
    """Cloud-pair RTT model matching ``SimCloud.rtt_ms`` (same config keys)."""
    return Topology.from_config(config).rtt_ms


@dataclass
class PlacementPlan:
    """A whole-workflow assignment plus its model-predicted objectives.

    ``assignment`` maps every function name to a FaaS system id; apply it
    with ``subgraph.apply_placement(spec, plan.overrides())`` or directly via
    ``workflow.deploy(sim, spec, plan=plan)``.  ``weight`` is the
    scalarization λ the plan was optimized under (1 = pure makespan,
    0 = pure cost) — the Pareto sweep varies it.
    """

    workflow: str
    objective: str
    assignment: Dict[str, str]
    est_makespan_ms: float
    est_cost_usd: float
    weight: float = 1.0
    failover: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    excluded_clouds: Tuple[str, ...] = ()
    # True when the plan was co-optimized with speculative prefetch: the
    # analytic model discounted overlappable read legs, so deploy it with
    # ``workflow.deploy(..., prefetch=True)`` or the predicted makespan
    # will not materialize.
    prefetch: bool = False

    def overrides(self) -> Dict[str, Dict[str, Any]]:
        """Per-node override dicts for ``subgraph.apply_placement``.

        ``memory_gb`` is reset to None so the chosen flavor's default memory
        applies — a stale per-node memory from the spec's original placement
        would misprice the new flavor.  ``failover`` is only overridden for
        nodes the plan assigned backups to (``with_failover=True``); other
        nodes keep the spec's own failover list.
        """
        out: Dict[str, Dict[str, Any]] = {}
        for n, f in self.assignment.items():
            ov: Dict[str, Any] = {"faas": f, "memory_gb": None}
            if n in self.failover:
                ov["failover"] = self.failover[n]
            out[n] = ov
        return out

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready summary (assignment, failover orders, estimates) —
        what the benchmark harnesses persist per planned arm."""
        return {"workflow": self.workflow, "objective": self.objective,
                "weight": self.weight, "assignment": dict(self.assignment),
                "failover": {k: list(v) for k, v in self.failover.items()},
                "excluded_clouds": list(self.excluded_clouds),
                "est_makespan_ms": round(self.est_makespan_ms, 3),
                "est_cost_usd": self.est_cost_usd,
                "prefetch": self.prefetch}


class _Planner:
    """Shared state for one planning problem (spec × flavors × cost model)."""

    def __init__(self, spec, flavors: Optional[Dict[str, cal.Flavor]],
                 cost_model: Optional[CostModel],
                 instances: Optional[Mapping[str, int]],
                 candidates: Optional[Mapping[str, Sequence[str]]],
                 profiles: Optional[EdgeProfiles] = None,
                 excluded_clouds: Sequence[str] = (),
                 prefetch: bool = False):
        self.spec = spec
        self.flavors = dict(flavors or flavors_from_config())
        self.cost = cost_model or CostModel()
        self.rtt = self.cost.rtt_ms
        self.profiles = profiles
        self.prefetch = bool(prefetch)
        # learned Map widths seed instance counts; explicit hints win
        self.instances = dict(profiles.instances() if profiles else {})
        self.instances.update(instances or {})
        self.excluded = frozenset(excluded_clouds)
        self.nodes = list(spec.functions)
        self.fwd = [e for e in spec.edges if not getattr(e, "back_edge", False)]
        self.in_edges: Dict[str, List] = {n: [] for n in self.nodes}
        self.out_edges: Dict[str, List] = {n: [] for n in self.nodes}
        for e in self.fwd:
            self.out_edges[e.src].append(e)
            self.in_edges[e.dst].append(e)
        self.order = self._topo_order()
        self.candidates = {}
        for n in self.nodes:
            cands = (tuple(candidates[n]) if candidates and n in candidates
                     else tuple(sorted(self.flavors)))
            if self.excluded:
                kept = tuple(f for f in cands
                             if shim.cloud_of(f) not in self.excluded)
                # a node whose every candidate lives in an excluded cloud is
                # pinned there (data residency) — it cannot move, keep it
                cands = kept or cands
            self.candidates[n] = cands
        # fan-out/fan-in groups whose indirect datastore follows the majority
        # rule: per group, (nodes voting on the ds cloud, co-placement
        # members, edges routed through the ds) — semantics mirror
        # core.subgraph (fan-out: successors vote; fan-in: peers + agg vote).
        self.groups: List[Tuple[Tuple[str, ...], Tuple[str, ...]]] = []
        self.group_of_edge: Dict[Tuple[str, str], int] = {}
        self._build_ds_groups()

    # ---- static structure -------------------------------------------------

    def _topo_order(self) -> List[str]:
        indeg = {n: 0 for n in self.nodes}
        for e in self.fwd:
            indeg[e.dst] += 1
        queue = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for e in self.out_edges[n]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    queue.append(e.dst)
        if len(order) != len(self.nodes):
            raise ValueError("forward edges contain a cycle (use .cycle())")
        return order

    def _build_ds_groups(self) -> None:
        def add(voters, members, edges) -> None:
            gi = len(self.groups)
            self.groups.append((tuple(voters), tuple(members)))
            for key in edges:
                self.group_of_edge[key] = gi

        for n in self.order:
            outs = [e for e in self.out_edges[n] if e.mode in _GROUPED
                    and e.mode != _FANIN]
            if outs:
                dsts = sorted({e.dst for e in outs})
                add(dsts, [n, *dsts], [(n, d) for d in dsts])
        fanins: Dict[str, set] = {}
        for e in self.fwd:
            if e.mode == _FANIN:
                fanins.setdefault(e.dst, set()).add(e.src)
        for dst, peers in sorted(fanins.items()):
            add([*sorted(peers), dst], [*sorted(peers), dst],
                [(p, dst) for p in peers])

    # ---- per-node models --------------------------------------------------

    def _workload(self, n: str) -> Tuple[float, float, int, bool]:
        """(compute_ms, fixed_ms, out_bytes, accel): trace-learned profiles
        take precedence over the spec's static hints (the pilot-run loop)."""
        w = self.spec.functions[n].workload
        out_bytes = getattr(w, "out_bytes", None)
        compute = float(getattr(w, "compute_ms", 0.0) or 0.0)
        fixed = float(getattr(w, "fixed_ms", 0.0) or 0.0)
        accel = bool(getattr(w, "accel", True))
        if self.profiles is not None:
            learned = self.profiles.workload(n)
            if learned is not None:
                compute, fixed, accel = learned
            lb = self.profiles.out_bytes(n)
            if lb is not None:
                out_bytes = lb
        return (compute, fixed,
                _DEFAULT_BYTES if out_bytes is None else int(out_bytes),
                accel)

    def node_cost(self, n: str, fid: str) -> Tuple[float, float]:
        """(duration_ms, exec+invoke usd) of one instance of ``n`` on ``fid``."""
        compute, fixed, _, accel = self._workload(n)
        return stage_cost(self.flavors[fid], compute, fixed, None, accel)

    # ---- evaluation (the analytic SimCloud mirror) -------------------------

    def evaluate(self, assignment: Mapping[str, str]) -> Tuple[float, float]:
        """Predicted (makespan_ms, cost_usd) of ``assignment``.

        Mirrors SimCloud's latency/billing structure through the *same*
        :class:`CostModel`: per-node flavor-scaled duration + per-hop
        overhead; direct transfers pay src→dst RTT + wire time; grouped
        (Parallel/Map/FanIn) transfers route through the majority-rule
        datastore and pay both legs; egress is billed on every cross-cloud
        leg.  Width-aware: a Map target of width *k* runs *k* parallel
        instances whose invocations are issued in ``FANOUT_CHUNK``-limited
        waves (the last wave starts ``fanout_stagger_ms`` late), pays *k*×
        execution/checkpoint cost and *k*× datastore-read egress.  Choice
        arms are all assumed taken (conservative); back-edges are ignored
        (single-iteration view).
        """
        cloud = {n: shim.cloud_of(assignment[n]) for n in self.nodes}
        ds_cloud = {gi: majority_cloud([cloud[v] for v in voters])
                    for gi, (voters, _members) in enumerate(self.groups)}

        finish: Dict[str, float] = {}
        cost = 0.0
        makespan = 0.0
        uploaded = set()    # (src, group): the shared ds write is billed once
        for n in self.order:
            dur, usd = self.node_cost(n, assignment[n])
            inst = max(1, self.instances.get(n, 1))
            cost += usd * inst
            start = 0.0
            for e in self.in_edges[n]:
                p = e.src
                nbytes = self._workload(p)[2] + _CTRL_BYTES
                p_inst = max(1, self.instances.get(p, 1))
                gi = self.group_of_edge.get((p, n))
                if gi is None:          # direct async invoke, src → dst
                    hop = self.cost.transfer_ms(cloud[p], cloud[n], nbytes)
                    # parallel per-instance chains each move their own copy
                    cost += (self.cost.egress_usd(cloud[p], cloud[n], nbytes)
                             * max(p_inst, inst))
                else:                   # via the group's majority datastore,
                    # plus the §4.1/§4.3 coordination the sim really pays:
                    # the src's bitmap/checkpoint update at the ds cloud and
                    # the trigger invoke src → dst.  Parallel flows overlap
                    # in time (per-flow bandwidth), so the hop pays one
                    # transfer — but every instance's bytes are billed.
                    dsc = ds_cloud[gi]
                    hop = (self.cost.transfer_ms(cloud[p], dsc, nbytes)
                           + self.cost.transfer_ms(dsc, cloud[n], nbytes)
                           + self.rtt(cloud[p], dsc)
                           + self.rtt(cloud[p], cloud[n]))
                    if self.prefetch and dsc != cloud[n]:
                        # co-optimization with speculative pushes: an edge
                        # the prefetch pass enables (same decide_edge as the
                        # runtime, so model and mechanism cannot diverge)
                        # overlaps its ds→dst read wire with the hop's own
                        # slack (invoke overhead + fan-out stagger).  A
                        # fully-overlapped edge contributes only control
                        # time to the critical-path DP — which is what lets
                        # prefetch flip placements.  Egress cost terms are
                        # untouched: the push moves the same bytes.
                        d = pf.decide_edge(
                            self.spec, p, n, e.mode, e.transfer_by_ds,
                            cal.PAYLOAD_QUOTA.get(cloud[n],
                                                  cal.DEFAULT_PAYLOAD_QUOTA),
                            profiles=self.profiles,
                            ds_cloud=dsc, dst_cloud=cloud[n])
                        if d.enabled:
                            read_wire = self.cost.wire_ms(dsc, cloud[n],
                                                          nbytes)
                            slack = (self.cost.fanout_stagger_ms(inst)
                                     + self.cost.hop_overhead_ms)
                            hop -= read_wire - max(0.0, read_wire - slack)
                    # upload leg: each of the src's ``p_inst`` instances
                    # writes its own output once per group (a width-k Map
                    # feeding a FanIn uploads k outputs, a fan-out source
                    # uploads one shared value)
                    if cloud[p] != dsc and (p, gi) not in uploaded:
                        uploaded.add((p, gi))
                        cost += (self.cost.egress_usd(cloud[p], dsc, nbytes)
                                 * p_inst)
                    # read leg: every dst instance pulls every src-instance
                    # output (fan-in: 1 agg × k peer outputs; fan-out: k
                    # readers × 1 shared value)
                    cost += (self.cost.egress_usd(dsc, cloud[n], nbytes)
                             * p_inst * inst)
                start = max(start, finish[p] + hop)
            # wave-staggered fan-out: the critical (last) instance of a
            # width-``inst`` Map starts after its wave's invoke round
            finish[n] = (start + self.cost.fanout_stagger_ms(inst)
                         + self.cost.hop_overhead_ms + dur)
            makespan = max(makespan, finish[n])
            # checkpoint traffic: ~2 writes + 2 reads per hop (§4.1)
            cost += 2 * (cal.TABLE_WRITE_PRICE + cal.TABLE_READ_PRICE) * inst
        return makespan, cost

    # ---- optimization ------------------------------------------------------

    def _score_fn(self, weight: float) -> Callable[[Mapping[str, str]], float]:
        t_ref = max(self.evaluate(self._greedy(1.0))[0], 1e-9)
        c_ref = max(self.evaluate(self._greedy(0.0))[1], 1e-12)

        def score(assignment: Mapping[str, str]) -> float:
            t, c = self.evaluate(assignment)
            return weight * (t / t_ref) + (1.0 - weight) * (c / c_ref)

        return score

    def _greedy(self, weight: float) -> Dict[str, str]:
        """Transfer-oblivious per-stage pick (the pre-planner baseline)."""
        objective = "makespan" if weight >= 0.5 else "cost"
        out = {}
        for n in self.nodes:
            compute, fixed, _, accel = self._workload(n)
            cands = {f: self.flavors[f] for f in self.candidates[n]}
            out[n] = choose_flavor(cands, compute, fixed, objective,
                                   None, accel)[0]
        return out

    def _uniform(self, cloud: str, weight: float) -> Dict[str, str]:
        """Everything in one cloud (nodes pinned elsewhere keep their pin)."""
        objective = "makespan" if weight >= 0.5 else "cost"
        out = {}
        for n in self.nodes:
            local = [f for f in self.candidates[n] if shim.cloud_of(f) == cloud]
            pool = local or list(self.candidates[n])
            compute, fixed, _, accel = self._workload(n)
            out[n] = choose_flavor({f: self.flavors[f] for f in pool},
                                   compute, fixed, objective, None, accel)[0]
        return out

    def solve(self, weight: float, sweeps: int = 3) -> Dict[str, str]:
        score = self._score_fn(weight)
        # Multi-start: the transfer-oblivious greedy plus one all-in-cloud-c
        # init per cloud — single-node moves cannot cross the "relocate the
        # whole chain" valley that a pinned data source creates, so the
        # single-cloud basins must be seeded explicitly.
        clouds = sorted({shim.cloud_of(f) for f in self.flavors})
        inits = [self._greedy(weight)] + [self._uniform(c, weight)
                                          for c in clouds]
        best_assignment, best_score = None, float("inf")
        for assignment in inits:
            assignment = self._descend(assignment, score, sweeps)
            s = score(assignment)
            if s < best_score - 1e-12:
                best_assignment, best_score = assignment, s
        return best_assignment

    def _descend(self, assignment: Dict[str, str],
                 score: Callable[[Mapping[str, str]], float],
                 sweeps: int) -> Dict[str, str]:
        # 1. critical-path-aware DP over topological levels: commit nodes in
        #    topo order, each to the candidate minimizing the scalarized
        #    whole-plan objective given every already-committed predecessor
        #    (successors still at their previous placement — refined below).
        # 2+. coordinate descent until a sweep changes nothing.
        assignment = dict(assignment)
        for _ in range(max(1, sweeps)):
            changed = False
            for n in self.order:
                prev = assignment[n]
                best_f, best_s = prev, score(assignment)
                for f in self.candidates[n]:
                    if f == prev:
                        continue
                    trial = dict(assignment, **{n: f})
                    s = score(trial)
                    if s < best_s - 1e-12:
                        best_f, best_s = f, s
                assignment[n] = best_f
                changed |= best_f != prev
            coplaced = self._coplace(dict(assignment), score)
            changed |= coplaced != assignment   # co-placement moves must
            assignment = coplaced               # trigger another DP sweep
            if not changed:
                break
        return assignment

    def _coplace(self, assignment: Dict[str, str],
                 score: Callable[[Mapping[str, str]], float]) -> Dict[str, str]:
        """Majority-rule co-placement: pull each fan-out/fan-in minority
        member into the group's majority cloud when that lowers the score
        (Fig 11 — colocated accesses dodge both egress legs)."""
        for _voters, members in self.groups:
            m_cloud = majority_cloud([shim.cloud_of(assignment[m])
                                      for m in members])
            base = score(assignment)
            for m in members:
                if shim.cloud_of(assignment[m]) == m_cloud:
                    continue
                local = [f for f in self.candidates[m]
                         if shim.cloud_of(f) == m_cloud]
                if not local:
                    continue
                best_s, best = min(
                    (score(dict(assignment, **{m: f})), f) for f in local)
                if best_s < base - 1e-12:
                    assignment[m] = best
                    base = best_s
        return assignment

    def failover_map(self, assignment: Mapping[str, str],
                     weight: float = 1.0) -> Dict[str, Tuple[str, ...]]:
        """Ranked cross-cloud backups per node (§5.3, Fig 10).

        The *first* backup comes from an outage-aware re-plan: for each home
        cloud present in ``assignment``, the whole workflow is re-planned
        with that cloud excluded, and every node homed there gets the
        re-plan's choice — so when a cloud goes down, the failover targets
        of all its nodes form one coherent backup placement rather than
        per-node point fixes.  Remaining clouds follow, each represented by
        its fastest same-role candidate.
        """
        homes = sorted({shim.cloud_of(f) for f in assignment.values()})
        replans: Dict[str, Optional[Dict[str, str]]] = {}
        for h in homes:
            shadow = _Planner(self.spec, self.flavors, self.cost,
                              self.instances, {n: c for n, c in
                                               self.candidates.items()},
                              self.profiles, excluded_clouds={h},
                              prefetch=self.prefetch)
            # only meaningful if some candidate survives outside ``h``
            movable = any(shim.cloud_of(f) != h
                          for n in self.nodes for f in shadow.candidates[n])
            replans[h] = shadow.solve(weight) if movable else None
        out: Dict[str, Tuple[str, ...]] = {}
        for n in self.nodes:
            home = shim.cloud_of(assignment[n])
            ranked: List[str] = []
            used_clouds = {home}    # one backup per cloud: a second entry in
            # an already-listed cloud would just burn a CreateClient+Invoke
            # against the same outage before reaching a genuinely new cloud
            rp = replans.get(home)
            if rp and shim.cloud_of(rp[n]) != home:
                ranked.append(rp[n])
                used_clouds.add(shim.cloud_of(rp[n]))
            by_cloud: Dict[str, Tuple[float, str]] = {}
            for f in self.candidates[n]:
                c = shim.cloud_of(f)
                if c in used_clouds:
                    continue
                d = self.node_cost(n, f)[0]
                if c not in by_cloud or (d, f) < by_cloud[c]:
                    by_cloud[c] = (d, f)
            ranked += [f for _, f in sorted(by_cloud.values())]
            if ranked:
                out[n] = tuple(ranked)
        return out


def plan_workflow(spec, flavors: Optional[Dict[str, cal.Flavor]] = None, *,
                  objective: str = "makespan", weight: Optional[float] = None,
                  rtt_fn: Optional[Callable[[str, str], float]] = None,
                  topology: Optional[Topology] = None,
                  cost_model: Optional[CostModel] = None,
                  instances: Optional[Mapping[str, int]] = None,
                  profiles: Optional[EdgeProfiles] = None,
                  candidates: Optional[Mapping[str, Sequence[str]]] = None,
                  excluded_clouds: Sequence[str] = (),
                  with_failover: bool = False, sweeps: int = 3,
                  prefetch: bool = False) -> PlacementPlan:
    """Jointly place every node of ``spec`` on the jointcloud.

    ``objective`` ∈ {"makespan", "cost"}; ``weight`` overrides it with an
    explicit scalarization λ ∈ [0, 1] (1 = pure makespan).  ``instances``
    scales per-node cost for dynamic (Map) fan-outs whose width is known;
    ``profiles`` (an :class:`~repro_torch.core.costmodel.EdgeProfiles`) replaces
    static ``out_bytes``/duration hints with trace-learned values and seeds
    Map widths; ``candidates`` restricts per-node FaaS choices (e.g.
    data-residency).  ``excluded_clouds`` removes entire clouds from the
    search (outage-aware re-planning) — nodes pinned exclusively to an
    excluded cloud keep their pin.  ``topology``/``cost_model`` select the
    substrate model (``rtt_fn`` remains as a legacy RTT-only override).
    ``with_failover`` additionally assigns each node a *ranked* cross-cloud
    backup order derived from per-cloud outage re-plans.

    ``prefetch=True`` co-optimizes placement with speculative transfers
    (:mod:`repro_torch.core.prefetch`): edges the prefetch pass enables overlap
    their datastore read wire with per-hop slack in the analytic model, so
    a fully-overlapped edge stops contributing to the critical-path DP —
    which can flip placements that a demand-transfer model would reject
    (and re-ranks the Pareto frontier via :func:`pareto_frontier`).  Deploy
    the resulting plan with ``workflow.deploy(..., prefetch=True)``.
    """
    if objective not in ("makespan", "cost"):
        raise ValueError(f"objective must be makespan|cost, got {objective!r}")
    if weight is None:
        weight = 1.0 if objective == "makespan" else 0.0
    elif not 0.0 <= weight <= 1.0:
        raise ValueError(f"weight must be in [0, 1], got {weight!r}")
    else:
        # an explicit λ takes precedence; keep the recorded label consistent
        objective = "makespan" if weight >= 0.5 else "cost"
    if cost_model is None:
        cost_model = CostModel(topology, rtt_override=rtt_fn)
    planner = _Planner(spec, flavors, cost_model, instances, candidates,
                       profiles, excluded_clouds, prefetch=prefetch)
    assignment = planner.solve(weight, sweeps)
    mk, usd = planner.evaluate(assignment)
    failover = planner.failover_map(assignment, weight) if with_failover else {}
    return PlacementPlan(workflow=spec.name, objective=objective,
                         assignment=assignment, est_makespan_ms=mk,
                         est_cost_usd=usd, weight=weight, failover=failover,
                         excluded_clouds=tuple(sorted(excluded_clouds)),
                         prefetch=bool(prefetch))


def pareto_frontier(spec, flavors: Optional[Dict[str, cal.Flavor]] = None, *,
                    weights: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
                    **kw) -> List[PlacementPlan]:
    """Sweep the makespan↔cost scalarization; return non-dominated plans,
    sorted fastest-first.  Distinct assignments only."""
    plans: List[PlacementPlan] = []
    seen = set()
    for w in weights:
        p = plan_workflow(spec, flavors, weight=w,
                          objective="makespan" if w >= 0.5 else "cost", **kw)
        key = tuple(sorted(p.assignment.items()))
        if key not in seen:
            seen.add(key)
            plans.append(p)
    frontier = [p for p in plans
                if not any(q.est_makespan_ms <= p.est_makespan_ms
                           and q.est_cost_usd <= p.est_cost_usd and q is not p
                           and (q.est_makespan_ms < p.est_makespan_ms
                                or q.est_cost_usd < p.est_cost_usd)
                           for q in plans)]
    return sorted(frontier, key=lambda p: (p.est_makespan_ms, p.est_cost_usd))
