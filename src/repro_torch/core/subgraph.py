"""Workflow IR and the sub-graph compiler (paper §3.3, Figs 5–6).

Users define a workflow as a DAG of functions plus *invocation primitives*
(Sequence, Parallel, Map, Fan-In, Choice, Cycle, ByBatch, ByRedundant) and
*transfer primitives* (TransferByDs, Ds).  The compiler lowers the global
graph into **per-function local sub-graphs** (:class:`NodeView`): the
function-side orchestrator only ever sees its own node's view — there is no
global graph at runtime, exactly as in the paper.

The compiler also performs the static analyses the runtime leans on:
  * topological *levels* (longest path) — the static ``step`` of every node,
    so fan-in peers agree on the aggregator's step without coordination;
  * fan-out *depths* — the length of the static branch-stack prefix, which
    makes PopAndMerge and the shared bitmap key locally derivable;
  * **majority-rule datastore placement** (§4.3.1) for indirect transfers and
    coordination points;
  * GC targets: every datastore the workflow touches, grouped per cloud.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.backends import calibration as cal
from repro_torch.backends import shim
from repro_torch.core import naming
from repro_torch.core.placement import majority_cloud

# Invocation primitive names (Fig 5/6)
SEQUENCE = "Sequence"
PARALLEL = "Parallel"
MAP = "Map"
FANIN = "FanIn"
CHOICE = "Choice"
CYCLE = "Cycle"
BY_BATCH = "ByBatch"
BY_REDUNDANT = "ByRedundant"

GC_FUNCTION = "__gc__"


# ==========================================================================
# Catalog — what storage/compute exists where (resolved from the backend)
# ==========================================================================


@dataclass
class Catalog:
    """Per-cloud service directory used for placement decisions."""

    tables: Dict[str, str]            # cloud -> table-store id
    objects: Dict[str, str]           # cloud -> object-store id
    quotas: Dict[str, int]            # cloud -> async payload quota (bytes)
    gc_faas: Dict[str, str]           # cloud -> FaaS system hosting the GC fn

    @staticmethod
    def from_config(config: Optional[dict] = None) -> "Catalog":
        config = config or cal.default_jointcloud()
        tables, objects, quotas, gc_faas = {}, {}, {}, {}
        for cname, c in config["clouds"].items():
            if c.get("tables"):
                tables[cname] = shim.ds_id(cname, c["tables"][0])
            if c.get("objects"):
                objects[cname] = shim.ds_id(cname, c["objects"][0])
            quotas[cname] = cal.PAYLOAD_QUOTA.get(cname, cal.DEFAULT_PAYLOAD_QUOTA)
            if c.get("faas"):
                # GC runs on the cheapest (first/CPU) system of each cloud
                gc_faas[cname] = shim.faas_id(cname, next(iter(c["faas"])))
        return Catalog(tables, objects, quotas, gc_faas)

    def store(self, cloud: str, kind: str) -> str:
        return (self.tables if kind == "table" else self.objects)[cloud]

    def quota(self, faas: str) -> int:
        return self.quotas.get(shim.cloud_of(faas), cal.DEFAULT_PAYLOAD_QUOTA)


# ==========================================================================
# User-facing workflow spec
# ==========================================================================


@dataclass
class FunctionSpec:
    """A logical workflow function and where it (and its backups) deploy."""

    name: str
    faas: str
    failover: Tuple[str, ...] = ()
    memory_gb: Optional[float] = None
    output_store_kind: str = "table"   # "Ds" primitive: table | object
    # execution payload: SimCloud Workload or a real callable (localjax)
    workload: Any = None
    # declarative suspension points (run before the user function; zero
    # concurrency slots while suspended — see shim.Sleep/WaitForSignal)
    sleep_ms: float = 0.0
    wait_signal: str = ""

    @property
    def cloud(self) -> str:
        return shim.cloud_of(self.faas)


@dataclass
class Edge:
    src: str
    dst: str
    mode: str
    predicate: Optional[Callable[[Any], bool]] = None   # Choice / Cycle guard
    transfer_by_ds: Optional[bool] = None                # None = auto by size
    ds_kind: str = "table"                               # indirect store kind
    replicas: Tuple[str, ...] = ()                       # ByRedundant targets
    batch_size: int = 0                                  # ByBatch
    back_edge: bool = False                              # Cycle


class WorkflowSpec:
    """Builder for the logical DAG (what the developer writes)."""

    def __init__(self, name: str, *, gc: bool = True):
        self.name = name
        self.gc_enabled = gc
        self.functions: Dict[str, FunctionSpec] = {}
        self.edges: List[Edge] = []
        self.entry: Optional[str] = None

    # ---- functions -------------------------------------------------------

    def function(self, name: str, faas: str, *, failover: Sequence[str] = (),
                 memory_gb: Optional[float] = None, workload: Any = None,
                 output_store_kind: str = "table", entry: bool = False,
                 sleep_ms: float = 0.0, wait_signal: str = "") -> str:
        if name in self.functions:
            raise ValueError(f"duplicate function {name}")
        self.functions[name] = FunctionSpec(
            name, faas, tuple(failover), memory_gb, output_store_kind, workload,
            sleep_ms, wait_signal)
        if entry or self.entry is None:
            self.entry = name
        return name

    # ---- invocation primitives (Fig 5/6) ------------------------------------

    def sequence(self, src: str, dst: str, **kw) -> None:
        self.edges.append(Edge(src, dst, SEQUENCE, **kw))

    def fanout(self, src: str, dsts: Sequence[str], **kw) -> None:
        for d in dsts:
            self.edges.append(Edge(src, d, PARALLEL, **kw))

    def map(self, src: str, dst: str, **kw) -> None:
        """Dynamic fan-out: one ``dst`` invocation per element of src's output list."""
        self.edges.append(Edge(src, dst, MAP, **kw))

    def fanin(self, srcs: Sequence[str], dst: str, **kw) -> None:
        for s in srcs:
            self.edges.append(Edge(s, dst, FANIN, **kw))

    def choice(self, src: str, arms: Sequence[Tuple[Optional[Callable], str]], **kw) -> None:
        """Conditional invocation; first arm whose predicate holds wins
        (``None`` predicate = default arm)."""
        for pred, dst in arms:
            self.edges.append(Edge(src, dst, CHOICE, predicate=pred, **kw))

    def cycle(self, tail: str, head: str, while_pred: Callable[[Any], bool], **kw) -> None:
        """Back-edge tail→head taken while ``while_pred(output)`` holds."""
        self.edges.append(Edge(tail, head, CYCLE, predicate=while_pred,
                               back_edge=True, **kw))

    def redundant(self, src: str, dst: str, replicas: Sequence[str], **kw) -> None:
        """ByRedundant: race ``dst`` on several FaaS systems (straggler
        mitigation); duplicates collapse through the §4.1 checkpoints."""
        self.edges.append(Edge(src, dst, BY_REDUNDANT, replicas=tuple(replicas), **kw))

    def batch(self, src: str, dst: str, batch_size: int, **kw) -> None:
        """ByBatch: invoke ``dst`` once every ``batch_size`` completions of
        ``src`` *across workflow instances* (§3.3 time/space collaboration)."""
        self.edges.append(Edge(src, dst, BY_BATCH, batch_size=batch_size, **kw))


# ==========================================================================
# Compiled, per-function views
# ==========================================================================


@dataclass(frozen=True)
class PeerRef:
    """Static identity of one fan-in peer (lets any peer reconstruct every
    peer's output key without communication)."""

    name: str
    step: int
    rel_stack: Tuple[int, ...]   # branch indices below the aggregator depth


@dataclass
class FanInInfo:
    agg_name: str
    agg_faas: str
    agg_failover: Tuple[str, ...]
    agg_step: int
    agg_depth: int
    ds: str                       # majority-rule datastore for peer outputs
    table: str                    # coordination (bitmap) table
    size: Optional[int]           # None ⇒ dynamic (map) fan-in
    peers: Tuple[PeerRef, ...]    # static case
    my_index: int = -1            # this node's bitmap slot (static case)
    quota: int = cal.DEFAULT_PAYLOAD_QUOTA
    # prefetch directive (core.prefetch.annotate_views): predicted wire size
    # of this peer's output, >0 ⇒ push it toward the aggregator's cloud as
    # soon as the output checkpoint commits.  0 (default) is inert.
    prefetch_bytes: int = 0


@dataclass
class NextFunctionInfo:
    """Metadata for one subsequent function (paper Fig 4)."""

    name: str
    faas: str
    failover: Tuple[str, ...]
    mode: str
    step: int
    depth: int
    quota: int
    transfer_by_ds: Optional[bool] = None
    ds: str = ""                          # indirect-transfer datastore
    table: str = ""                       # collaboration table (ByBatch/Redundant)
    fanin: Optional[FanInInfo] = None
    predicate: Optional[Callable[[Any], bool]] = None
    replicas: Tuple[str, ...] = ()
    batch_size: int = 0
    back_edge: bool = False
    # prefetch directive (core.prefetch.annotate_views): predicted wire size
    # of the upstream output, >0 ⇒ the producer speculatively pushes it
    # toward this successor's cloud right after committing the indirect
    # transfer.  0 (default) is inert — the orchestrator yields no Prefetch.
    prefetch_bytes: int = 0


@dataclass
class GcTarget:
    faas: str                      # GC function deployment
    stores: Tuple[str, ...]        # datastores in that cloud to sweep


@dataclass
class NodeView:
    """The local sub-graph a deployed function sees at runtime.

    This is the *entire* knowledge of the function-side orchestrator — no
    global DAG is reachable from here (asserted by tests).
    """

    workflow: str
    name: str
    faas: str
    failover: Tuple[str, ...]
    level: int
    depth: int
    is_entry: bool
    home_table: str                # ivk checkpoints (cloud where fn resides)
    output_ds: str                 # output data checkpoints
    next_funcs: Tuple[NextFunctionInfo, ...]
    fanin: Optional[FanInInfo]     # set if this node *feeds* a fan-in
    gc: Tuple[GcTarget, ...] = ()  # terminal nodes trigger these
    gc_enabled: bool = True
    # durable execution (see repro_torch.core.durable): journal every effect
    durable: bool = False
    # declarative suspension points, copied from the FunctionSpec
    sleep_ms: float = 0.0
    wait_signal: str = ""

    @property
    def is_terminal(self) -> bool:
        return not self.next_funcs and self.fanin is None


# ==========================================================================
# Compiler
# ==========================================================================


class WorkflowCompileError(Exception):
    pass


def apply_placement(spec: WorkflowSpec,
                    overrides: Dict[str, Dict[str, Any]]) -> WorkflowSpec:
    """Copy of ``spec`` with per-node ``faas``/``failover``/``memory_gb``
    overridden — the hook a :class:`repro_torch.core.placement.PlacementPlan`
    (or any hand-written placement) applies through.  Edges, workloads and
    the entry point are shared; only FunctionSpecs are rebuilt."""
    unknown = set(overrides) - set(spec.functions)
    if unknown:
        raise WorkflowCompileError(
            f"placement overrides reference unknown functions {sorted(unknown)}")
    out = WorkflowSpec(spec.name, gc=spec.gc_enabled)
    out.edges = list(spec.edges)
    out.entry = spec.entry
    for name, f in spec.functions.items():
        ov = overrides.get(name, {})
        faas = ov.get("faas", f.faas)
        # failover is an *order* (ranked backups, §4.2): preserve ranking,
        # drop duplicates and the primary itself (a re-planned primary may
        # coincide with a previously-listed backup)
        failover = tuple(dict.fromkeys(
            b for b in ov.get("failover", f.failover) if b != faas))
        out.functions[name] = FunctionSpec(
            name=name,
            faas=faas,
            failover=failover,
            memory_gb=ov["memory_gb"] if "memory_gb" in ov else f.memory_gb,
            output_store_kind=f.output_store_kind,
            workload=f.workload,
            sleep_ms=f.sleep_ms,
            wait_signal=f.wait_signal)
    return out


def compile_workflow(spec: WorkflowSpec, catalog: Catalog,
                     overrides: Optional[Dict[str, Dict[str, Any]]] = None
                     ) -> Dict[str, NodeView]:
    """Lower the global DAG into per-function local sub-graphs.

    ``overrides`` (optional) re-places nodes via :func:`apply_placement`
    before compilation."""
    if overrides:
        spec = apply_placement(spec, overrides)
    if spec.entry is None:
        raise WorkflowCompileError("workflow has no entry function")
    fns = spec.functions
    fwd = [e for e in spec.edges if not e.back_edge]
    for e in spec.edges:
        for endpoint in (e.src, e.dst):
            if endpoint not in fns:
                raise WorkflowCompileError(f"edge references unknown function {endpoint}")

    out_edges: Dict[str, List[Edge]] = {n: [] for n in fns}
    in_edges: Dict[str, List[Edge]] = {n: [] for n in fns}
    for e in fwd:
        out_edges[e.src].append(e)
        in_edges[e.dst].append(e)

    levels = _longest_path_levels(spec, fwd, out_edges, in_edges)
    depths, branch_paths = _depths_and_paths(spec, fwd, out_edges, levels)
    fanin_groups = _fanin_groups(spec, fwd, fns, levels, depths, branch_paths, catalog)

    # datastores each cloud contributes (for GC)
    used_stores: Dict[str, set] = {}

    def note_store(ds: str) -> None:
        used_stores.setdefault(shim.cloud_of(ds), set()).add(ds)

    views: Dict[str, NodeView] = {}
    for name, f in fns.items():
        home_table = catalog.store(f.cloud, "table")
        note_store(home_table)

        # ---- next-function infos -----------------------------------------
        nexts: List[NextFunctionInfo] = []
        my_fanin: Optional[FanInInfo] = None
        for e in out_edges[name] + [e for e in spec.edges if e.back_edge and e.src == name]:
            t = fns[e.dst]
            quota = min([catalog.quota(t.faas)] + [catalog.quota(b) for b in t.failover])
            if e.mode == FANIN:
                fi = fanin_groups[e.dst]
                my_fanin = FanInInfo(**{**fi.__dict__,
                                        "my_index": _peer_index(fi, name, branch_paths),
                                        "quota": quota})
                note_store(my_fanin.ds)
                note_store(my_fanin.table)
                continue
            if e.mode == BY_REDUNDANT and not e.replicas:
                raise WorkflowCompileError(f"ByRedundant edge {e.src}->{e.dst} needs replicas")
            # indirect-transfer datastore: majority rule over the sub-graph's
            # clouds (source + all successors of this fan-out level)
            group_clouds = [f.cloud] + [fns[x.dst].cloud for x in out_edges[name]]
            m_cloud = majority_cloud(group_clouds[1:]) or f.cloud
            ds = catalog.store(m_cloud, e.ds_kind)
            note_store(ds)
            collab_table = catalog.store(t.cloud, "table")
            note_store(collab_table)
            nexts.append(NextFunctionInfo(
                name=t.name, faas=t.faas, failover=t.failover, mode=e.mode,
                step=levels[e.dst] if not e.back_edge else levels[e.dst],
                depth=depths[e.dst], quota=quota,
                transfer_by_ds=e.transfer_by_ds, ds=ds, table=collab_table,
                predicate=e.predicate,
                replicas=e.replicas or (t.faas,) + t.failover,
                batch_size=e.batch_size, back_edge=e.back_edge,
            ))

        # ---- output checkpoint placement ------------------------------------
        # priority: fan-in group ds (peers must colocate) > majority ds of an
        # indirect fan-out > home-cloud store of the declared kind (§4.3.1)
        if my_fanin is not None:
            output_ds = my_fanin.ds
        elif any(n.mode in (PARALLEL, MAP) for n in nexts):
            output_ds = nexts[0].ds
        else:
            output_ds = catalog.store(f.cloud, f.output_store_kind)
        note_store(output_ds)

        views[name] = NodeView(
            workflow=spec.name, name=name, faas=f.faas, failover=f.failover,
            level=levels[name], depth=depths[name], is_entry=(name == spec.entry),
            home_table=home_table, output_ds=output_ds,
            next_funcs=tuple(nexts), fanin=my_fanin, gc_enabled=spec.gc_enabled,
            sleep_ms=f.sleep_ms, wait_signal=f.wait_signal,
        )

    # ---- GC wiring (terminal nodes trigger per-cloud sweeps, §4.4) -----------
    gc_targets = tuple(
        GcTarget(faas=catalog.gc_faas[cloud], stores=tuple(sorted(stores)))
        for cloud, stores in sorted(used_stores.items())
        if cloud in catalog.gc_faas)
    for v in views.values():
        if v.is_terminal:
            v.gc = gc_targets
    return views


# ---- analyses ---------------------------------------------------------------


def _longest_path_levels(spec, fwd, out_edges, in_edges) -> Dict[str, int]:
    indeg = {n: 0 for n in spec.functions}
    for e in fwd:
        indeg[e.dst] += 1
    roots = [n for n, d in indeg.items() if d == 0]
    if spec.entry not in roots:
        raise WorkflowCompileError("entry function has incoming forward edges")
    levels = {n: 0 for n in roots}
    order: List[str] = []
    queue = list(roots)
    seen_edges = 0
    while queue:
        n = queue.pop()
        order.append(n)
        for e in out_edges[n]:
            seen_edges += 1
            levels[e.dst] = max(levels.get(e.dst, 0), levels[n] + 1)
            indeg[e.dst] -= 1
            if indeg[e.dst] == 0:
                queue.append(e.dst)
    if seen_edges != len(fwd):
        raise WorkflowCompileError("forward edges contain a cycle "
                                   "(use .cycle() for loops)")
    return levels


def _depths_and_paths(spec, fwd, out_edges, levels):
    """Static fan-out depth and branch path per node.

    ``branch_paths[n]`` is a tuple of per-level entries: an int for a static
    Parallel index, ``None`` for a dynamic Map level.
    """
    depths: Dict[str, int] = {spec.entry: 0}
    paths: Dict[str, Tuple] = {spec.entry: ()}
    # process in topological (level) order
    for n in sorted(spec.functions, key=lambda x: levels.get(x, 0)):
        if n not in depths:
            # non-entry root (only reachable via back-edge targets etc.)
            depths[n] = 0
            paths[n] = ()
        par_edges = [e for e in out_edges[n] if e.mode == PARALLEL]
        for i, e in enumerate(par_edges):
            _assign(depths, paths, e.dst, depths[n] + 1, paths[n] + (i,))
        for e in out_edges[n]:
            if e.mode == MAP:
                _assign(depths, paths, e.dst, depths[n] + 1, paths[n] + (None,))
            elif e.mode == FANIN:
                d = max(0, depths[n] - 1)
                _assign(depths, paths, e.dst, d, paths[n][:d])
            elif e.mode in (SEQUENCE, CHOICE, BY_BATCH, BY_REDUNDANT):
                _assign(depths, paths, e.dst, depths[n], paths[n])
    return depths, paths


def _assign(depths, paths, node, depth, path):
    if node in depths and depths[node] != depth:
        # diamond joining different depths: keep the shallower (fan-in wins)
        if depth < depths[node]:
            depths[node], paths[node] = depth, path
        return
    depths[node] = depth
    paths[node] = path


def _fanin_groups(spec, fwd, fns, levels, depths, branch_paths, catalog) -> Dict[str, FanInInfo]:
    groups: Dict[str, List[Edge]] = {}
    for e in fwd:
        if e.mode == FANIN:
            groups.setdefault(e.dst, []).append(e)
    out: Dict[str, FanInInfo] = {}
    for dst, edges in groups.items():
        t = fns[dst]
        peers = [e.src for e in edges]
        agg_depth = depths[dst]
        dynamic = any(None in branch_paths[p][agg_depth:] for p in peers)
        clouds = [fns[p].cloud for p in peers] + [t.cloud]
        m_cloud = majority_cloud(clouds) or t.cloud
        ds_kind = edges[0].ds_kind
        peer_refs: Tuple[PeerRef, ...] = ()
        size: Optional[int] = None
        if not dynamic:
            peer_refs = tuple(
                PeerRef(p, levels[p], tuple(branch_paths[p][agg_depth:]))
                for p in sorted(peers, key=lambda p: (branch_paths[p], p)))
            size = len(peer_refs)
        elif len(set(fns[p].name for p in peers)) != 1:
            raise WorkflowCompileError(
                f"dynamic (map) fan-in into {dst} must have a single peer function")
        out[dst] = FanInInfo(
            agg_name=dst, agg_faas=t.faas, agg_failover=t.failover,
            agg_step=levels[dst], agg_depth=agg_depth,
            ds=catalog.store(m_cloud, ds_kind),
            table=catalog.store(m_cloud, "table"),
            size=size, peers=peer_refs)
    return out


def _peer_index(fi: FanInInfo, name: str, branch_paths) -> int:
    if fi.size is None:
        return -1   # dynamic: runtime uses the map branch index
    for i, p in enumerate(fi.peers):
        if p.name == name:
            return i
    raise WorkflowCompileError(f"{name} is not a peer of fan-in {fi.agg_name}")
