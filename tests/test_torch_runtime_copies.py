"""The port's copies of the JAX package's runtime modules (``core/traffic``,
``core/shard``, ``baselines/*``) against the originals: the same inputs
give the same results, bit for bit.  ``test_torch_port_hygiene.py`` holds
each copy to the original's text with ``repro.`` rewritten; this file holds
what the copies do on each package's own classes (its SimCloud, its
WorkflowSpec), so a copy that drifted from the classes it imports would
show here."""

import dataclasses
import functools
import importlib
from types import SimpleNamespace

import pytest

MODULES = {"traffic": "core.traffic", "shard": "core.shard", "wf": "core.workflow",
           "sg": "core.subgraph", "costmodel": "core.costmodel", "sim": "backends.simcloud",
           "cal": "backends.calibration", "sm": "baselines.statemachine",
           "xafcl": "baselines.xafcl", "xfaas": "baselines.xfaas",
           "lithops": "baselines.lithops", "baselines": "baselines"}
PKGS = ("repro", "repro_torch")


def _pkg(name: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{name}.{m}")
                              for k, m in MODULES.items()})


P = {name: _pkg(name) for name in PKGS}

AWS = "aws/lambda"
ALI = "aliyun/fc"


def _both(fn):
    """``fn(package)`` on the reference and on the port: (reference, port)."""
    return fn(P["repro"]), fn(P["repro_torch"])


# ==========================================================================
# Arrival schedules
# ==========================================================================


def _arrivals(schedule):
    return [(a.t_ms, a.stream) for a in schedule], dict(schedule.meta)


SCHEDULES = {
    "poisson": lambda t: t.PoissonProcess(30.0, seed=123).schedule(200, streams=4),
    "poisson-1": lambda t: t.PoissonProcess(1.0, seed=0).schedule(8),
    "uniform": lambda t: t.UniformProcess(25.0, start_ms=3.0).schedule(40, streams=3),
    "split": lambda t: t.PoissonProcess(10.0, seed=5).schedule(37, streams=2).split(3),
    "round-trip": lambda t: t.ArrivalSchedule.from_dict(
        t.PoissonProcess(10.0, seed=3).schedule(20, streams=3).as_dict()),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedules_equal(case):
    def run(p):
        out = SCHEDULES[case](p.traffic)
        parts = out if isinstance(out, list) else [out]
        return [_arrivals(s) for s in parts], [s.offered_rate_wf_s() for s in parts]
    ref, port = _both(run)
    assert port == ref


# ==========================================================================
# LoadRunner on SimCloud
# ==========================================================================


def _tiny_spec(p, name="traffic-ab"):
    spec = p.sg.WorkflowSpec(name, gc=False)
    spec.function("a", AWS, workload=p.sim.Workload(fixed_ms=1.0, fn=lambda x: x + 1))
    spec.function("b", ALI, workload=p.sim.Workload(fixed_ms=1.0, fn=lambda x: x * 2))
    spec.sequence("a", "b")
    return spec


@pytest.mark.parametrize("contended", [False, True])
def test_load_point_equal(contended):
    def run(p):
        cfg = p.cal.contended_jointcloud() if contended else None
        sim = p.sim.SimCloud(cfg, seed=0) if cfg else p.sim.SimCloud(seed=0)
        dep = p.wf.deploy(sim, _tiny_spec(p))
        load = p.traffic.LoadRunner([dep], input_value=1)
        point = load.offered(p.traffic.PoissonProcess(20.0, seed=11).schedule(25))
        return dataclasses.asdict(point), point.throughput_wf_s, point.as_dict()
    ref, port = _both(run)
    assert port == ref
    assert port[0]["completed"] == 25 and port[0]["dropped"] == 0


# ==========================================================================
# Drift detection
# ==========================================================================


DRIFT_CASES = {     # node -> (out_bytes, compute_ms, samples) of the live window
    "bytes": {"sort": (4_000_000, 400.0, 10)},
    "in-band": {"sort": (44_000, 430.0, 10)},
    "few-samples": {"sort": (4_000_000, 400.0, 2)},
    "small-bytes": {"qa": (19, 1500.0, 10)},
    "compute": {"f": (0, 300.0, 10), "sort": (40_000, 400.0, 10)},
}


@pytest.mark.parametrize("case", sorted(DRIFT_CASES))
def test_drift_detector_same_report(case):
    def run(p):
        base = {n: p.costmodel.NodeProfile(name=n, out_bytes=ob, compute_ms=cms,
                                           fixed_ms=0.0, accel=False)
                for n, (ob, cms) in {"sort": (40_000, 400.0), "qa": (64, 1500.0),
                                     "f": (0, 100.0)}.items()}
        live = p.costmodel.EdgeProfiles({
            n: p.costmodel.NodeProfile(name=n, out_bytes=ob, compute_ms=cms, fixed_ms=0.0,
                                       accel=False, samples=s)
            for n, (ob, cms, s) in DRIFT_CASES[case].items()})
        det = p.traffic.DriftDetector(base)
        first = det.check(live)
        det.rebase(live)
        again = det.check(live)
        spec_det = p.traffic.DriftDetector.from_spec(_tiny_spec(p))
        return ((dict(first.drifted), first.checked, bool(first)),
                (dict(again.drifted), again.checked),
                {n: dataclasses.asdict(b) for n, b in spec_det.baseline.items()})
    ref, port = _both(run)
    assert port == ref


# ==========================================================================
# Sharded simulation
# ==========================================================================
#
# Builders and the backend factory cross into forked shard workers by
# reference, so they are module-level functions bound with partial.


def _seq_spec(pkg):
    p = P[pkg]
    spec = p.sg.WorkflowSpec("shard-seq", gc=False)
    spec.function("a", AWS, workload=p.sim.Workload(fixed_ms=4.0, fn=lambda x: x + 1))
    spec.function("b", ALI, workload=p.sim.Workload(fixed_ms=6.0, fn=lambda x: x * 2))
    spec.sequence("a", "b")
    return spec


def _fan_spec(pkg):
    p = P[pkg]
    spec = p.sg.WorkflowSpec("shard-fan", gc=False)
    spec.function("s", ALI, workload=p.sim.Workload(fixed_ms=3.0, fn=lambda x: x))
    spec.function("l", AWS, workload=p.sim.Workload(fixed_ms=5.0, fn=lambda x: x + 10))
    spec.function("r", ALI, workload=p.sim.Workload(fixed_ms=7.0, fn=lambda x: x + 20))
    spec.fanout("s", ["l", "r"])
    return spec


def _sim(pkg, seed):
    return P[pkg].sim.SimCloud(seed=seed)


@pytest.mark.parametrize("shards", [1, 2])
def test_run_sharded_merges_to_the_same_statistics(shards):
    def run(p):
        pkg = p.traffic.__name__.split(".")[0]
        builders = (functools.partial(_seq_spec, pkg), functools.partial(_fan_spec, pkg))
        schedule = p.traffic.PoissonProcess(40.0, seed=123).schedule(60, streams=2)
        point, stats = p.shard.run_sharded(builders, functools.partial(_sim, pkg), schedule,
                                           shards=shards, base_seed=42, input_value=1)
        per_shard = [{k: v for k, v in s.items() if k != "engine_wall_s"}
                     for s in stats["per_shard"]]
        return (dataclasses.asdict(point),
                {k: stats[k] for k in ("shards", "events", "cold_starts")}, per_shard)
    ref, port = _both(run)
    assert port == ref
    assert port[0]["completed"] == 60 and port[1]["shards"] == shards


# ==========================================================================
# The baseline orchestrators
# ==========================================================================


def _records(sim, run=None):
    """Every record of ``sim`` (a run's id replaced: each package numbers
    its runs itself), the bill and its counters."""
    def name(f):
        return f.replace(run, "RUN") if run else f
    recs = [(name(r.function), r.faas, r.status, r.t_queued, r.t_start, r.t_end,
             repr(r.result)) for r in sim.records]
    return recs, sim.bill.breakdown(), dict(sim.bill.counters)


def _diamond(p, cloud_fn):
    spec = p.sg.WorkflowSpec("d", gc=False)
    W = p.sim.Workload
    spec.function("a", cloud_fn(0), workload=W(fn=lambda x: x + 1))
    spec.function("b", cloud_fn(1), workload=W(fn=lambda x: x * 2))
    spec.function("c", cloud_fn(2), workload=W(fn=lambda x: x * 3))
    spec.function("d", cloud_fn(3), workload=W(fn=lambda xs: sum(xs)))
    spec.fanout("a", ["b", "c"])
    spec.fanin(["b", "c"], "d")
    return spec


def _statemachine(p):
    sim = p.sim.SimCloud(seed=0)
    orch = p.sm.StateMachineOrchestrator(sim, _diamond(p, lambda i: AWS), cloud="aws")
    run = orch.start(5)
    sim.run()
    return orch.makespan_ms(run), _records(sim, run)


def _xafcl(p):
    spec = p.sg.WorkflowSpec("mc", gc=False)
    W = p.sim.Workload
    spec.function("m", AWS, workload=W(fn=lambda n: list(range(n))))
    spec.function("w", ALI, workload=W(fn=lambda x: x * x))
    spec.function("agg", AWS, workload=W(fn=sum))
    spec.map("m", "w")
    spec.fanin(["w"], "agg")
    sim = p.sim.SimCloud(seed=0)
    orch = p.xafcl.XAFCLOrchestrator(sim, spec, orch_cloud="aws")
    run = orch.start(5)
    sim.run()
    makespan = orch.makespan_ms(run)
    orch.charge_vms(makespan)
    return makespan, _records(sim, run)


def _xfaas(p):
    sim = p.sim.SimCloud(seed=0)
    W = p.sim.Workload
    run = p.xfaas.run_xfaas_sequence(sim, [(AWS, W(fn=lambda x: x + 1)),
                                           (ALI, W(fn=lambda x: x * 2))], 3)
    sim.run()
    return p.xfaas.xfaas_makespan_ms(sim, run), _records(sim, run)


def _lithops(p):
    sim = p.sim.SimCloud(seed=0)
    W = p.sim.Workload
    run = p.lithops.run_lithops_map(sim, ALI, W(fn=lambda x: x * 2), 4,
                                    agg=W(fn=lambda xs: sum(xs)))
    sim.run()
    makespan = p.lithops.lithops_makespan_ms(sim, run)
    p.lithops.charge_driver_vm(sim, makespan)
    return makespan, _records(sim, run)


BASELINES = {"statemachine": _statemachine, "xafcl": _xafcl, "xfaas": _xfaas,
             "lithops": _lithops}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_gives_the_same_makespan_and_bill(name):
    ref, port = _both(BASELINES[name])
    assert port == ref
    makespan, (recs, bill, _) = port
    assert makespan > 0 and recs and bill["total"] > 0


def test_baselines_package_exports_the_same_names():
    ref, port = _both(lambda p: sorted(n for n in vars(p.baselines) if not n.startswith("_")))
    assert port == ref
