"""The port's copy of the multi-process RemoteRunner against the JAX
package's: the value-level paper workflows give the same terminal values on
both, the durable idiom (interrupt, then a fresh runner over the same store
that ``resume()``s) holds exactly-once on both, and the port's serve
workflow runs on the port's RemoteRunner in forked CPU workers, an ``aws``
worker killed with SIGKILL mid-race, with the reference's greedy tokens."""

import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.backends import remote as jremote  # noqa: E402
from repro.backends import shim as jshim  # noqa: E402
from repro.core import subgraph as jsg  # noqa: E402
from repro.core import workflow as jwf  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import greedy_generate as jgreedy  # noqa: E402
from repro_torch.backends import remote  # noqa: E402
from repro_torch.backends import shim  # noqa: E402
from repro_torch.core import subgraph as sg  # noqa: E402
from repro_torch.core import workflow as wf  # noqa: E402
from repro_torch.serve import workflow  # noqa: E402

from conftest import FileCalls  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_remote_worker.py")

#: each package's WorkflowSpec, Workload, deploy and RemoteRunner
PKGS = {"repro": (jsg.WorkflowSpec, jshim.Workload, jwf.deploy, jremote.RemoteRunner),
        "repro_torch": (sg.WorkflowSpec, shim.Workload, wf.deploy, remote.RemoteRunner)}


def _value_spec(name, WorkflowSpec, Workload):
    """``benchmarks/run.py``'s value-level diamond and pipeline (pure-python
    user functions, safe in forked workers): (spec, terminal, expected)."""
    if name == "diamond":
        spec = WorkflowSpec("r-diamond", gc=False)
        spec.function("a", "aws/lambda", workload=Workload(fn=lambda x: x))
        for i, f in enumerate(["b", "c", "d"]):
            spec.function(f, "aliyun/fc" if i % 2 else "aws/lambda",
                          workload=Workload(fn=lambda x, i=i: x + i))
        spec.function("agg", "aliyun/fc", workload=Workload(fn=lambda xs: sum(xs)))
        spec.fanout("a", ["b", "c", "d"])
        spec.fanin(["b", "c", "d"], "agg")
        return spec, "agg", lambda v: 3 * v + 3
    spec = WorkflowSpec("r-pipe", gc=True)
    spec.function("a", "aws/lambda", workload=Workload(fn=lambda x: x + 1))
    spec.function("b", "aliyun/fc", workload=Workload(fn=lambda x: x * 2))
    spec.function("c", "aws/lambda", workload=Workload(fn=lambda x: x - 3))
    spec.sequence("a", "b")
    spec.sequence("b", "c")
    return spec, "c", lambda v: (v + 1) * 2 - 3


@pytest.mark.parametrize("name", ["diamond", "pipeline"])
def test_value_workflows_equal_on_both_remote_runners(name):
    out = {}
    for pkg, (WorkflowSpec, Workload, deploy, RemoteRunner) in PKGS.items():
        spec, terminal, expected = _value_spec(name, WorkflowSpec, Workload)
        runner = RemoteRunner(workers=2, poll_ms=5.0)
        try:
            dep = deploy(runner, spec)
            wids = [dep.start(v) for v in (1, 4)]
            runner.run(timeout_s=60.0)
            out[pkg] = {
                "values": [dep.result_of(w, terminal) for w in wids],
                "done": [Counter(r.function for r in dep.executions(w) if r.status == "done")
                         for w in wids],
                "dropped": len(runner.dropped)}
        finally:
            runner.close()
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"]["values"] == [expected(1), expected(4)]
    for done in out["repro_torch"]["done"]:
        assert set(done.values()) == {1}, done      # each function completed once
    assert out["repro_torch"]["dropped"] == 0


def _two_stage(calls, WorkflowSpec, Workload):
    """a (×2) → b (+10), b's user executions appended to ``calls``."""
    spec = WorkflowSpec("dur", gc=False)
    spec.function("a", "aws/lambda", workload=Workload(fn=lambda e: e * 2))
    spec.function("b", "aliyun/fc",
                  workload=Workload(fn=lambda e: calls.append(e) or e + 10))
    spec.sequence("a", "b")
    return spec


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_durable_resume_is_exactly_once(pkg, tmp_path):
    """A durable run interrupted by a crash policy that exhausts the retry
    budget, then a fresh RemoteRunner over the same store directory that
    ``resume()``s it: b's user function ran once across both lives, and a
    third runner finds nothing left to resume."""
    WorkflowSpec, Workload, deploy, RemoteRunner = PKGS[pkg]
    calls = FileCalls(os.path.join(str(tmp_path), "calls.log"))
    old = RemoteRunner(max_requeues=1, retry_backoff_ms=5.0, poll_ms=5.0)
    try:
        dep = deploy(old, _two_stage(calls, WorkflowSpec, Workload), durable=True)
        old.crash_policy = (lambda ex, eff:
                            ex.record.function == "b" and ex.effect_index >= 4)
        wid = dep.start(3, workflow_id="dur-000000")
        old.run(timeout_s=60.0)
        old.crash_policy = None
        assert old.dropped and dep.result_of(wid, "b") is None
        fresh = RemoteRunner(store_dir=old.store_dir, poll_ms=5.0)
        dep = deploy(fresh, _two_stage(calls, WorkflowSpec, Workload), durable=True)
        fids = dep.resume()
        assert fids and all(f.startswith(wid + "/") for f in fids), fids
        fresh.run(timeout_s=60.0)
        assert dep.result_of(wid, "b") == 16
        assert calls.values() == [6]
        third = RemoteRunner(store_dir=fresh.store_dir, poll_ms=5.0)
        assert deploy(third, _two_stage(calls, WorkflowSpec, Workload),
                      durable=True).resume() == []
    finally:
        old.close()


#: the serve request of the remote run
BATCH, PROMPT, STEPS, SEED = 2, 16, 12, 7
#: the lease: longer than a CPU decode attempt (its tree loaded included)
LEASE_MS = 6000.0


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}§")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def test_serve_workflow_on_remote_runner_survives_a_killed_worker(tmp_path):
    """The serve workflow on the port's RemoteRunner (two ``aws`` workers and
    one ``aliyun`` worker, forked from a coordinator process that imports
    neither JAX nor ``repro``) at the yi-9b smoke config in fp32, on the
    reference's weights converted.  The ``aws/lambda`` decode replica's
    worker is SIGKILLed at its output commit; the other ``aws`` worker
    claims it again once its lease expires.  One detok completion, and the
    committed tokens equal the reference's ``greedy_generate``: in fp32 the
    port's logits agree with the reference's to 1e-4, far inside the gap
    between the two largest logits of these weights, so each argmax picks
    the same id (``test_torch_serve.py`` holds the same equality for a
    direct call), and the forked workers run that same code."""
    jcfg = jconfigs.get_smoke("yi-9b").replace(compute_dtype="float32")
    p_j = jlm.init(jax.random.PRNGKey(0), jcfg)
    np.savez(tmp_path / "params.npz", **dict(_flat(jax.tree.map(np.asarray, p_j))))
    with open(tmp_path / "job.json", "w") as f:
        json.dump({"arch": "yi-9b", "compute_dtype": "float32", "device": "cpu",
                   "params": "npz", "batch": BATCH, "prompt_len": PROMPT, "steps": STEPS,
                   "seed": SEED, "lease_ms": LEASE_MS}, f)
    r = subprocess.run([sys.executable, WORKER, str(tmp_path)], cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(tmp_path / "result.json") as f:
        out = json.load(f)

    prompt = np.array(workflow.prompt_ids(jcfg, BATCH, PROMPT, SEED), np.int32)
    ref = np.asarray(jgreedy(p_j, jcfg, jnp.asarray(prompt), STEPS))
    np.testing.assert_array_equal(np.array(out["ids"]), ref)
    assert out["completions"] == 1
    assert out["decode_calls"] >= 2
    aws = {pid for name, pid in out["workers"].items() if name.startswith("aws-")}
    kills = [e for e in out["log"] if e["event"] == "kill"]
    assert len(kills) == 1 and kills[0]["faas"] == workflow.PRIMARY
    assert kills[0]["pid"] in aws and kills[0]["attempt"] == 0
    again = [e for e in out["log"] if e["event"] == "claim" and e["function"] == "decode"
             and e["faas"] == workflow.PRIMARY and e["attempt"] == 1]
    assert len(again) == 1 and again[0]["pid"] in aws - {kills[0]["pid"]}
    assert [d["status"] for d in out["decodes"]
            if d["faas"] == workflow.PRIMARY] == ["running", "done"]
    assert not any(e["cuda"] for e in out["log"])
