"""Serving as a Jointλ workflow with ByRedundant straggler mitigation.

The twin of ``examples/serve_workflow.py`` on the port: a batched
generation request flows through tokenize → [decode replica race on
``aws/lambda`` and ``aliyun/fc``] → detokenize, deployed through the one
backend-agnostic path (:func:`repro_torch.core.workflow.deploy`) on the
port's :class:`~repro_torch.backends.localjax.LocalRunner` (the default:
both replicas on worker threads of this process, against one shared
parameter tree) or its :class:`~repro_torch.backends.remote.RemoteRunner`
(each replica in a forked worker process of its cloud, which builds its own
tree).  The first replica to commit its output checkpoint wins and the
straggler's result collapses against the conditional create, so detokenize
runs exactly once.  Results come from the request's execution records
(:meth:`~repro_torch.core.workflow.DeployedWorkflow.executions`), which
both runners serve.
``chip_smoke.py`` drives it at the full width of yi-9b and mamba2-370m on
either runner.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.backends.localjax import LocalRunner
from repro_torch.backends.simcloud import Workload
from repro_torch.core.subgraph import WorkflowSpec
from repro_torch.core.workflow import deploy
from repro_torch.models.common import ModelConfig
from repro_torch.serve.engine import greedy_generate

PRIMARY, BACKUP = "aws/lambda", "aliyun/fc"


def prompt_ids(cfg: ModelConfig, batch: int, prompt_len: int, seed: int) -> list:
    """The tokenize stage: a seeded stand-in prompt of ``batch × prompt_len`` ids."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(batch, prompt_len)).tolist()


def params_source(params) -> Callable[[], Dict[str, Any]]:
    """``params`` as a call that returns the parameter tree.  A tree is
    shared as it is.  A zero-argument callable runs at most once in each
    process, and its tree is kept under that process's id: a worker forked
    from a process that built one builds its own instead of reusing it."""
    if not callable(params):
        return lambda: params
    trees: Dict[int, Any] = {}
    lock = threading.Lock()

    def tree():
        pid = os.getpid()
        with lock:
            if pid not in trees:
                trees.clear()
                trees[pid] = params()
            return trees[pid]

    return tree


def serve_spec(cfg: ModelConfig, params, *, prompt_len: int = 16,
               steps: int = 12) -> WorkflowSpec:
    """The serve workflow.  ``params`` is the tree or a zero-argument
    callable building it (:func:`params_source`).  Payloads and results are
    lists of ids, never tensors."""
    tree = params_source(params)

    def tokenize(req):
        return prompt_ids(cfg, req["batch"], prompt_len, req["seed"])

    def decode(ids):
        p = tree()
        prompt = torch.tensor(ids, dtype=torch.long, device=p["embed"].device)
        return greedy_generate(p, cfg, prompt, steps=steps).cpu().tolist()

    def detokenize(ids):
        return {"ids": ids,
                "text": [" ".join(f"<{t}>" for t in row[:6]) for row in ids]}

    spec = WorkflowSpec("serve", gc=False)
    spec.function("tokenize", PRIMARY, workload=Workload(fn=tokenize))
    spec.function("decode", PRIMARY, failover=[BACKUP], workload=Workload(fn=decode))
    spec.function("detok", PRIMARY, workload=Workload(fn=detokenize))
    # ByRedundant: race decode on both controllers; first commit wins
    spec.redundant("tokenize", "decode", replicas=[PRIMARY, BACKUP])
    spec.sequence("decode", "detok")
    return spec


def outcome(dep, workflow_id: str) -> Dict[str, Any]:
    """What downstream saw of one request, from its execution records
    (``dep.executions``, which both runners serve).

    Keys: ``ids`` (the committed generation, [batch][steps]; None before
    detok completes), ``text``, ``completions`` (detok completions, 1 when
    exactly-once holds), ``decode_calls`` (decode executions, every
    attempt, finished or not), ``decode_runs`` (those whose record shows
    the user function ran: an attempt killed before it ended recorded no
    phases, one that found the output checkpoint ran none), ``decodes``
    (each decode record's exec_id, faas, status, attempt, t_start and
    t_end, wall-clock ms).
    """
    recs = dep.executions(workflow_id)
    done = [r for r in recs if r.function == "detok" and r.status == "done"]
    decodes = [r for r in recs if r.function == "decode"]
    return {"ids": done[0].result["ids"] if done else None,
            "text": done[0].result["text"] if done else None,
            "completions": len(done), "decode_calls": len(decodes),
            "decode_runs": sum(any(ph == "user_exec" for _, ph in r.phases)
                               for r in decodes),
            "decodes": [{"exec_id": r.exec_id, "faas": r.faas, "status": r.status,
                         "attempt": r.attempt, "t_start": r.t_start, "t_end": r.t_end}
                        for r in decodes]}


def run(params, cfg: ModelConfig, *, runner=None, batch: int = 2, prompt_len: int = 16,
        steps: int = 12, seed: int = 7, workflow_id: str = "serve-001",
        timeout_s: float = 600.0) -> Dict[str, Any]:
    """Serve one request through the workflow on ``runner`` (default: a new
    LocalRunner); returns :func:`outcome` and ``wall_s``."""
    runner = LocalRunner() if runner is None else runner
    dep = deploy(runner, serve_spec(cfg, params, prompt_len=prompt_len, steps=steps))
    t0 = time.perf_counter()
    wid = dep.start({"batch": batch, "seed": seed}, workflow_id=workflow_id)
    runner.run(timeout_s=timeout_s)
    wall = time.perf_counter() - t0
    out = outcome(dep, wid)
    if not out["completions"]:
        raise RuntimeError("serve workflow finished without a detok completion")
    return {**out, "wall_s": wall}
