"""Serving as a Jointλ workflow with ByRedundant straggler mitigation.

The twin of ``examples/serve_workflow.py`` on the port: a batched
generation request flows through tokenize → [decode replica race on
``aws/lambda`` and ``aliyun/fc``] → detokenize on the port's
:class:`~repro_torch.backends.localjax.LocalRunner`.  Both decode replicas
run :func:`~repro_torch.serve.engine.greedy_generate` on worker threads
against one shared parameter tree (on the card, or wherever ``params`` lie);
the first to commit its output checkpoint wins and the straggler's result
collapses against the conditional create, so detokenize runs exactly once.
``chip_smoke.py`` drives it at the full width of yi-9b.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.backends.localjax import LocalRunner, deploy_local
from repro_torch.backends.simcloud import Workload
from repro_torch.core.subgraph import WorkflowSpec
from repro_torch.models.common import ModelConfig
from repro_torch.serve.engine import greedy_generate

PRIMARY, BACKUP = "aws/lambda", "aliyun/fc"


def prompt_ids(cfg: ModelConfig, batch: int, prompt_len: int, seed: int) -> list:
    """The tokenize stage: a seeded stand-in prompt of ``batch × prompt_len`` ids."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(batch, prompt_len)).tolist()


def run(params: Dict[str, Any], cfg: ModelConfig, *, batch: int = 2,
        prompt_len: int = 16, steps: int = 12, seed: int = 7,
        workflow_id: str = "serve-001", timeout_s: float = 600.0) -> Dict[str, Any]:
    """Serve one request through the workflow; returns what downstream saw.

    Keys: ``ids`` (the committed generation, [batch][steps]), ``text``,
    ``completions`` (detok completions, 1 when exactly-once holds),
    ``decode_calls`` (replicas that ran), ``wall_s``.
    """
    device = params["embed"].device
    calls = {"decoded": 0}
    lock = threading.Lock()

    def tokenize(req):
        return prompt_ids(cfg, req["batch"], prompt_len, req["seed"])

    def decode(ids):
        with lock:
            calls["decoded"] += 1
        prompt = torch.tensor(ids, dtype=torch.long, device=device)
        return greedy_generate(params, cfg, prompt, steps=steps).cpu().tolist()

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

    runner = LocalRunner()
    deploy_local(runner, spec)
    t0 = time.perf_counter()
    runner.submit(PRIMARY, "tokenize",
                  {"workflow_id": workflow_id, "input": {"batch": batch, "seed": seed}})
    runner.run(timeout_s=timeout_s)
    wall = time.perf_counter() - t0
    done = [r for r in runner.records if r.function == "detok" and r.status == "done"]
    if not done:
        raise RuntimeError("serve workflow finished without a detok completion")
    return {"ids": done[0].result["ids"], "text": done[0].result["text"],
            "completions": len(done), "decode_calls": calls["decoded"],
            "wall_s": wall}

