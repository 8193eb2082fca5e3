"""Step-commit training: the Jointλ exactly-once protocol as the trainer's
commit protocol.

The port of :mod:`repro.train.commit`.  The training loop is a Jointλ
workflow on the real-execution backend (:mod:`repro_torch.backends.localjax`,
the verbatim copy of the reference's runner):

  * one workflow function, ``train_chunk``, advances the model K steps and
    writes an atomic checkpoint — the checkpoint is the chunk's **output
    data checkpoint** (Fig 7): a crashed/duplicated chunk reuses the stored
    result instead of re-training, so every chunk commits exactly once;
  * the chunk invokes its own successor through the **invocation
    checkpoint** (Fig 8) — at-most-once hand-off — via a Cycle edge guarded
    by ``step < total``;
  * two controllers ("pods") host the chunk function; the ``Failover`` field
    retargets the next chunk when the primary controller is down (§4.2), and
    the restarted chunk restores from the last committed checkpoint;
  * because the data pipeline is stateless (batch = f(seed, step)), replayed
    chunks consume identical data.

``redundant=True`` races the chunk on both controllers (the paper's
ByRedundant); the checkpoint's conditional-create picks the first finisher.
The reference's ``jax.jit`` of the step is a plain call here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.backends.localjax import LocalRunner, deploy_local
from repro_torch.backends.simcloud import Workload
from repro_torch.core.subgraph import WorkflowSpec
from repro_torch.data.synthetic import make_batch
from repro_torch.models.common import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import make_train_step, train_state_init, train_state_shapes

PRIMARY = "aws/lambda"         # "pod controller A"
BACKUP = "aliyun/fc"           # "pod controller B"


@dataclass
class CommitResult:
    step: int
    loss: float
    ckpt_path: str
    wall_s: float
    controller_attempts: int = 1


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch of :func:`make_batch` as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


class CommittedTrainer:
    """Drive training as an exactly-once Jointλ workflow."""

    def __init__(self, cfg: ModelConfig, *, seq_len: int, global_batch: int,
                 ckpt_dir: str, steps_per_chunk: int = 10, lr: float = 3e-4,
                 seed: int = 0, redundant: bool = False,
                 on_chunk: Optional[Callable[[int, float], None]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.ckpt_dir = ckpt_dir
        self.k = steps_per_chunk
        self.seed = seed
        self.on_chunk = on_chunk
        self.device = resolve_device(device)
        self._state = None                       # in-process state cache
        self._step_fn = make_train_step(cfg, lr=lr)
        self.metrics: list = []
        self.runner = LocalRunner()
        self.redundant = redundant

    # ---- the user function of the workflow ---------------------------------

    def _train_chunk(self, req: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.time()
        step = int(req["step"])
        total = int(req["total"])
        if self._state is None or int(self._state["step"]) != step:
            # cold start or post-failover restore from the last commit
            if ckpt.latest_step(self.ckpt_dir) is not None:
                self._state = ckpt.restore(train_state_shapes(self.cfg), self.ckpt_dir,
                                           device=self.device)
            else:
                gen = torch.Generator(device=self.device).manual_seed(self.seed)
                self._state = train_state_init(gen, self.cfg, device=self.device)
        state = self._state
        losses = []
        for s in range(step, min(step + self.k, total)):
            batch = batch_to(make_batch(self.cfg, self.seq_len, self.global_batch, step=s,
                                        seed=self.seed), self.device)
            state, m = self._step_fn(state, batch)
            losses.append(float(m["loss"]))
        self._state = state
        new_step = int(state["step"])
        path = ckpt.save(state, self.ckpt_dir, new_step)
        out = {"step": new_step, "total": total,
               "loss": float(np.mean(losses)), "ckpt": path,
               "wall_s": time.time() - t0}
        self.metrics.append(out)
        if self.on_chunk:
            self.on_chunk(new_step, out["loss"])
        return out

    # ---- workflow wiring -----------------------------------------------------

    def _spec(self, total: int) -> WorkflowSpec:
        spec = WorkflowSpec("train-commit", gc=False)
        spec.function("train_chunk", PRIMARY, failover=[BACKUP],
                      workload=Workload(fn=self._train_chunk))
        spec.function("finalize", PRIMARY, failover=[BACKUP],
                      workload=Workload(fn=lambda r: r))
        if self.redundant:
            spec.redundant("train_chunk", "train_chunk",
                           replicas=[PRIMARY, BACKUP])
        spec.cycle("train_chunk", "train_chunk",
                   while_pred=lambda out: out["step"] < out["total"])
        spec.sequence("train_chunk", "finalize")
        return spec

    def train(self, total_steps: int, *, fail_primary_at_chunk: Optional[int] = None
              ) -> CommitResult:
        """Run to ``total_steps``; optionally kill the primary controller
        mid-run to exercise failover + restore."""
        deploy_local(self.runner, self._spec(total_steps))
        start_step = ckpt.latest_step(self.ckpt_dir) or 0
        self.runner.submit(PRIMARY, "train_chunk",
                           {"workflow_id": f"train-{start_step}",
                            "input": {"step": start_step, "total": total_steps}})
        if fail_primary_at_chunk is not None:
            chunks = [0]

            def maybe_fail(step, loss):
                chunks[0] += 1
                if chunks[0] == fail_primary_at_chunk:
                    self.runner.set_down(PRIMARY)
                    self._state = None          # controller B starts cold
            self.on_chunk = maybe_fail
        t0 = time.time()
        self.runner.run()
        final = self.metrics[-1] if self.metrics else None
        if final is None:
            raise RuntimeError("training workflow made no progress")
        return CommitResult(step=final["step"], loss=final["loss"],
                            ckpt_path=final["ckpt"],
                            wall_s=time.time() - t0)
