"""The train driver: a training node's steps, back to back.

Set-up makes the seeded weights on the card, the port's train state (fp32
masters, zero AdamW moments) and its step (``train/step.make_train_step``
with the mix's optimizer settings), and drives that same state through the
first ``check_steps`` steps on their seeded batches: they warm up every
shape and are the steps the check holds.  From them it keeps the loss of
each step, each leaf's norm of the first step's gradient as AdamW got it
(its first moment over ``1 − b1``) and each leaf's norm of the parameters'
change over those steps.  The window then runs steps on fresh seeded rows,
each ended by a synchronise (the node reads its loss), and closes with the
first step to finish after ``--seconds``.

``train_tokens_per_s`` is every token of the window's steps over its
length.  A traced run profiles ``trace_steps`` steps from the ``trace_from``-th
step of the window on.

After the window the port's state is freed and the plain fp32 reference
runs the same first steps from the same seeded weights and batches.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from perfbench.harness import compare, weights
from perfbench.harness.bench import Bench, Check, Result
from perfbench.harness.trace import Chunks, span
from perfbench.harness.traffic import Traffic


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(b: Bench) -> Result:
    from repro_torch.models import lm
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    cfg, dev, t = b.model_cfg, b.device, b.traffic
    o = t["optimizer"]
    traffic = Traffic(t, b.seed, b.config["vocab_size"])
    t_w = time.perf_counter()
    shapes = lm.init_shapes(cfg)
    params = weights.make(shapes, b.seed, dev)
    _sync(dev)
    t_steps = time.perf_counter()
    state = {"params": params, "opt": optim.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params
    step_fn = make_train_step(cfg, lr=o["lr"], max_grad_norm=o["max_grad_norm"],
                              weight_decay=o["weight_decay"])
    first = t["check_steps"]
    losses = []
    grads: Dict[str, float] = {}
    for k in range(first):
        state, met = step_fn(state, traffic.batch(k, dev))
        losses.append(float(met["loss"]))
        if k == 0:
            grads = {n: v / (1 - o["b1"]) for n, v in compare.norms(state["opt"]["m"]).items()}
    p0 = weights.make(shapes, b.seed, dev)
    updates = compare.diff_norms(state["params"], p0)
    del p0, met
    _sync(dev)

    chunks = Chunks(dev, t["trace_from"], t["trace_steps"], b.trace)
    ahead: Dict[int, Dict[str, torch.Tensor]] = {}
    done = 0
    t_start = time.perf_counter()
    b.start_window(t_start)
    while True:
        ahead.update(chunks.enter(done, lambda j: traffic.batch(first + j, dev)))
        if done in ahead:
            batch = ahead.pop(done)
        else:
            with span("make_batch"):
                batch = traffic.batch(first + done, dev)
        with span("train_step"):
            state, met = step_fn(state, batch)
        with span("sync"):
            _sync(dev)
        chunks.leave(done)
        done += 1
        if time.perf_counter() - t_start >= b.seconds and chunks.done(done):
            break
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bsz, l = t["batch"], t["seq_len"]
    data = None
    if b.trace:
        n_tr = chunks.n
        data = chunks.data({"steps": n_tr, "items": [(bsz, l)] * n_tr, "layers": b.layers},
                           b.config, torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu")
    last_loss = float(met["loss"])
    del state, met, batch, step_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    p0 = weights.make(shapes, b.seed, dev)
    out = b.reference().train_steps(p0, b.dims(), [traffic.batch(k, dev) for k in range(first)],
                                    o)
    ref_grads = compare.norms(out["grads"])
    ref_updates = compare.diff_norms(out["params"], p0)
    keep = compare.kept_leaves(ref_grads)
    nums = {"loss_gap": max(abs(a - r) for a, r in zip(losses, out["losses"])),
            "grad_gap": compare.leaf_gap(grads, ref_grads, keep),
            "grad_gap_median": compare.median_leaf_gap(grads, ref_grads, keep),
            "update_gap": compare.leaf_gap(updates, ref_updates, keep)}
    checks = [Check(n, v, b.limits[n]) for n, v in nums.items() if n in b.limits]
    lines = [f"set-up: to the weights {t_w - b.t0:.2f} s, weights {t_steps - t_w:.2f} s, "
             f"first steps and their readings {t_start - t_steps:.2f} s",
             f"steps {done} in {window_s:.3f} s; last loss {last_loss:.6f}",
             f"first-step losses {losses} (reference {out['losses']})",
             f"worst leaves: grad {compare.worst_leaf(grads, ref_grads, keep)}, update "
             f"{compare.worst_leaf(updates, ref_updates, keep)}",
             "grad gap by leaf, 50th/90th/99th percentile: " + ", ".join(
                 f"{q:.6g}" for q in _percentiles(compare.leaf_gaps(grads, ref_grads, keep))),
             f"not compared: {({n: v for n, v in nums.items() if n not in b.limits})}",
             f"leaves held {len(keep)} of {len(ref_grads)}; check "
             f"{time.perf_counter() - t_check:.1f} s",
             f"memory_peak_bytes {peak}"]
    if data:
        lines.append(f"traced operator calls {len(data.ops)}, with scalar arguments "
                     f"{sum(any(x is not None for x in c.scalars) for c in data.ops)}")
    return Result(attempted=done, failed=0,
                  end_to_end={"train_tokens_per_s": done * bsz * l / window_s},
                  checks=checks, memory_peak_bytes=peak, trace=data, lines=lines)


def _percentiles(gaps: Dict[str, float]) -> List[float]:
    q = statistics.quantiles(gaps.values(), n=100) if len(gaps) > 1 else list(gaps.values()) * 99
    return [q[49], q[89], q[98]]
