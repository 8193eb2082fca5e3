"""The readings each limit of a cell's check is set from.

    python3 perfbench/tests/readings.py --cell <cell> --seeds <n> ... \\
        [--control <n> ...] [--half-batch <n> ...] --out <file.jsonl>

Each reading is a whole run of the cell with a short window (the driver
itself, its check and ``correct`` included), with the timed path as it is
or broken underneath:

* ``--seeds``: the lower reading, the sound port's numbers.
* ``--control``: the control: the plain reference computed with fp8
  products (``reference/common.mm``) put in the port's place, as the
  cell's prefill step or train step (:func:`control`).
* ``--half-batch``: a training cell's port with half of each batch left out
  (its mean taken over the rest): a fault that one of the numbers has to
  catch.

Each reading is a line of JSON in ``--out`` and on standard output.  Run on
the card at the cell's own size; the CPU tests use the same functions at
smoke size.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterator

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from perfbench.harness import bench  # noqa: E402


def numbers(b: bench.Bench) -> Dict[str, Any]:
    """A run of the cell: ``correct`` as the result line has it, each number
    compared, and the leaves that set a training cell's numbers."""
    r = bench.run_bench(b)
    out, _ = bench.report(b, r, bench.benchmark_spec())
    notes = [line for line in r.lines
             if line.startswith(("worst", "grad gap by leaf", "not compared"))]
    return {"correct": out["correct"], **{c.name: c.value for c in r.checks},
            **({"notes": notes} if notes else {})}


@contextlib.contextmanager
def _patched(module: Any, name: str, value: Any) -> Iterator[None]:
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def control(b: bench.Bench) -> Iterator[None]:
    """The fp8 reference in the port's place: ``serve/engine.make_prefill_step``
    gives a step that runs the reference's prefill with fp8 products and
    returns its logits and cache in the port's layout, and
    ``train/step.make_train_step`` one that runs the reference's training
    step with fp8 products on the state the driver hands it."""
    from repro_torch.serve import engine
    from repro_torch.train import step as step_mod
    ref, dims = b.reference(), b.dims()

    def make_prefill_step(cfg, *, max_len):
        def prefill_step(params, inputs):
            logits, cache = ref.prefill(params, dims, inputs["tokens"], "fp8")
            return {"blocks": {"s0": cache}}, logits
        return prefill_step

    def make_train_step(cfg, **kw):
        o = b.traffic["optimizer"]

        def train_step(state, batch):
            params, opt, loss, _, _ = ref.train_step(state["params"], state["opt"],
                                                     int(state["step"]), dims, batch, o, "fp8")
            return ({"params": params, "opt": opt, "step": state["step"] + 1},
                    {"loss": torch.tensor(loss)})
        return train_step

    with _patched(engine, "make_prefill_step", make_prefill_step), \
            _patched(step_mod, "make_train_step", make_train_step):
        yield


@contextlib.contextmanager
def half_batch() -> Iterator[None]:
    """The port's train step on the first half of each batch's rows."""
    from repro_torch.train import step as step_mod
    orig = step_mod.make_train_step

    def faulty(cfg, **kw):
        inner = orig(cfg, **kw)

        def train_step(state, batch):
            return inner(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
        return train_step

    with _patched(step_mod, "make_train_step", faulty):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--half-batch", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    runs = ([("port", s) for s in args.seeds] + [("control", s) for s in args.control]
            + [("half_batch", s) for s in args.half_batch])
    with open(args.out, "a") as f:
        for kind, seed in runs:
            t = time.perf_counter()
            b = bench.make_bench(args.cell, seed, 0.5, False, dev, t)
            broken = {"port": contextlib.nullcontext, "control": lambda: control(b),
                      "half_batch": half_batch}[kind]
            with broken():
                nums = numbers(b)
            line = json.dumps({"cell": args.cell, "kind": kind, "seed": seed,
                               "seconds": time.perf_counter() - t, **nums})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
