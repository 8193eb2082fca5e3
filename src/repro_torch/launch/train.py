"""Training launcher: the committed (Jointλ step-commit) trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
        --steps 20 --seq-len 128 --batch 8 --device cpu

The twin of ``repro.launch.train``.  Runs on the card by default
(``--device cuda``) and raises without one.  Weights are random, drawn from
``--seed``; data comes from the synthetic pipeline.  Recurrent archs train
on the CPU only: their scan kernels have no backward on the card yet, and
the wrapper raises there.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Optional, Sequence

from repro_torch import configs, resolve_device


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(configs.ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chunk", type=int, default=10,
                    help="steps per exactly-once commit chunk")
    ap.add_argument("--ckpt-dir", help="where commits go (default: a new temporary "
                    "directory)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, help="override width")
    ap.add_argument("--layers", type=int, help="override depth")
    ap.add_argument("--fail-at-chunk", type=int,
                    help="kill the primary controller after N chunks (failover demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.layers:
        overrides["n_layers"] = args.layers
    if overrides:
        cfg = cfg.replace(**overrides)

    from repro_torch.train.commit import CommittedTrainer
    n_params = cfg.param_count()
    print(f"[train] {cfg.name} on {dev}: {n_params/1e6:.1f}M params | seq {args.seq_len} "
          f"| batch {args.batch} | {args.steps} steps "
          f"(chunks of {args.chunk}, exactly-once commits)")

    def log(step, loss):
        print(f"[train] step {step:6d}  loss {loss:.4f}")

    tr = CommittedTrainer(cfg, seq_len=args.seq_len, global_batch=args.batch,
                          ckpt_dir=ckpt_dir, steps_per_chunk=args.chunk,
                          lr=args.lr, seed=args.seed, on_chunk=log, device=dev)
    res = tr.train(args.steps, fail_primary_at_chunk=args.fail_at_chunk)
    print(f"[train] done: step {res.step}, final loss {res.loss:.4f}, "
          f"{res.wall_s:.1f}s, last commit {res.ckpt_path}")
    if len(tr.metrics) >= 3:
        first, last = tr.metrics[0]["loss"], tr.metrics[-1]["loss"]
        print(f"[train] loss {first:.4f} → {last:.4f} "
              f"({'decreasing' if last < first else 'not decreasing'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
