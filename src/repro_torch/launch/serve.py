"""Serving launcher: prefill + greedy decode with batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
        --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Runs on the card by default (``--device cuda``) and raises without one.
Weights are random, drawn from ``--seed``.  VLM and enc-dec configs serve
their text decoder against stub frontends, as the reference's launcher
does: an enc-dec config gets random frames ``[B, prompt_len // 8, 1024]``
for its encoder; a VLM config serves text only (the patch prefix goes
through ``serve/engine.make_prefill_step``).  Prints prefill ms, decode
ms/token and tok/s, each timed on the host clock around work that ends in a
device synchronise, and each kernel's launches in the run.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import configs, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve.engine import greedy_generate


def run(arch: str, *, smoke: bool = False, batch: int = 4, prompt_len: int = 64,
        gen: int = 32, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Init, then serve one batch; returns the tokens and the measurements."""
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if cfg.enc_dec or cfg.n_patches:
        print(f"[serve] note: {cfg.name} needs modality inputs; serving the "
              f"text decoder against stub frontends")
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = lm.init(gen_, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen_, device=dev)
    frames = (torch.randn((batch, prompt_len // 8, 1024), generator=gen_, device=dev)
              if cfg.enc_dec else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    init_s = time.perf_counter() - t0

    launches0 = dict(ops.launches)
    stats: Dict[str, Any] = {}
    out = greedy_generate(params, cfg, prompt, gen, stats=stats, frames=frames)
    return {
        "cfg": cfg, "tokens": out, "device": dev, "init_s": init_s,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_token": stats["decode_s"] * 1e3 / max(gen - 1, 1),
        "tok_s": batch * gen / (stats["prefill_s"] + stats["decode_s"]),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        "launches": {name: n - launches0[name] for name, n in ops.launches.items()},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(configs.ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    r = run(args.arch, smoke=args.smoke, batch=args.batch, prompt_len=args.prompt_len,
            gen=args.gen, seed=args.seed, device=args.device)
    where = (torch.cuda.get_device_name(r["device"]) if r["device"].type == "cuda"
             else "cpu")
    print(f"[serve] {r['cfg'].name} on {where}: batch {args.batch} × prompt "
          f"{args.prompt_len} → {args.gen} tokens")
    print(f"[serve] prefill {r['prefill_ms']:.3f} ms, decode "
          f"{r['decode_ms_per_token']:.3f} ms/token, {r['tok_s']:.1f} tok/s, "
          f"kernel launches {r['launches']}"
          + (f", peak mem {r['peak_mem_gb']:.2f} GB" if r["peak_mem_gb"] else ""))
    print(f"[serve] sample continuation ids: {r['tokens'][0][:16].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
