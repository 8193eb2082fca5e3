"""Where serving time goes: a torch.profiler trace of one prefill and a few
decode steps, summed by kernel.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch {yi-9b,mamba2-370m,recurrentgemma-9b} \\
        [--smoke] [--batch 4 --prompt-len 512 --decode-steps 4] [--device cpu]

Weights are random (``--seed``).  After one untraced warm-up prefill, one
prefill and then ``--decode-steps`` decode steps are traced separately.  For
each phase it prints the host-clock time (ended by a device synchronise),
the device busy time (union of kernel intervals), the idle share, and the
device time by kernel class and by kernel name.  On the CPU only host-side
operator times exist and the device columns are absent.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, resolve_device
from repro_torch.models import lm

#: kernel class by substring of the kernel's name (first match wins)
CLASSES = [
    ("flash_attention", ("flash_fwd_kernel",)),
    ("ssd_scan", ("ssd_scan_kernel", "ssd_sm90::")),      # fma; mma's three kernels
    ("rglru_scan", ("rglru_scan_kernel",)),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("elementwise/cast", ("elementwise", "copy", "cast", "fill", "where")),
    ("reduction/softmax", ("reduce", "softmax", "norm")),
    ("index/cat", ("index", "cat", "gather", "scatter", "roll", "pad")),
]


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _union_us(intervals: List[tuple]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(prof, wall_s: float) -> Dict[str, Any]:
    """Device busy/idle and device time by class and kernel from a trace."""
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] += dur
        by_class[kernel_class(e.name)] += dur
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    out: Dict[str, Any] = {"wall_ms": wall_s * 1e3, "kernel_launches": len(kernels)}
    if kernels:
        out.update({
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
            "by_class_ms": {k: v / 1e3 for k, v in
                            sorted(by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": {k[:120]: v / 1e3 for k, v in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:12]},
        })
    else:
        ops = prof.key_averages()
        out["top_host_ops_ms"] = {e.key: e.self_cpu_time_total / 1e3 for e in
                                  sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]}
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traced(dev: torch.device, fn):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    return result, summarize(prof, wall)


@torch.inference_mode()
def run(arch: str, *, smoke: bool = False, batch: int = 4, prompt_len: int = 512,
        decode_steps: int = 4, seed: int = 0, device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init(gen, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=dev)
    max_len = prompt_len + decode_steps + 1
    lm.prefill(params, cfg, prompt, max_len=max_len)          # warm-up, untraced
    (cache, logits), prefill = _traced(
        dev, lambda: lm.prefill(params, cfg, prompt, max_len=max_len))
    tok = logits.argmax(-1)[:, None]

    def decode():
        nonlocal cache, tok
        for _ in range(decode_steps):
            lg, cache = lm.decode_step(params, cfg, tok, cache)
            tok = lg.argmax(-1)[:, None]

    _, dec = _traced(dev, decode)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"arch": cfg.name, "device": where, "batch": batch, "prompt_len": prompt_len,
            "decode_steps": decode_steps, "prefill": prefill, "decode": dec}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(configs.ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.arch, smoke=args.smoke, batch=args.batch, prompt_len=args.prompt_len,
            decode_steps=args.decode_steps, seed=args.seed, device=args.device)
    print(json.dumps(r, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
