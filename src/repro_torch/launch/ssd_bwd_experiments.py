"""Experiments on the SSD scan's tensor-core kernels, on the card.

    PYTHONPATH=src python -m repro_torch.launch.ssd_bwd_experiments \\
        [--what ablate,heads,fwd_mma] [--rounds 2] [--out FILE]

At mamba2-370m's dims (H 32, P 64, N 128, chunk 256; inputs in the model's
recipe, dt = softplus(N(0,1) + log(expm1(0.01))) and A = −linspace(1, 16)):

* ``ablate``: the mma backward (``csrc/ssd_scan_bwd_sm90.cu``) at the
  training shape, x/dy [2, 2048, 32, 64] bf16, against copies of its source
  with one piece of work taken out (:data:`ABLATIONS`), built under
  ``build/``.  The copies compute wrong gradients: they only time what the
  work they lack costs.
* ``heads``: the mma backward at the training shape for each limit on the
  heads a block of its pair passes takes (1, 2, 4, 8, 16, 32), set through
  ``ssd_scan.BWD_HEADS_PER_BLOCK``.
* ``fwd_mma``: the mma forward at the serving shape (x [4, 512, 32, 64])
  and at the training shape with ``csrc/ssd_mma.cuh``'s ``mma`` as
  committed, a plain ``asm`` statement, against a copy where it is ``asm
  volatile``.

Each time is the torch.profiler device time per call: the union of the
device intervals of 20 calls, over 20, after 3 untimed ones.  A trace that
lacks device events or some launches is taken again, up to five times; after
that the time is taken with CUDA events, host gaps included, and its
``method`` says ``cuda_events`` instead of ``profiler``.  Each round times
the variants in order, the next round in reverse order.  Prints one JSON
object; ``--out`` writes it to a file as well.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import configs
from repro_torch.kernels import build, ops, ssd_scan as ssd
from repro_torch.launch.profile_serve import _union_us
from repro_torch.models import ssm

BWD_SOURCE = "ssd_scan_bwd_sm90.cu"
FWD_SOURCE = "ssd_scan.cu"

#: variant → (file under csrc/, [(text, its replacement, occurrences)])
ABLATIONS: Dict[str, Tuple[str, List[Tuple[str, str, int]]]] = {
    # the decay's exps on the diagonal tiles (the only ones taken at
    # mamba2-370m's dims, where the other tiles factor the decay)
    "no_exp": (BWD_SOURCE, [("__expf(", "(1.f + ", 8)]),
    # the products of the masked scores with C into dB and with B into dC
    # (and the splits that feed them), the largest of the pair passes
    "no_pair_dBdC": (BWD_SOURCE, [
        ("// dB_j += Σ_i (r·L·dt)_ji C_i\n#pragma unroll\n"
         "                for (int gi = 0; gi < MAX_N / 16; ++gi) {\n"
         "                    if (gi * 16 >= N) break;",
         "// dB_j += Σ_i (r·L·dt)_ji C_i\n#pragma unroll\n"
         "                for (int gi = 0; gi < MAX_N / 16; ++gi) {\n"
         "                    if (true) break;", 1),
        ("// dC_i += Σ_j (r·L·dt)_ij B_j\n#pragma unroll\n"
         "                for (int gi = 0; gi < MAX_N / 16; ++gi) {\n"
         "                    if (gi * 16 >= N) break;",
         "// dC_i += Σ_j (r·L·dt)_ij B_j\n#pragma unroll\n"
         "                for (int gi = 0; gi < MAX_N / 16; ++gi) {\n"
         "                    if (true) break;", 1)]),
    # each head's state terms in the pair passes: dS_c B_j and h_in[c] C_i
    "no_state_terms": (BWD_SOURCE, [
        ("        if (active) {\n            // dS_c B_j",
         "        if (false) {\n            // dS_c B_j", 1),
        ("        if (active) {\n            // h_in[c] C_i",
         "        if (false) {\n            // h_in[c] C_i", 1)]),
    # the forward's products as asm volatile (fwd_mma)
    "fwd_volatile_mma": ("ssd_mma.cuh", [
        ('    asm("mma.sync.aligned.m16n8k16', '    asm volatile("mma.sync.aligned.m16n8k16', 1)]),
}

EXPERIMENT_DIR = build.BUILD_DIR.parent / "experiments"


def ablated_sources(name: str) -> Dict[str, str]:
    """The files of variant ``name``: its edited file and every other file it
    needs from csrc/, by file name; raises if an edit does not apply."""
    target, edits = ABLATIONS[name]
    main = FWD_SOURCE if target.endswith(".cuh") else target
    files = {p.name: p.read_text() for p in build.CSRC.glob("*.cuh")}
    files[main] = build.CSRC.joinpath(main).read_text()
    text = files[target]
    for old, new, count in edits:
        if text.count(old) != count:
            raise ValueError(f"{name}: {old[:40]!r} occurs {text.count(old)} times in "
                             f"{target}, not {count}")
        text = text.replace(old, new)
    files[target] = text
    # keyed by name: build keys a library by its source and csrc/'s headers only
    files[main] = f"// experiment: {name}\n" + files[main]
    return files


def _register(name: str) -> str:
    """Write variant ``name``'s files under build/ and register its source
    in ``build.SOURCES``; returns the name it is registered under."""
    files = ablated_sources(name)
    main = FWD_SOURCE if ABLATIONS[name][0].endswith(".cuh") else ABLATIONS[name][0]
    d = EXPERIMENT_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    for fname, text in files.items():
        (d / fname).write_text(text)
    key = f"exp_{name}"
    build.SOURCES[key] = os.path.relpath(d / main, build.CSRC)
    return key


def device_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3
              ) -> Tuple[float, str, Optional[Dict[str, float]]]:
    """(ms per call, "profiler" or "cuda_events", device ms by kernel or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts: Dict[str, int] = {}
        for e in events:
            counts[e.name] = counts.get(e.name, 0) + 1
        if events and all(n % iters == 0 for n in counts.values()):
            by_kernel: Dict[str, float] = {}
            for e in events:
                name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
                name = name.split("(")[0]
                by_kernel[name] = by_kernel.get(name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / iters
            spans = [(e.time_range.start, e.time_range.end) for e in events]
            return _union_us(spans) / 1e3 / iters, "profiler", by_kernel
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, "cuda_events", None


def _inputs(bt: int, l: int, seed: int):
    _, h, p, n = ssm.dims(configs.get("mamba2-370m"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    x = rnd(bt, l, h, p).bfloat16()
    dt = torch.nn.functional.softplus(rnd(bt, l, h) + math.log(math.expm1(0.01)))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, a, rnd(bt, l, n).bfloat16(), rnd(bt, l, n).bfloat16()


def _swapped(lib_name: str, key: Optional[str], fn: Callable[[], object]):
    """fn timed with the library registered as ``key`` in ``build.SOURCES``
    (None: the committed one) loaded under ``lib_name``."""
    committed = build.load(lib_name)
    build._libs[lib_name] = committed if key is None else build.load(key)
    try:
        return device_ms(fn)
    finally:
        build._libs[lib_name] = committed


def _rounds(variants: Sequence[str], rounds: int, time_one) -> List[dict]:
    out = []
    for r in range(rounds):
        for v in (variants if r % 2 == 0 else list(reversed(variants))):
            ms, method, by_kernel = time_one(v)
            out.append({"round": r, "variant": v, "ms": ms, "method": method,
                        "ms_by_kernel": by_kernel})
            print(f"[exp] round {r} {v}: {ms:.4f} ms ({method})", file=sys.stderr, flush=True)
    return out


def run(what: Sequence[str], rounds: int = 2) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("these experiments time kernels on the card")
    q = configs.get("mamba2-370m").ssm.chunk
    out: dict = {"device": torch.cuda.get_device_name(0)}
    keys = {v: _register(v) for v in ABLATIONS
            if (v.startswith("fwd_") and "fwd_mma" in what)
            or (not v.startswith("fwd_") and "ablate" in what)}
    build.build_all([*keys.values(), "ssd_scan", "ssd_scan_bwd_mma"])
    if "ablate" in what or "heads" in what:
        x, dt, a, bm, cm = _inputs(2, 2048, seed=23)
        dy = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(24),
                         device="cuda").bfloat16()
        bwd = lambda: ops.ssd_scan_bwd(x, dt, a, bm, cm, q, dy, None)  # noqa: E731
        if "ablate" in what:
            names = ["base", *(v for v in keys if not v.startswith("fwd_"))]
            out["ablate"] = _rounds(names, rounds, lambda v: _swapped(
                "ssd_scan_bwd_mma", None if v == "base" else keys[v], bwd))
        if "heads" in what:
            def at(most):
                saved, ssd.BWD_HEADS_PER_BLOCK = ssd.BWD_HEADS_PER_BLOCK, int(most)
                try:
                    return device_ms(bwd)
                finally:
                    ssd.BWD_HEADS_PER_BLOCK = saved
            out["heads"] = _rounds([str(g) for g in (1, 2, 4, 8, 16, 32)], rounds, at)
        del x, dt, a, bm, cm, dy
    if "fwd_mma" in what:
        out["fwd_mma"] = {}
        for shape, (bt, l, seed) in (("serve", (4, 512, 4)), ("train", (2, 2048, 23))):
            args = _inputs(bt, l, seed)
            fwd = lambda: ops.ssd_scan(*args, chunk=q, return_state=True)  # noqa: E731
            out["fwd_mma"][shape] = _rounds(["committed", "fwd_volatile_mma"], rounds,
                                            lambda v: _swapped(
                                                "ssd_scan", keys.get(v), fwd))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", default="ablate,heads,fwd_mma")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    res = run(args.what.split(","), args.rounds)
    text = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
