"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own:

1. build    — compile every CUDA kernel of the port (one nvcc per source,
              all started together), print the build seconds and each
              kernel instantiation's registers and spills from ptxas (the
              full report goes to chiprun_out/build_ptxas.log), and fail if
              a tensor-core instantiation (flash's wgmma, the SSD scan's
              mma), an RG-LRU scan instantiation (forward or backward) or
              an SSD backward instantiation spills.
2. kernels  — each kernel on the card against its plain PyTorch version on
              the same inputs, at the stated tolerances:
              flash attention: the 7 reference cases, block-shape
              invariance, ragged rejection, the yi-9b serving shape; head
              dim 256 cases (one with window < L) and the recurrentgemma-9b
              prefill shape; the wgmma variant's own bf16 cases (every head
              dim 16–256, GQA groups 1–16, L = 100, 192, 576, non-causal);
              a sliding window without causal masking on both variants;
              both serving shapes must run the wgmma variant, and the FMA
              variant is timed in fp32 at the yi-9b shape;
              ssd_scan: the 4 reference cases and the mma variant's bf16
              cases (P 16–128, N 16–128, Q 16–256, 1–8 chunks, a stress
              case whose cum passes −100), all with the final state at
              2e-4, chunk invariance, ragged rejection, the mamba2-370m
              serving shape, which must run the mma variant, and the fma
              variant timed in fp32 at that shape;
              rglru_scan: the 4 reference cases, the long carry, the edge
              cases (L = 1, 100, 300; W = 6, 100) and a long one (L 4096),
              each on the variant its width picks, ragged rejection, the
              recurrentgemma-9b serving shape, which must run the vec4
              variant, timed also with L2 flushed before each call
              (ms_cold) and beside torch.add over the same bytes
              (same_bytes_add_ms: the rate the memory gives this traffic).
              The backward kernels (rglru_scan_bwd, ssd_scan_bwd) through
              the ops Functions against autograd of the plain versions:
              the RG-LRU cases and a padded L (300 → 512); the SSD
              reference cases in fp32 and bf16 with and without a
              final-state gradient, the mma cases (stress case included)
              in fp32 and bf16, and a padded L (200 → 256); fp32 at
              atol = rtol = 1e-4, bf16 dx/dB/dC at rtol 1e-2 (atol 1e-3
              of their scale), ddt and da at 1e-4 of their scale; each
              timed at its training shape.
              Each serving shape is timed: kernel / plain / library / bound,
              as device time from a torch.profiler trace, split by device
              kernel in ms_by_kernel (the host-clock time of a wrapper call
              is reported beside it as call_ms).
3. model    — the yi-9b, mamba2-370m and recurrentgemma-9b smoke configs in
              fp32 on the card (kernels) and on the CPU (plain): prefill
              logits within 1e-4, equal greedy tokens.
4. serve    — launch/serve at full width (random weights from a seed, fp32
              master weights on the card), batch 4, prompt 512, 32 generated
              tokens, for yi-9b, mamba2-370m and recurrentgemma-9b; each
              kernel's launches counted from 0 per arch and required to be
              exactly what one prefill of that arch runs, every flash launch
              of the bf16 serving path by the wgmma variant, every ssd_scan
              launch by the mma variant and every rglru_scan launch by the
              vec4 variant.
5. workflow — the ByRedundant serve workflow at full width on the port's
              LocalRunner, for yi-9b and mamba2-370m: exactly one detok
              completion, launches per decode replica, and the committed
              tokens equal a direct greedy_generate call.
6. train    — yi-9b at full width, depth cut to 4 layers (bf16 compute, fp32
              master weights, remat "dots"), batch 2 × 2048 tokens of
              synthetic data: 3 steps of make_train_step from a seeded
              state; each step's loss, grad norm, ms (host clock, ended by
              a synchronise), tokens/s, peak memory and flash launches, all
              of them wgmma and as many as the remat policy implies; every
              attention weight of every layer must get a nonzero gradient;
              one more step traced by torch.profiler (device time by class);
              then the same 3 steps with attention differentiated through
              the dense plain version, the step-1 loss and grad norm held
              to the flash path's.
6b. recurrent train — mamba2-370m at full width and depth (48 layers,
              batch 2 × 2048) and recurrentgemma-9b at full width with one
              (rglru, rglru, local) group of 3 layers (batch 1 × 4096),
              remat "dots", 3 steps each: loss, grad norm, ms, tokens/s,
              peak memory, launches per step exactly the forwards twice and
              each backward kernel once a scan layer, nonzero first
              moments for every scan-layer weight, one traced step; then
              the same steps with both scans differentiated by autograd
              through their plain versions, step 1 held to within 5e-2.
7. grads    — the flash Function (kernel forward, FA2 backward) against
              autograd through the dense plain version on the card: fp32
              on the fma variant, bf16 on wgmma at hd 128.
8. commit   — the committed trainer at examples/train_pipeline.py's "20m"
              preset, 12 steps in chunks of 4, uninterrupted and with the
              primary controller killed after chunk 2: the same final step,
              losses within 1e-4, one commit per chunk.
9. refuse   — the flash wrapper called outside the flash Function on
              inputs that need a gradient raises NotImplementedError
              instead of dropping the gradient; a backward through the
              mamba2-370m and recurrentgemma-9b smoke configs on the card
              runs through each scan's backward kernel.

Phase 2 also holds the flash kernels' log-sum-exp (the backward's input)
against the plain version on both variants and times the forward with it
at the training shape.

The line before the last is one JSON object with a row per kernel
(flash_attention, ssd_scan, rglru_scan, ssd_scan_bwd, rglru_scan_bwd); the last
line is ``{"ok": true, "device": {...}}``.  Without a card it exits 1 and
prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.convert import tree_to  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.profile_serve import _union_us, kernel_class  # noqa: E402
from repro_torch.models import attention, flash, lm, rglru, ssm  # noqa: E402
from repro_torch.serve import workflow  # noqa: E402
from repro_torch.serve.engine import greedy_generate  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.commit import CommittedTrainer, batch_to  # noqa: E402
from repro_torch.train.step import make_train_step, train_state_init  # noqa: E402

# the serving point of every arch below (bf16 compute)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
YI = configs.get("yi-9b")
YI_SHAPE = (SERVE_BATCH, SERVE_PROMPT, YI.n_heads, YI.n_kv_heads, YI.hd)
MAMBA = configs.get("mamba2-370m")
RG = configs.get("recurrentgemma-9b")
RG_SHAPE = (SERVE_BATCH, SERVE_PROMPT, RG.n_heads, RG.n_kv_heads, RG.hd)
# the training point: yi-9b's width at 4 layers (the full 48 would need ~140
# GB of parameters, gradients and moments), batch 2 × 2048 tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
YI_TRAIN = YI.replace(n_layers=4, remat="dots")
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, YI.n_heads, YI.n_kv_heads, YI.hd)

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

#: the flash-attention variant's source (the row's "source" names the variant run)
FLASH_SOURCES = {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_sm90.cuh",
                 "fma": "src/repro_torch/kernels/csrc/flash_attention.cu"}

#: the SSD-scan variant's source
SSD_SOURCES = {"mma": "src/repro_torch/kernels/csrc/ssd_scan_sm90.cuh",
               "fma": "src/repro_torch/kernels/csrc/ssd_scan.cu"}

# recurrent training: mamba2-370m at full width and depth, batch 2 × 2048;
# recurrentgemma-9b at full width, depth cut from 38 layers to one (rglru,
# rglru, local) group (its 9 B parameters, gradients and two moments need
# ~140 GB), batch 1 × 4096 so that the 2048 window binds
MAMBA_TRAIN_BATCH = 2
MAMBA_TRAIN = MAMBA.replace(remat="dots")
RG_TRAIN_BATCH, RG_TRAIN_SEQ = 1, 4096
RG_TRAIN = RG.replace(n_layers=3, remat="dots")

KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cuh",
                        "src/repro/kernels/flash_attention.py:96"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan_sm90.cuh",
                 "src/repro/kernels/ssd_scan.py:75"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:60"),
    "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                     "no TPU kernel: counterpart of JAX autodiff of src/repro/models/ssm.py:99"),
    "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "no TPU kernel: counterpart of JAX autodiff of "
                       "src/repro/models/rglru.py:62"),
}


def _log(msg: str) -> None:
    print(msg, flush=True)


def _fail(msg: str) -> None:
    raise SystemExit(f"[chip_smoke] FAIL: {msg}")


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _device_profile(fn, iters: int = 20, warmup: int = 3):
    """Device time per call, the union of the device intervals in a
    torch.profiler trace of ``iters`` calls over ``iters``, and each device
    kernel's time per call by name (arguments dropped).  A trace that comes
    back without device events (seen once in a run of many traces), or with
    a kernel recorded a number of times that is not a multiple of ``iters``
    (seen once: 7 of 20 launches of one kernel kept), is taken again; after
    three such traces the time is taken with CUDA events, host gaps
    included, and there is no split by kernel (None)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts = {}
        for e in events:
            counts[e.name] = counts.get(e.name, 0) + 1
        if events and all(n % iters == 0 for n in counts.values()):
            break
        _log("[kernels] torch.profiler recorded no device time or not every launch; "
             "tracing again")
    else:
        _log("[kernels] no device time in three traces: timing with CUDA events")
        return _time_ms(fn, iters, 0), None
    by_kernel = {}
    for e in events:
        name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = name.split("(")[0]
        by_kernel[name] = by_kernel.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / iters
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    return _union_us(spans) / 1e3 / iters, by_kernel


def _device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    return _device_profile(fn, iters, warmup)[0]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _qkv(b, l, h, hkv, hd, dtype, seed):
    g = _gen(seed)
    mk = lambda n: torch.randn((b, l, n, hd), generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(h), mk(hkv), mk(hkv)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _check(what: str, got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float) -> float:
    torch.cuda.synchronize()
    err = _max_err(got, want)
    _log(f"[kernels] {what}: max|d|={err:.3e} (atol {atol}, rtol {rtol})")
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        _fail(f"{what} max|d| {err}")
    return err


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _row(name: str, err: float, kernel, plain, nbytes: int, flops: int,
         dtype: torch.dtype, library, shape: str) -> dict:
    """One kernel's line.  ``kernel``, ``plain`` and ``library`` are
    zero-argument calls (``library`` may be None); ms, plain_ms and library_ms
    are their device times, call_ms the kernel wrapper's host-clock time per
    call.  The least time for the same work is the larger of its bytes (each
    input read once, each output written once) at the memory rate and its
    operations at the inputs' type peak."""
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    source, replaces = KERNELS[name]
    (kernel_ms, by_kernel), plain_ms = _device_profile(kernel), _device_ms(plain)
    library_ms = _device_ms(library) if library is not None else None
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": None, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "shape": shape, "call_ms": _time_ms(kernel),
           "ms_by_kernel": by_kernel}
    lib = f"{library_ms:.4f}" if library_ms is not None else "null"
    split = (", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()) if by_kernel
             else "not traced")
    _log(f"[kernels] {name} at {shape}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
         f"library_ms={lib} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}: "
         f"{nbytes} B, {flops} FLOP); call_ms={row['call_ms']:.4f} (host clock); "
         f"by device kernel: {split}")
    return row


def _ptxas_report(log: str) -> list:
    """(function, registers, spill stores, spill loads) per kernel
    instantiation in an ``nvcc -Xptxas -v`` log."""
    rows, fn, spills = [], None, None
    for line in log.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ")[1].strip()
        elif fn and "spill stores" in line:
            n = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (n[1], n[2])
        elif fn and spills and "Used " in line and " registers" in line:
            regs = int(line.split("Used ")[1].split()[0])
            rows.append((fn, regs, *spills))
            fn, spills = None, None
    return rows


def phase_build() -> dict:
    t0 = time.perf_counter()
    info = build.build_all()
    _log(f"[build] {sorted(info)} built in {time.perf_counter() - t0:.2f}s")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "build_ptxas.log"), "w") as f:
        for name, i in info.items():
            f.write(f"== {name}\n{i['log']}\n")
    for name, i in info.items():
        _log(f"[build] {name}: nvcc {i['seconds']:.2f}s")
        for line in i["log"].splitlines():
            if "Performance Loss" in line or "setmaxnreg" in line:
                _log(f"[build]   {line.strip()}")
        for fn, regs, stores, loads in _ptxas_report(i["log"]):
            _log(f"[build]   {fn}: {regs} registers, {stores} bytes spill stores, "
                 f"{loads} bytes spill loads")
            if ("wgmma" in fn or "ssd_sm90" in fn or "rglru_scan" in fn
                    or name == "ssd_scan_bwd") and (stores or loads):
                _fail(f"instantiation {fn} spills ({stores}/{loads} bytes)")
    return info


# ==========================================================================
# 2. kernels
# ==========================================================================


def _flash_case(b, l, h, hkv, hd, window, cap, dtype_name, tol) -> None:
    dtype = getattr(torch, dtype_name)
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=l + h)
    out = ops.flash_attention(q, k, v, causal=True, window=window, softcap=cap,
                              block_q=128, block_k=128)
    expect = ref.flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap)
    _check(f"flash b={b} l={l} h={h} hkv={hkv} hd={hd} window={window} cap={cap} "
           f"{dtype_name}", out, expect, tol, tol)


def _flash_wgmma_case(b, l, h, hkv, hd, causal, window, cap) -> None:
    q, k, v = _qkv(b, l, h, hkv, hd, torch.bfloat16, seed=l + h + hd)
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                              block_q=l, block_k=l)
    if ops.flash_variant_launches != {**n0, "wgmma": n0["wgmma"] + 1}:
        _fail(f"bf16 hd {hd} did not run the wgmma variant")
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    _check(f"flash wgmma b={b} l={l} h={h} hkv={hkv} hd={hd} causal={causal} "
           f"window={window} cap={cap} bfloat16", out, expect, 2e-2, 2e-2)


def _flash_window_case(b, l, h, hkv, hd, window, dtype_name, tol) -> None:
    """A sliding window without causal masking, as the reference's kernel
    applies it: fp32 on the fma variant, bf16 on wgmma."""
    dtype = getattr(torch, dtype_name)
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=l + hd + window)
    want = "fma" if dtype == torch.float32 else "wgmma"
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=False, window=window, block_q=l, block_k=l)
    if ops.flash_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"flash {dtype_name} hd {hd} did not run the {want} variant")
    expect = ref.flash_attention_plain(q, k, v, causal=False, window=window)
    _check(f"flash ({want}) non-causal window b={b} l={l} h={h} hkv={hkv} hd={hd} "
           f"window={window} {dtype_name}", out, expect, tol, tol)


def _flash_at(shape, dtype, seed) -> dict:
    """flash attention at a serving prefill shape, timed against its plain
    version and the library call; the work is the unmasked causal pairs."""
    b, l, h, hkv, hd = shape
    want = fa.variant(hd, dtype)
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=seed)
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=True, block_q=attention.FLASH_BLOCK,
                              block_k=attention.FLASH_BLOCK)
    if ops.flash_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"flash at {shape} {dtype} did not run the {want} variant")
    expect = ref.flash_attention_ref(q, k, v, causal=True)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    err = _check(f"flash ({want}) at {shape} {str(dtype)[6:]}", out, expect, tol, tol)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = int(attention.make_causal_mask(l, l, device="cuda").sum())
    row = _row("flash_attention", err, lambda: ops.flash_attention(q, k, v, causal=True),
               lambda: ref.flash_attention_ref(q, k, v, causal=True),
               _nbytes(q, k, v, out), 4 * b * h * hd * pairs, dtype,
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               f"q {list(q.shape)}, k/v {list(k.shape)} {str(dtype)[6:]}")
    row["variant"], row["source"] = want, FLASH_SOURCES[want]
    return row


def _flash_lse_case(b, l, h, hkv, hd, window, cap, dtype, tol) -> float:
    """The kernel's lse against the plain version's; the output is the same
    as without lse, bit for bit."""
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=l + hd + 3)
    want = fa.variant(hd, dtype)
    kw = dict(causal=True, window=window, softcap=cap, block_q=l, block_k=l)
    n0 = dict(ops.flash_variant_launches)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    if ops.flash_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"flash with lse at hd {hd} {dtype} did not run the {want} variant")
    if not torch.equal(out, ops.flash_attention(q, k, v, **kw)):
        _fail(f"flash ({want}) output changes when lse is stored")
    _, lse_ref = ref.flash_attention_plain_lse(q, k, v, causal=True, window=window,
                                               softcap=cap)
    return _check(f"flash ({want}) lse b={b} l={l} h={h} hkv={hkv} hd={hd} window={window} "
                  f"cap={cap} {str(dtype)[6:]}", lse, lse_ref, tol, tol)


def _flash_train_shape() -> dict:
    """The forward with lse at the training shape, as the training step
    launches it (wgmma, bf16), timed against its plain version and the
    library call; lse [B,H,L] fp32 is one more output."""
    b, l, h, hkv, hd = TRAIN_SHAPE
    q, k, v = _qkv(b, l, h, hkv, hd, torch.bfloat16, seed=7)
    n0 = dict(ops.flash_variant_launches)
    out, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    if ops.flash_variant_launches != {**n0, "wgmma": n0["wgmma"] + 1}:
        _fail("flash at the training shape did not run the wgmma variant")
    out_ref, lse_ref = ref.flash_attention_plain_lse(q, k, v, causal=True)
    err = _check(f"flash (wgmma) at the training shape {list(q.shape)} bfloat16", out, out_ref,
                 2e-2, 2e-2)
    lse_err = _check("flash (wgmma) lse at the training shape", lse, lse_ref, 1e-4, 1e-4)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = l * (l + 1) // 2
    row = _row("flash_attention", err,
               lambda: ops.flash_attention(q, k, v, causal=True, return_lse=True),
               lambda: ref.flash_attention_plain_lse(q, k, v, causal=True),
               _nbytes(q, k, v, out, lse), 4 * b * h * hd * pairs, torch.bfloat16,
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               f"q {list(q.shape)}, k/v {list(k.shape)} bfloat16, with lse [{b},{h},{l}] fp32")
    row["lse_max_abs_err"] = lse_err
    return row


def phase_flash_lse() -> tuple:
    """lse on both variants: fma on the reference's fp32 cases (1e-5), wgmma
    at hd 64, 128 and 256 (1e-4: its exponentials are ex2.approx), and the
    training shape; returns (largest lse error, the training shape's row)."""
    errs = [_flash_lse_case(b, l, h, hkv, hd, window, cap, torch.float32, 1e-5)
            for (b, l, h, hkv, hd, window, cap, dt, _) in ref.FLASH_CASES if dt == "float32"]
    for case in ((2, 256, 8, 4, 64, 0, 0.0), (1, 576, 32, 4, 128, 0, 50.0),
                 (1, 256, 4, 1, 256, 64, 0.0)):
        errs.append(_flash_lse_case(*case, torch.bfloat16, 1e-4))
    row = _flash_train_shape()
    return max(errs + [row["lse_max_abs_err"]]), row


def phase_flash() -> dict:
    for case in ref.FLASH_CASES + ref.FLASH_HD256_CASES:
        _flash_case(*case)
    for case in ref.FLASH_WGMMA_CASES:
        _flash_wgmma_case(*case)
    for case in ref.FLASH_WINDOW_CASES:
        _flash_window_case(*case)
    q, k, v = _qkv(1, 512, 4, 2, 64, torch.float32, seed=0)
    o1 = ops.flash_attention(q, k, v, block_q=64, block_k=128)
    o2 = ops.flash_attention(q, k, v, block_q=256, block_k=64)
    inv = _max_err(o1, o2)
    _log(f"[kernels] flash block-shape invariance max|d|={inv:.3e}")
    if inv > 1e-5:
        _fail("block-shape invariance")
    z = torch.zeros((1, 100, 4, 64), device="cuda")
    try:
        ops.flash_attention(z, z[:, :, :4], z[:, :, :4], block_q=64, block_k=64)
    except ValueError:
        _log("[kernels] flash ragged shape rejected with ValueError")
    else:
        _fail("flash ragged shape was not rejected")
    row = _flash_at(YI_SHAPE, YI.cdtype, seed=1)
    if row["variant"] != "wgmma" or fa.variant(RG.hd, RG.cdtype) != "wgmma":
        _fail("a bf16 serving shape does not take the wgmma variant")
    others = [_flash_at(RG_SHAPE, RG.cdtype, seed=2),
              _flash_at(YI_SHAPE, torch.float32, seed=1)]    # the FMA variant's time
    row["at_other_shapes"] = [{k: r[k] for k in (
        "shape", "variant", "source", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "call_ms")} for r in others]
    row["lse_max_err"], train_row = phase_flash_lse()
    row["at_train_shape"] = {k: train_row[k] for k in (
        "shape", "max_abs_err", "lse_max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "call_ms", "ms_by_kernel")}
    return row


def _ssd_inputs(bt, l, h, p, n, dtype, seed, dt0=None):
    """The reference test's recipe, dt = softplus(N(0,1)) and a =
    −exp(linspace(0, 2)); with ``dt0`` the model's, dt = softplus(N(0,1) +
    log(expm1(dt0))) and a = −linspace(1, 16), as ref.SSD_MMA_CASES."""
    g = _gen(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    x = rnd(bt, l, h, p).to(dtype)
    if dt0 is None:
        dt = torch.nn.functional.softplus(rnd(bt, l, h))
        a = -torch.exp(torch.linspace(0.0, 2.0, h, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(rnd(bt, l, h) + math.log(math.expm1(dt0)))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, a, rnd(bt, l, n).to(dtype), rnd(bt, l, n).to(dtype)


def _ssd_case(what: str, args, chunk: int, tol: float) -> str:
    """One call with the final state against the plain version: y at
    ``tol``, the state at 2e-4; returns the variant that ran."""
    n0 = dict(ops.ssd_variant_launches)
    y, h_last = ops.ssd_scan(*args, chunk=chunk, return_state=True)
    ran = [k for k in n0 if ops.ssd_variant_launches[k] != n0[k]]
    y_ref, h_ref = ref.ssd_chunked(*args, min(chunk, args[0].shape[1]))
    _check(f"{what} ({'/'.join(ran)})", y, y_ref, tol, tol)
    _check(f"{what} final state", h_last, h_ref, 2e-4, 2e-4)
    return ran[0]


def _ssd_at(dtype: torch.dtype) -> dict:
    """ssd_scan at the mamba2-370m prefill shape (2 chunks of 256, so the
    carry is used; A = −linspace(1, 16), dt = softplus(N(0,1) + dt_bias) as
    the model's init), timed against its plain version."""
    _, nh, p, n = ssm.dims(MAMBA)
    q = MAMBA.ssm.chunk
    want = ssd.variant(p, n, q, dtype)
    args = _ssd_inputs(SERVE_BATCH, SERVE_PROMPT, nh, p, n, dtype, seed=4, dt0=0.01)
    n0 = dict(ops.ssd_variant_launches)
    y, h_last = ops.ssd_scan(*args, chunk=q, return_state=True)
    if ops.ssd_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"ssd_scan at the mamba2-370m shape {dtype} did not run the {want} variant")
    y_ref, h_ref = ref.ssd_chunked(*args, q)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
    err = _check(f"ssd_scan ({want}) at the mamba2-370m shape {list(args[0].shape)} "
                 f"{str(dtype)[6:]}", y, y_ref, tol, tol)
    _check(f"ssd_scan ({want}) final state at the mamba2-370m shape", h_last, h_ref,
           2e-4, 2e-4)
    # products the function needs: C·Bᵀ over the causal pairs of each
    # (batch, chunk), shared by the heads; per head the masked scores times
    # X, C·h_prevᵀ, and the state update Xᵀ(B ⊙ w)
    nc, pairs = SERVE_PROMPT // q, q * (q + 1) // 2
    flops = (2 * SERVE_BATCH * nc * pairs * n
             + 2 * SERVE_BATCH * nc * nh * (pairs * p + 2 * q * p * n))
    row = _row("ssd_scan", err, lambda: ops.ssd_scan(*args, chunk=q, return_state=True),
               lambda: ref.ssd_chunked(*args, q), _nbytes(*args, y, h_last), flops,
               dtype, None, f"x {list(args[0].shape)}, B/C {list(args[3].shape)}, chunk {q} "
               f"{str(dtype)[6:]}")
    row["variant"], row["source"] = want, SSD_SOURCES[want]
    row["library_null_because"] = "no PyTorch call computes the chunked SSD scan"
    return row


def phase_ssd() -> dict:
    for (bt, l, h, p, n, chunk, dtype_name, tol) in ref.SSD_CASES:
        args = _ssd_inputs(bt, l, h, p, n, getattr(torch, dtype_name), seed=l + p)
        _ssd_case(f"ssd_scan bt={bt} l={l} h={h} p={p} n={n} chunk={chunk} {dtype_name}",
                  args, chunk, tol)
    for case in ref.SSD_MMA_CASES:
        bt, l, h, p, n, chunk = case
        args = _ssd_inputs(bt, l, h, p, n, torch.bfloat16, seed=l + p, dt0=ref.ssd_dt0(case))
        if case == ref.SSD_STRESS_CASE:
            cum = torch.cumsum((args[1] * args[2]).reshape(bt, l // chunk, chunk, h), dim=2)
            _log(f"[kernels] ssd_scan stress case: min cum in a chunk {float(cum.min()):.1f}")
            if not -200.0 < float(cum.min()) < -100.0:
                _fail("the stress case's cum does not lie between -200 and -100")
        ran = _ssd_case(f"ssd_scan mma case bt={bt} l={l} h={h} p={p} n={n} chunk={chunk} "
                        f"bfloat16 dt0={ref.ssd_dt0(case)}", args, chunk, 5e-2)
        if ran != "mma":
            _fail(f"ssd_scan case {case} ran the {ran} variant, not mma")
    args = _ssd_inputs(1, 256, 2, 16, 32, torch.float32, seed=3)
    _check("ssd_scan chunk invariance (32 vs 128)", ops.ssd_scan(*args, chunk=32),
           ops.ssd_scan(*args, chunk=128), 5e-4, 5e-4)
    try:
        ops.ssd_scan(*(t[:, :100] if t.dim() > 1 else t for t in args), chunk=64)
    except ValueError:
        _log("[kernels] ssd_scan ragged L rejected with ValueError")
    else:
        _fail("ssd_scan ragged L was not rejected")

    row = _ssd_at(MAMBA.cdtype)
    if row["variant"] != "mma":
        _fail("the mamba2-370m serving shape does not take the mma variant")
    other = _ssd_at(torch.float32)                       # the fma variant's time
    row["at_other_shapes"] = [{k: other[k] for k in (
        "shape", "variant", "source", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "call_ms", "ms_by_kernel")}]
    return row


def _rglru_inputs(bt, l, w, dtype, seed):
    g = _gen(seed)
    log_a = -torch.nn.functional.softplus(torch.randn((bt, l, w), generator=g, device="cuda"))
    b = torch.randn((bt, l, w), generator=g, device="cuda").to(dtype).float() * 0.1
    return log_a, b


def _rglru_case(bt, l, w, bl, bw, dtype_name, tol) -> None:
    log_a, b = _rglru_inputs(bt, l, w, getattr(torch, dtype_name), seed=w + l)
    want = rg.variant(w)
    n0 = dict(ops.rglru_variant_launches)
    h = ops.rglru_scan(log_a, b, block_l=bl, block_w=bw)
    if ops.rglru_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"rglru_scan at W={w} did not run the {want} variant")
    _check(f"rglru_scan ({want}) bt={bt} l={l} w={w} bl={bl} bw={bw} {dtype_name}", h,
           ref.rglru_scan_ref(log_a, b), tol, 1e-3)


def _cold_ms(fn, kernel: str) -> float:
    """Device time per call of the device kernels named ``kernel`` with the
    50 MB L2 flushed before each call by writing a 256 MB buffer; the
    flush's own kernel is left out.  Without a split by kernel (see
    _device_profile), the flush's own time is subtracted instead."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def call():
        flush.fill_(1.0)
        fn()
    total, by_kernel = _device_profile(call)
    if by_kernel is None:
        return total - _time_ms(lambda: flush.fill_(1.0))
    return sum(ms for name, ms in by_kernel.items() if kernel in name)


def phase_rglru() -> dict:
    for case in ref.RGLRU_CASES + ref.RGLRU_EDGE_CASES:
        _rglru_case(*case)
    log_a, b = _rglru_inputs(1, 128, 64, torch.float32, seed=0)
    try:
        ops.rglru_scan(log_a[:, :100], b[:, :100], block_l=64, block_w=32)
    except ValueError:
        _log("[kernels] rglru_scan ragged L rejected with ValueError")
    else:
        _fail("rglru_scan ragged L was not rejected")

    # the recurrentgemma-9b prefill shape: 2 of the kernel's 256-step tiles
    log_a, b = _rglru_inputs(SERVE_BATCH, SERVE_PROMPT, rglru.width(RG), torch.float32,
                             seed=5)
    want = rg.variant(log_a.shape[2])
    n0 = dict(ops.rglru_variant_launches)
    h = ops.rglru_scan(log_a, b)
    if want != "vec4" or ops.rglru_variant_launches != {**n0, "vec4": n0["vec4"] + 1}:
        _fail("the recurrentgemma-9b serving shape does not take the vec4 variant")
    err = _check(f"rglru_scan (vec4) at the recurrentgemma-9b shape {list(log_a.shape)}", h,
                 ref.rglru_scan_ref(log_a, b), 1e-5, 1e-3)
    row = _row("rglru_scan", err, lambda: ops.rglru_scan(log_a, b),
               lambda: ref.rglru_scan_ref(log_a, b), _nbytes(log_a, b, h),
               3 * log_a.numel(), torch.float32, None, f"log_a/b/h {list(log_a.shape)}")
    row["variant"] = want
    row["ms_cold"] = _cold_ms(lambda: ops.rglru_scan(log_a, b), "rglru_scan_kernel")
    out = torch.empty_like(h)
    row["same_bytes_add_ms"] = _device_ms(lambda: torch.add(log_a, b, out=out))
    _log(f"[kernels] rglru_scan at {row['shape']} with L2 flushed before each call: "
         f"ms_cold={row['ms_cold']:.4f}; torch.add over the same bytes (two reads, "
         f"one write): {row['same_bytes_add_ms']:.4f} ms")
    row["library_null_because"] = ("no PyTorch call computes a first-order linear "
                                   "recurrence")
    return row


# ==========================================================================
# 2b. the scans' backward kernels against autograd of their plain versions
# ==========================================================================


def _rglru_bwd_case(bt, l, w, dtype_name, pad_to=0) -> float:
    """The RG-LRU Function (kernel forward, kernel backward) against autograd
    through the plain version: dlog_a and db at atol = rtol = 1e-4.  With
    ``pad_to`` the call goes through models/rglru._scan, which pads L to a
    multiple of 256 with log_a = 0 (a = 1) and slices the padding off."""
    log_a, b = _rglru_inputs(bt, l, w, getattr(torch, dtype_name), seed=w + l + 1)
    dh = torch.randn((bt, l, w), generator=_gen(w + l + 2), device="cuda")
    want = rg.variant(w)
    la, bb = log_a.clone().requires_grad_(), b.clone().requires_grad_()
    n0, v0 = ops.launches["rglru_scan_bwd"], dict(ops.rglru_bwd_variant_launches)
    h = rglru._scan(la, bb) if pad_to else ops.rglru_scan(la, bb, block_l=l, block_w=w)
    h.backward(dh)
    if (ops.launches["rglru_scan_bwd"] != n0 + 1
            or ops.rglru_bwd_variant_launches != {**v0, want: v0[want] + 1}):
        _fail(f"rglru_scan backward at W={w} did not launch the {want} backward kernel once")
    d_la, d_b = ref.rglru_scan_bwd_plain(log_a, b, dh)
    what = f"rglru_scan_bwd ({want}) bt={bt} l={l}{f' padded to {pad_to}' if pad_to else ''} w={w}"
    return max(_check(f"{what} dlog_a", la.grad, d_la, 1e-4, 1e-4),
               _check(f"{what} db", bb.grad, d_b, 1e-4, 1e-4))


def _check_grad(what: str, name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """An SSD gradient against the plain version's.  ddt and da are fp32
    sums of many terms: 1e-4 relative, with atol 1e-4 of the tensor's
    largest value (an entry near zero carries the summation order's error at
    the scale of the largest term).  dx, dB, dC: fp32 at atol = rtol = 1e-4;
    bf16 at rtol 1e-2 (one bf16 rounding of the result) and atol 1e-3 of the
    largest value."""
    scale = float(want.float().abs().max())
    if name in ("ddt", "da"):
        return _check(what, got, want, 1e-4 * scale, 1e-4)
    if want.dtype == torch.bfloat16:
        return _check(what, got, want, 1e-3 * scale, 1e-2)
    return _check(what, got, want, 1e-4, 1e-4)


def _ssd_bwd_case(what: str, args, chunk: int, with_state: bool, pad: int = 0) -> float:
    """The SSD Function (kernel forward, kernel backward) against autograd
    through the plain version, with or without a gradient of the final
    state; with ``pad`` rows of zeros appended as models/ssm pads (dt = 0).
    Tolerances as :func:`_check_grad`."""
    x = args[0]
    g = _gen(x.shape[1] + x.shape[3] + 7)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    dh = (torch.randn((x.shape[0], x.shape[2], x.shape[3], args[3].shape[-1]), generator=g,
                      device="cuda") if with_state else None)
    leaves = [t.clone().requires_grad_() for t in args]

    def padded(ts):
        if not pad:
            return ts
        return [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if t.dim() > 1
                else t for t in ts]

    n0 = ops.launches["ssd_scan_bwd"]
    y, h_last = ops.ssd_scan(*padded(leaves), chunk=chunk, return_state=True)
    outs, cots = [y[:, :x.shape[1]]], [dy]
    if with_state:
        outs.append(h_last)
        cots.append(dh)
    torch.autograd.backward(outs, cots)
    if ops.launches["ssd_scan_bwd"] != n0 + 1:
        _fail(f"{what}: the backward did not launch ssd_scan_bwd once")
    plain = [t.clone().requires_grad_() for t in args]
    y2, h2 = ref.ssd_chunked(*padded(plain), chunk)
    outs2, cots2 = [y2[:, :x.shape[1]]], [dy]
    if with_state:
        outs2.append(h2)
        cots2.append(dh)
    torch.autograd.backward(outs2, cots2)
    return max(_check_grad(f"{what} {name}", name, a.grad, b.grad)
               for name, a, b in zip(("dx", "ddt", "da", "dB", "dC"), leaves, plain))


def _ssd_bwd_flops(bt, l, h, p, n, q) -> int:
    """Products the SSD backward needs: per (batch, chunk) C·Bᵀ over the
    causal pairs (shared by the heads); per head r = dy·xᵀ over the pairs,
    the three pair products into dx, dB, dC, and six [Q,P]×[P,N]-sized
    state products (S_c, U_c, dS·B, dSᵀ·x, h_in·C, h_inᵀ·dy)."""
    nc, pairs = l // q, q * (q + 1) // 2
    return (2 * bt * nc * pairs * n
            + 2 * bt * nc * h * (pairs * (2 * p + 2 * n) + 6 * q * p * n))


def phase_scan_bwd() -> dict:
    """Both backward kernels on the phase-2 cases, then each timed at its
    training shape; returns their rows."""
    errs = []
    for (bt, l, w, _, _, dtype_name, _) in ref.RGLRU_CASES + ref.RGLRU_EDGE_CASES:
        errs.append(_rglru_bwd_case(bt, l, w, dtype_name))
    errs.append(_rglru_bwd_case(2, 300, 64, "float32", pad_to=512))
    rg_err = max(errs)

    errs = []
    for (bt, l, h, p, n, chunk, dtype_name, _) in ref.SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(bt, l, h, p, n, dtype, seed=l + p)
            for st in (False, True):
                errs.append(_ssd_bwd_case(
                    f"ssd_scan_bwd bt={bt} l={l} h={h} p={p} n={n} chunk={chunk} "
                    f"{str(dtype)[6:]} state grad {st}", args, chunk, st))
    for case in ref.SSD_MMA_CASES:
        bt, l, h, p, n, chunk = case
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(bt, l, h, p, n, dtype, seed=l + p, dt0=ref.ssd_dt0(case))
            errs.append(_ssd_bwd_case(
                f"ssd_scan_bwd case {case} {str(dtype)[6:]} dt0={ref.ssd_dt0(case)}", args,
                chunk, True))
    args = _ssd_inputs(2, 200, 4, 32, 64, torch.bfloat16, seed=9, dt0=0.01)
    errs.append(_ssd_bwd_case("ssd_scan_bwd L 200 padded to 256 bfloat16", args, 128, True,
                              pad=56))
    ssd_err = max(errs)

    # the training shapes, each timed alone
    log_a, b = _rglru_inputs(1, RG_TRAIN_SEQ, rglru.width(RG), torch.float32, seed=21)
    h = ops.rglru_scan(log_a, b)
    dh = torch.randn(h.shape, generator=_gen(22), device="cuda")
    got = ops.rglru_scan_bwd(log_a, h, dh)
    want = ref.rglru_scan_bwd_plain(log_a, b, dh)
    err = max(_check(f"rglru_scan_bwd at the training shape {list(h.shape)} {n}", g_, w_,
                     1e-4, 1e-4) for n, g_, w_ in zip(("dlog_a", "db"), got, want))
    rg_row = _row("rglru_scan_bwd", max(err, rg_err), lambda: ops.rglru_scan_bwd(log_a, h, dh),
                  lambda: ref.rglru_scan_bwd_plain(log_a, b, dh), 5 * _nbytes(h),
                  5 * h.numel(), torch.float32, None, f"log_a/h/dh/dlog_a/db {list(h.shape)}")
    rg_row["variant"] = rg.variant(h.shape[2])
    rg_row["library_null_because"] = "no PyTorch call computes the recurrence's backward"
    del log_a, b, h, dh, got, want

    _, nh, p, n = ssm.dims(MAMBA)
    q = MAMBA.ssm.chunk
    x, dt, a, bm, cm = _ssd_inputs(MAMBA_TRAIN_BATCH, TRAIN_SEQ, nh, p, n, MAMBA.cdtype,
                                   seed=23, dt0=0.01)
    dy = torch.randn(x.shape, generator=_gen(24), device="cuda").to(x.dtype)
    got = ops.ssd_scan_bwd(x, dt, a, bm, cm, q, dy, None)
    want = ref.ssd_scan_bwd_plain(x, dt, a, bm, cm, q, dy)
    err = max(_check_grad(f"ssd_scan_bwd at the training shape {list(x.shape)} {nm}", nm,
                          g_, w_) for nm, g_, w_ in zip(("dx", "ddt", "da", "dB", "dC"), got, want))
    del got, want
    ssd_row = _row("ssd_scan_bwd", max(err, ssd_err),
                   lambda: ops.ssd_scan_bwd(x, dt, a, bm, cm, q, dy, None),
                   lambda: ref.ssd_scan_bwd_plain(x, dt, a, bm, cm, q, dy),
                   2 * _nbytes(x, dt, a, bm, cm) + _nbytes(dy),
                   _ssd_bwd_flops(MAMBA_TRAIN_BATCH, TRAIN_SEQ, nh, p, n, q), x.dtype, None,
                   f"x/dy {list(x.shape)} {str(x.dtype)[6:]}, B/C {list(bm.shape)}, chunk {q}")
    ssd_row["library_null_because"] = "no PyTorch call computes the chunked SSD backward"
    del x, dt, a, bm, cm, dy
    _free()
    return {"ssd_scan_bwd": ssd_row, "rglru_scan_bwd": rg_row}


# ==========================================================================
# 3. model: smoke configs, card against CPU
# ==========================================================================


def _model(arch: str, per_prefill: dict) -> None:
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    g = torch.Generator(device="cpu").manual_seed(3)
    params_cpu = lm.init(g, cfg, device="cpu")
    params_gpu = tree_to(params_cpu, "cuda")
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    _, logits_cpu = lm.prefill(params_cpu, cfg, toks, max_len=40)
    ops.reset_launches()
    _, logits_gpu = lm.prefill(params_gpu, cfg, toks.cuda(), max_len=40)
    launches = dict(ops.launches)
    if launches != per_prefill:
        _fail(f"{arch} smoke prefill on the card launched {launches}, not {per_prefill}")
    err = _max_err(logits_gpu.cpu(), logits_cpu)
    _log(f"[model] {arch} smoke fp32 prefill logits card vs cpu max|d|={err:.3e} "
         f"(tol 1e-4); launches {launches}")
    if not err <= 1e-4:
        _fail(f"{arch} card vs cpu prefill logits")
    t_cpu = greedy_generate(params_cpu, cfg, toks, 12)
    t_gpu = greedy_generate(params_gpu, cfg, toks.cuda(), 12).cpu()
    _log(f"[model] {arch} greedy tokens equal: {bool(torch.equal(t_cpu, t_gpu))}")
    if not torch.equal(t_cpu, t_gpu):
        _fail(f"{arch} card vs cpu greedy tokens differ")


def _expected_launches(cfg) -> dict:
    """Launches of one prefill: one flash per attention layer, one ssd_scan
    per Mamba2 layer, one rglru_scan per RG-LRU layer."""
    kinds = [cfg.pattern_of(i) for i in range(cfg.n_layers)]
    return {"flash_attention": sum(k in ("attn", "local") for k in kinds),
            "ssd_scan": kinds.count("ssm"), "rglru_scan": kinds.count("rglru"),
            "ssd_scan_bwd": 0, "rglru_scan_bwd": 0}


def _train_launches(cfg) -> dict:
    """Launches of one training step under remat "dots": every forward
    twice (the recompute runs it again), each scan's backward kernel once
    a layer (attention's backward is plain torch)."""
    once = _expected_launches(cfg)
    return {"flash_attention": 2 * once["flash_attention"], "ssd_scan": 2 * once["ssd_scan"],
            "rglru_scan": 2 * once["rglru_scan"], "ssd_scan_bwd": once["ssd_scan"],
            "rglru_scan_bwd": once["rglru_scan"]}


def phase_model() -> None:
    for arch in ("yi-9b", "mamba2-370m", "recurrentgemma-9b"):
        _model(arch, _expected_launches(configs.get_smoke(arch)))


# ==========================================================================
# 4. serve and 5. workflow at full width
# ==========================================================================


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(arch: str) -> dict:
    cfg = configs.get(arch)
    want = _expected_launches(cfg)
    ops.reset_launches()
    r = launch_serve.run(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                         gen=SERVE_GEN, seed=0, device="cuda")
    launches = dict(ops.launches)
    toks = r["tokens"]
    _log(f"[serve] {arch} full width ({cfg.n_layers}L d{cfg.d_model}): init "
         f"{r['init_s']:.2f}s, prefill {r['prefill_ms']:.3f} ms, decode "
         f"{r['decode_ms_per_token']:.3f} ms/token, {r['tok_s']:.2f} tok/s, peak mem "
         f"{r['peak_mem_gb']:.2f} GB, launches {launches}")
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN):
        _fail(f"{arch} generated shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.padded_vocab:
        _fail(f"{arch} generated ids out of range")
    if launches != want or r["launches"] != want or not any(want.values()):
        _fail(f"{arch} launches {launches} != {want} per prefill")
    variants = {"flash_attention": dict(ops.flash_variant_launches),
                "ssd_scan": dict(ops.ssd_variant_launches),
                "rglru_scan": dict(ops.rglru_variant_launches)}
    if variants["flash_attention"] != {**dict.fromkeys(fa.VARIANTS, 0),
                                       "wgmma": want["flash_attention"]}:
        _fail(f"{arch} flash launches by variant {variants['flash_attention']}: not all wgmma")
    if variants["ssd_scan"] != {**dict.fromkeys(ssd.VARIANTS, 0), "mma": want["ssd_scan"]}:
        _fail(f"{arch} ssd_scan launches by variant {variants['ssd_scan']}: not all mma")
    if variants["rglru_scan"] != {**dict.fromkeys(rg.VARIANTS, 0),
                                  "vec4": want["rglru_scan"]}:
        _fail(f"{arch} rglru_scan launches by variant {variants['rglru_scan']}: "
              "not all vec4")
    _log(f"[serve] {arch} launches by variant {variants}")
    del r, toks
    _free()
    return launches, variants


def phase_workflow(arch: str) -> None:
    cfg = configs.get(arch)
    per_prefill = _expected_launches(cfg)
    params = lm.init(_gen(1), cfg, device="cuda")
    ops.reset_launches()
    out = workflow.run(params, cfg, batch=2, prompt_len=16, steps=12)
    launches = dict(ops.launches)
    _log(f"[workflow] {arch}: {out['completions']} detok completion(s) in "
         f"{out['wall_s']:.2f}s; decode ran {out['decode_calls']}x across replicas; "
         f"launches {launches}")
    if out["completions"] != 1:
        _fail(f"{arch} serve workflow did not complete exactly once")
    want = {k: n * out["decode_calls"] for k, n in per_prefill.items()}
    if launches != want:
        _fail(f"{arch} workflow launches {launches} != {per_prefill} per decode replica")
    prompt = torch.tensor(workflow.prompt_ids(cfg, 2, 16, 7), device="cuda")
    direct = greedy_generate(params, cfg, prompt, 12).cpu().tolist()
    if direct != out["ids"]:
        _fail(f"{arch} workflow tokens differ from a direct greedy_generate call")
    _log(f"[workflow] {arch} committed tokens equal a direct greedy_generate call")
    del params
    _free()


# ==========================================================================
# 6. train, 7. grads, 8. commit, 9. refuse
# ==========================================================================


def _attn_moments_nonzero(state, cfg) -> bool:
    """Every attention weight of every layer had a nonzero gradient: its
    first moment after a step from zero is (1 − b1)·g, nonzero iff g is
    (weight decay moves the weight itself even without a gradient)."""
    m = state["opt"]["m"]["blocks"]
    return all(bool(m[f"s{i}"]["attn"][w][g].abs().max() > 0)
               for i in range(len(cfg.layer_pattern)) for w in ("wq", "wk", "wv", "wo")
               for g in range(lm.groups_of(cfg)[0]))


def phase_train() -> dict:
    """TRAIN_STEPS steps of make_train_step at yi-9b's width, then one step
    traced; returns the measurements and the flash launches of the steps."""
    cfg = YI_TRAIN
    per_step = 2 * cfg.n_layers            # remat "dots": each forward runs again
    t0 = time.perf_counter()
    state = train_state_init(_gen(0), cfg, device="cuda")
    step_fn = make_train_step(cfg, lr=3e-4)
    batches = [batch_to(make_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, step=s), "cuda")
               for s in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    _log(f"[train] yi-9b width, {cfg.n_layers} layers: {cfg.param_count() / 1e9:.3f} B params, "
         f"state and batches ready in {time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps = []
    for s in range(TRAIN_STEPS):
        n0, v0 = ops.launches["flash_attention"], dict(ops.flash_variant_launches)
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        launched = ops.launches["flash_attention"] - n0
        wgmma = ops.flash_variant_launches["wgmma"] - v0["wgmma"]
        steps.append({"loss": loss, "grad_norm": gnorm, "step_ms": ms,
                      "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                      "flash_launches": launched})
        _log(f"[train] step {s + 1}: loss {loss:.6f}, grad norm {gnorm:.6f}, {ms:.3f} ms, "
             f"{steps[-1]['tokens_per_s']:.1f} tokens/s, flash launches {launched} "
             f"({wgmma} wgmma)")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            _fail(f"train step {s + 1}: loss {loss}, grad norm {gnorm}")
        if launched != per_step or wgmma != per_step:
            _fail(f"train step {s + 1}: {launched} flash launches ({wgmma} wgmma), "
                  f"not {per_step} wgmma under remat dots")
        if s == 0 and not _attn_moments_nonzero(state, cfg):
            _fail("an attention weight got a zero gradient")
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"[train] peak memory {peak:.2f} GB over {TRAIN_STEPS} steps; launches {launches}")
    traced_ms, by_kernel = _device_profile(lambda: step_fn(state, batches[-1]), iters=1,
                                           warmup=0)
    classes = {}
    for name, ms in (by_kernel or {}).items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + ms
    top = dict(sorted(classes.items(), key=lambda kv: -kv[1])[:5])
    kernels = dict(sorted((by_kernel or {}).items(), key=lambda kv: -kv[1])[:8])
    _log(f"[train] traced step: device busy {traced_ms:.3f} ms; largest classes (device ms) "
         + ", ".join(f"{k} {v:.3f}" for k, v in top.items()) + "; largest kernels "
         + ", ".join(f"{k[:60]} {v:.3f}" for k, v in kernels.items()))
    del state
    _free()
    dense = _train_dense(cfg, batches[:TRAIN_STEPS], steps)
    del batches
    _free()
    return {"steps": steps, "peak_mem_gb": peak, "launches": launches,
            "traced_device_ms": traced_ms, "top_classes_ms": top, "top_kernels_ms": kernels,
            "dense_steps": dense}


def _dense_causal(q, k, v, *, window, cap):
    return ref.flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap)


def _train_dense(cfg, batches, steps) -> list:
    """The same steps from the same seed with attention differentiated by
    autograd through the dense plain version (no flash kernel, no FA2): the
    step-1 loss within 5e-2 and gradient norm within 5e-2 relative of the
    port's path (the dense path rounds p to bf16 before P·V in the backward
    too, FA2 keeps it fp32); the later steps are reported beside the port's."""
    state = train_state_init(_gen(0), cfg, device="cuda")
    step_fn = make_train_step(cfg, lr=3e-4)
    out = []
    with mock.patch.object(attention, "_flash_causal", _dense_causal):
        for batch in batches:
            state, m = step_fn(state, batch)
            out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    _log("[train] dense attention autograd, same seed and data: " + "; ".join(
        f"step {i + 1} loss {d['loss']:.6f} grad norm {d['grad_norm']:.6f} (flash path "
        f"{s['loss']:.6f}, {s['grad_norm']:.6f})" for i, (d, s) in enumerate(zip(out, steps))))
    if (abs(out[0]["loss"] - steps[0]["loss"]) > 5e-2
            or abs(out[0]["grad_norm"] - steps[0]["grad_norm"]) > 5e-2 * out[0]["grad_norm"]):
        _fail("the full-width step-1 loss or gradient norm differs from dense attention's")
    del state
    return out


def phase_train_grads() -> dict:
    """The flash Function's gradients against autograd through the dense
    plain version on the same card, yi-family heads (GQA 8/2, hd 128), L
    256: fp32 (fma) at 1e-4, bf16 (wgmma) at 3e-2, the reference's bf16
    model tolerance, against fp32 autograd on the same bf16 inputs."""
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        want = fa.variant(128, dtype)
        base = list(_qkv(2, 256, 8, 2, 128, dtype, seed=11)) + [
            torch.randn((2, 256, 8, 128), generator=_gen(12), device="cuda").to(dtype)]
        q, k, v = (t.clone().requires_grad_() for t in base[:3])
        n0 = dict(ops.flash_variant_launches)
        flash.flash_attention(q, k, v, window=100, softcap=30.0).backward(base[3])
        if ops.flash_variant_launches != {**n0, want: n0[want] + 1}:
            _fail(f"the flash Function in {dtype} did not run the {want} variant")
        q2, k2, v2 = (t.float().requires_grad_() for t in base[:3])
        ref.flash_attention_plain(q2, k2, v2, window=100, softcap=30.0).backward(
            base[3].float())
        errs[want] = max(_check(f"flash Function ({want}) d{n}", a.grad, b.grad, tol, tol)
                         for n, a, b in (("q", q, q2), ("k", k, k2), ("v", v, v2)))
    return errs


def _scan_moments_nonzero(state, cfg) -> list:
    """The scan-layer weights whose first moment is zero after a step from
    zero moments, i.e. that got a zero gradient (empty when all got one)."""
    m = state["opt"]["m"]["blocks"]
    return [f"s{i}.{key}.{w}" for i, kind in enumerate(cfg.layer_pattern)
            for key in ({"ssm": "ssm", "rglru": "rec"}.get(kind),) if key
            for w, t in m[f"s{i}"][key].items() if not bool(t.abs().amax() > 0)]


def _plain_ssd(x, dt, a, bmat, cmat, *, chunk=256, return_state=False):
    y, h_last = ref.ssd_chunked(x, dt, a, bmat, cmat, min(chunk, x.shape[1]))
    return (y, h_last) if return_state else y


def _plain_rglru(log_a, b, *, block_l=256, block_w=256):
    return ref.rglru_scan_ref(log_a, b)


def phase_train_recurrent(name: str, cfg, batch: int, seq: int, per_step: dict) -> dict:
    """TRAIN_STEPS steps of make_train_step on a recurrent arch at full
    width: each step's loss, grad norm, ms, tokens/s and launches (exactly
    ``per_step``: the scan forwards twice a layer under remat "dots", each
    backward kernel once, every forward on the serving variant), nonzero
    first moments for every scan-layer weight after step 1, peak memory;
    one more step traced (device time by class); then the same steps with
    both scans differentiated by autograd through their plain versions on
    the card, the step-1 loss within 5e-2 and grad norm within 5e-2
    relative."""
    t0 = time.perf_counter()
    state = train_state_init(_gen(0), cfg, device="cuda")
    step_fn = make_train_step(cfg, lr=3e-4)
    batches = [batch_to(make_batch(cfg, seq, batch, step=s), "cuda")
               for s in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    _log(f"[train] {name}: {cfg.n_layers} layers d{cfg.d_model}, "
         f"{cfg.param_count() / 1e9:.3f} B params, batch {batch} x {seq}; state and batches "
         f"ready in {time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps = []
    for s in range(TRAIN_STEPS):
        n0 = dict(ops.launches)
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        launched = {k: ops.launches[k] - n0[k] for k in n0}
        steps.append({"loss": loss, "grad_norm": gnorm, "step_ms": ms,
                      "tokens_per_s": batch * seq / ms * 1e3, "launches": launched})
        _log(f"[train] {name} step {s + 1}: loss {loss:.6f}, grad norm {gnorm:.6f}, "
             f"{ms:.3f} ms, {steps[-1]['tokens_per_s']:.1f} tokens/s, launches {launched}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            _fail(f"{name} train step {s + 1}: loss {loss}, grad norm {gnorm}")
        if launched != per_step:
            _fail(f"{name} train step {s + 1}: launches {launched}, not {per_step}")
        if s == 0:
            zero = _scan_moments_nonzero(state, cfg)
            if zero:
                _fail(f"{name}: scan-layer weights with a zero gradient: {zero}")
    launches = dict(ops.launches)
    want_variants = {"ssd_scan": {**dict.fromkeys(ssd.VARIANTS, 0),
                                  "mma": launches["ssd_scan"]},
                     "rglru_scan": {**dict.fromkeys(rg.VARIANTS, 0),
                                    "vec4": launches["rglru_scan"]},
                     "rglru_scan_bwd": {**dict.fromkeys(rg.VARIANTS, 0),
                                        "vec4": launches["rglru_scan_bwd"]},
                     "flash_attention": {**dict.fromkeys(fa.VARIANTS, 0),
                                         "wgmma": launches["flash_attention"]}}
    variants = {"ssd_scan": dict(ops.ssd_variant_launches),
                "rglru_scan": dict(ops.rglru_variant_launches),
                "rglru_scan_bwd": dict(ops.rglru_bwd_variant_launches),
                "flash_attention": dict(ops.flash_variant_launches)}
    if variants != want_variants:
        _fail(f"{name} training launches by variant {variants}, not {want_variants}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"[train] {name}: peak memory {peak:.2f} GB over {TRAIN_STEPS} steps; launches "
         f"{launches}; by variant {variants}")
    traced_ms, by_kernel = _device_profile(lambda: step_fn(state, batches[-1]), iters=1,
                                           warmup=0)
    classes = {}
    for k, ms in (by_kernel or {}).items():
        classes[kernel_class(k)] = classes.get(kernel_class(k), 0.0) + ms
    top = dict(sorted(classes.items(), key=lambda kv: -kv[1]))
    kernels = dict(sorted((by_kernel or {}).items(), key=lambda kv: -kv[1])[:8])
    _log(f"[train] {name} traced step: device busy {traced_ms:.3f} ms; classes (device ms) "
         + ", ".join(f"{k} {v:.3f}" for k, v in top.items()) + "; largest kernels "
         + ", ".join(f"{k[:60]} {v:.3f}" for k, v in kernels.items()))
    del state
    _free()

    state = train_state_init(_gen(0), cfg, device="cuda")
    plain = []
    with mock.patch.object(ops, "ssd_scan", _plain_ssd), \
            mock.patch.object(ops, "rglru_scan", _plain_rglru):
        ops.reset_launches()
        for b in batches[:TRAIN_STEPS]:
            state, m = step_fn(state, b)
            plain.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    scan_launches = {k: v for k, v in ops.launches.items() if "scan" in k and v}
    _log(f"[train] {name} with the scans differentiated through their plain versions: "
         + "; ".join(f"step {i + 1} loss {d['loss']:.6f} grad norm {d['grad_norm']:.6f} "
                     f"(kernels {k['loss']:.6f}, {k['grad_norm']:.6f})"
                     for i, (d, k) in enumerate(zip(plain, steps))))
    if scan_launches:
        _fail(f"{name}: the plain run launched scan kernels {scan_launches}")
    if (abs(plain[0]["loss"] - steps[0]["loss"]) > 5e-2
            or abs(plain[0]["grad_norm"] - steps[0]["grad_norm"]) > 5e-2 * plain[0]["grad_norm"]):
        _fail(f"{name}: the step-1 loss or gradient norm differs from the plain scans'")
    del state, batches
    _free()
    return {"steps": steps, "peak_mem_gb": peak, "launches": launches, "variants": variants,
            "traced_device_ms": traced_ms, "classes_ms": top, "top_kernels_ms": kernels,
            "plain_steps": plain, "params": cfg.param_count(), "batch": batch, "seq": seq,
            "layers": cfg.n_layers}


def phase_commit() -> dict:
    """The committed trainer at the "20m" preset of examples/train_pipeline.py
    (yi-family, d 384, 6 layers, hd 64: wgmma; seq 128, batch 4), 12 steps
    in chunks of 4, once uninterrupted and once with the primary controller
    killed after chunk 2."""
    cfg = configs.get_smoke("yi-9b").replace(
        d_model=384, n_layers=6, n_heads=6, n_kv_heads=3, head_dim=64, d_ff=1152,
        vocab=8192, remat="none")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fail_at in (("uninterrupted", None), ("failover", 2)):
            d = os.path.join(tmp, name)
            tr = CommittedTrainer(cfg, seq_len=128, global_batch=4, ckpt_dir=d,
                                  steps_per_chunk=4, lr=1e-3, device="cuda")
            ops.reset_launches()
            r = tr.train(12, fail_primary_at_chunk=fail_at)
            chunks = [m["step"] for m in tr.metrics]
            runs[name] = {"step": r.step, "loss": r.loss, "wall_s": r.wall_s,
                          "chunks": chunks, "commits": ckpt.all_steps(d),
                          "flash_launches": ops.launches["flash_attention"]}
            _log(f"[commit] {name}: step {r.step}, final chunk loss {r.loss:.6f}, "
                 f"{r.wall_s:.2f}s, chunks {chunks}, commits {runs[name]['commits']}, "
                 f"flash launches {runs[name]['flash_launches']}")
            if chunks != [4, 8, 12] or runs[name]["commits"] != [4, 8, 12]:
                _fail(f"committed trainer ({name}) did not commit each chunk exactly once")
    a, b = runs["uninterrupted"], runs["failover"]
    if a["step"] != b["step"] or abs(a["loss"] - b["loss"]) > 1e-4:
        _fail(f"failover run ended at step {b['step']}, loss {b['loss']}; uninterrupted "
              f"{a['step']}, {a['loss']}")
    _log(f"[commit] failover matches: |d loss| = {abs(a['loss'] - b['loss']):.3e} (tol 1e-4)")
    _free()
    return runs


def phase_refuse() -> None:
    """The flash wrapper outside the flash Function refuses inputs that need
    a gradient; a backward through the mamba2-370m and recurrentgemma-9b
    smoke configs on the card runs, finite, through each scan's backward
    kernel."""
    q = torch.zeros((1, 64, 4, 64), device="cuda", requires_grad=True)
    try:
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    except NotImplementedError:
        _log("[refuse] ops.flash_attention on inputs that need a gradient raises "
             "NotImplementedError (training goes through models/flash)")
    else:
        _fail("ops.flash_attention on the card took inputs that need a gradient")
    for arch, kernel in (("mamba2-370m", "ssd_scan_bwd"), ("recurrentgemma-9b", "rglru_scan_bwd")):
        cfg = configs.get_smoke(arch)
        params = lm.init(_gen(2), cfg, device="cuda")
        params["embed"].requires_grad_()
        batch = batch_to(make_batch(cfg, 64, 2), "cuda")
        ops.reset_launches()
        lm.loss_fn(params, cfg, batch)[0].backward()
        torch.cuda.synchronize()
        n = ops.launches[kernel]
        finite = bool(torch.isfinite(params["embed"].grad).all())
        _log(f"[refuse] {arch}: a backward on the card runs ({kernel} launched {n}x, "
             f"finite gradient {finite})")
        if n < 1 or not finite:
            _fail(f"{arch}: a backward on the card did not run through {kernel}")


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    _log(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)}")
    built = phase_build()
    rows = {"flash_attention": phase_flash(), "ssd_scan": phase_ssd(),
            "rglru_scan": phase_rglru()}
    bwd_rows = phase_scan_bwd()
    phase_model()
    by_path, by_variant = {}, {}
    by_path["yi-9b"], by_variant["yi-9b"] = phase_serve("yi-9b")
    phase_workflow("yi-9b")
    by_path["mamba2-370m"], by_variant["mamba2-370m"] = phase_serve("mamba2-370m")
    phase_workflow("mamba2-370m")
    by_path["recurrentgemma-9b"], by_variant["recurrentgemma-9b"] = phase_serve(
        "recurrentgemma-9b")
    for name in rows:
        rows[name]["launches_by_variant"] = {
            v: sum(n[name][v] for n in by_variant.values())
            for v in by_variant["yi-9b"][name]}
    train = phase_train()
    by_path[f"yi-9b train ({YI_TRAIN.n_layers} layers, {TRAIN_STEPS} steps)"] = train["launches"]
    recurrent = {}
    for name, cfg, batch, seq in (("mamba2-370m", MAMBA_TRAIN, MAMBA_TRAIN_BATCH, TRAIN_SEQ),
                                  ("recurrentgemma-9b", RG_TRAIN, RG_TRAIN_BATCH, RG_TRAIN_SEQ)):
        r = phase_train_recurrent(name, cfg, batch, seq, _train_launches(cfg))
        recurrent[name] = r
        by_path[f"{name} train ({cfg.n_layers} layers, {TRAIN_STEPS} steps)"] = r["launches"]
        for k, row in rows.items():
            for v, n in r["variants"][k].items():
                row["launches_by_variant"][v] += n
    rows.update(bwd_rows)
    for name, lib, key in (("rglru_scan_bwd", "rglru_scan", "rglru_scan_bwd"),
                           ("ssd_scan_bwd", "ssd_scan_bwd", "ssd_bwd_")):
        rows[name]["ptxas"] = {fn: {"registers": regs, "spill_stores": st, "spill_loads": ld}
                               for fn, regs, st, ld in _ptxas_report(built[lib]["log"])
                               if key in fn}
    rows["rglru_scan_bwd"]["launches_by_variant"] = {
        v: sum(r["variants"]["rglru_scan_bwd"][v] for r in recurrent.values())
        for v in rg.VARIANTS}
    for name, row in rows.items():
        row["launches_by_path"] = {arch: n[name] for arch, n in by_path.items() if n[name]}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] <= 0:
            _fail(f"{name} was not launched on any main path")
    rows["flash_attention"]["launches_by_variant"]["wgmma"] += train["launches"][
        "flash_attention"]
    grads = phase_train_grads()
    commit = phase_commit()
    phase_refuse()
    _log(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f}s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kernels = {"kernels": list(rows.values())}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": smi, **kernels, "train": train, "train_recurrent": recurrent,
                   "train_grads_max_err": grads, "commit": commit}, f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
