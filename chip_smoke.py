"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own:

1. build    — compile every CUDA kernel of the port (one nvcc per source,
              all started together) and print the build seconds and ptxas
              register/shared-memory report.
2. kernels  — flash attention on the card against its plain PyTorch version
              on the same inputs: the 7 reference cases at their tolerances,
              block-shape invariance, ragged rejection, and the yi-9b
              serving shape in bf16 with kernel / plain / library timings.
3. model    — yi-9b smoke config in fp32 on the card (kernel) and on the
              CPU (plain): prefill logits within 1e-4, equal greedy tokens.
4. serve    — launch/serve at the full width of yi-9b (48 layers, random
              weights from a seed, fp32 master weights on the card): batch
              4, prompt 512, 32 generated tokens; flash launches counted
              from 0 and required to be 48 per prefill.
5. workflow — the ByRedundant serve workflow at full width on the port's
              LocalRunner: exactly one detok completion, and the committed
              tokens equal a direct greedy_generate call.

The line before the last is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a card it exits 1 and
prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.convert import tree_to  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.serve import workflow  # noqa: E402
from repro_torch.serve.engine import greedy_generate  # noqa: E402

# yi-9b prefill self-attention at the serving shape below (bf16 compute)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
YI = configs.get("yi-9b")
YI_SHAPE = (SERVE_BATCH, SERVE_PROMPT, YI.n_heads, YI.n_kv_heads, YI.hd)

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


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


def _qkv(b, l, h, hkv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn((b, l, n, hd), generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(h), mk(hkv), mk(hkv)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_build() -> dict:
    t0 = time.perf_counter()
    info = build.build_all()
    _log(f"[build] {sorted(info)} built in {time.perf_counter() - t0:.2f}s")
    for name, i in info.items():
        _log(f"[build] {name}: nvcc {i['seconds']:.2f}s\n{i['log'].strip()}")
    return info


def phase_kernels() -> dict:
    for (b, l, h, hkv, hd, window, cap, dtype_name, tol) in ref.FLASH_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=l + h)
        out = ops.flash_attention(q, k, v, causal=True, window=window, softcap=cap,
                                  block_q=128, block_k=128)
        expect = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                         softcap=cap)
        torch.cuda.synchronize()
        err = _max_err(out, expect)
        _log(f"[kernels] case b={b} l={l} h={h} hkv={hkv} hd={hd} window={window} "
             f"cap={cap} {dtype_name}: max|d|={err:.3e} (tol {tol})")
        if not torch.allclose(out.float(), expect.float(), atol=tol, rtol=tol):
            _fail(f"flash case {(b, l, h, hkv, hd, window, cap, dtype)} max|d| {err}")

    q, k, v = _qkv(1, 512, 4, 2, 64, torch.float32, seed=0)
    o1 = ops.flash_attention(q, k, v, block_q=64, block_k=128)
    o2 = ops.flash_attention(q, k, v, block_q=256, block_k=64)
    inv = _max_err(o1, o2)
    _log(f"[kernels] block-shape invariance max|d|={inv:.3e}")
    if inv > 1e-5:
        _fail("block-shape invariance")
    z = torch.zeros((1, 100, 4, 64), device="cuda")
    try:
        ops.flash_attention(z, z[:, :, :4], z[:, :, :4], block_q=64, block_k=64)
    except ValueError:
        _log("[kernels] ragged shape rejected with ValueError")
    else:
        _fail("ragged shape was not rejected")

    b, l, h, hkv, hd = YI_SHAPE
    dtype = YI.cdtype
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=1)
    out = ops.flash_attention(q, k, v, causal=True, block_q=attention.FLASH_BLOCK,
                              block_k=attention.FLASH_BLOCK)
    expect = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = _max_err(out, expect)
    if not torch.allclose(out.float(), expect.float(), atol=2e-2, rtol=2e-2):
        _fail(f"yi-9b shape max|d| {err}")

    kernel_ms = _time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = _time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    # least time for the same work: each input read once and the output
    # written once, against the unmasked (q, k) pairs' products at the
    # inputs' type peak; the larger of the two bounds it
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    pairs = int(attention.make_causal_mask(l, l, device="cuda").sum())
    flops = 4 * b * h * hd * pairs
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:96",
           "launches": None, "max_abs_err": err, "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    _log(f"[kernels] yi-9b prefill shape {YI_SHAPE} {str(dtype)[6:]}: max|d|={err:.3e} "
         f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
         f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}: {nbytes} B, {flops} FLOP)")
    return row


def phase_model() -> None:
    cfg = configs.get_smoke("yi-9b").replace(compute_dtype="float32")
    g = torch.Generator(device="cpu").manual_seed(3)
    params_cpu = lm.init(g, cfg, device="cpu")
    params_gpu = tree_to(params_cpu, "cuda")
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    _, logits_cpu = lm.prefill(params_cpu, cfg, toks, max_len=40)
    n0 = ops.launches["flash_attention"]
    _, logits_gpu = lm.prefill(params_gpu, cfg, toks.cuda(), max_len=40)
    if ops.launches["flash_attention"] - n0 != cfg.n_layers:
        _fail("smoke prefill on the card did not launch the flash kernel per layer")
    err = _max_err(logits_gpu.cpu(), logits_cpu)
    _log(f"[model] yi-9b smoke fp32 prefill logits card vs cpu max|d|={err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        _fail("card vs cpu prefill logits")
    t_cpu = greedy_generate(params_cpu, cfg, toks, 12)
    t_gpu = greedy_generate(params_gpu, cfg, toks.cuda(), 12).cpu()
    _log(f"[model] greedy tokens equal: {bool(torch.equal(t_cpu, t_gpu))}")
    if not torch.equal(t_cpu, t_gpu):
        _fail("card vs cpu greedy tokens differ")


def phase_serve() -> int:
    ops.reset_launches()
    r = launch_serve.run("yi-9b", batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                         gen=SERVE_GEN, seed=0, device="cuda")
    launches = ops.launches["flash_attention"]
    toks = r["tokens"]
    _log(f"[serve] yi-9b full width ({YI.n_layers}L d{YI.d_model}): init {r['init_s']:.2f}s, "
         f"prefill {r['prefill_ms']:.3f} ms, decode {r['decode_ms_per_token']:.3f} ms/token, "
         f"{r['tok_s']:.2f} tok/s, peak mem {r['peak_mem_gb']:.2f} GB, "
         f"flash launches {launches}")
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN):
        _fail(f"generated shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= YI.padded_vocab:
        _fail("generated ids out of range")
    if launches <= 0 or launches != YI.n_layers * 1:
        _fail(f"flash launches {launches} != {YI.n_layers} per prefill")
    return launches


def phase_workflow() -> None:
    g = torch.Generator(device="cuda").manual_seed(1)
    params = lm.init(g, YI, device="cuda")
    ops.reset_launches()
    out = workflow.run(params, YI, batch=2, prompt_len=16, steps=12)
    launches = ops.launches["flash_attention"]
    _log(f"[workflow] {out['completions']} detok completion(s) in {out['wall_s']:.2f}s; "
         f"decode ran {out['decode_calls']}x across replicas; flash launches {launches}")
    if out["completions"] != 1:
        _fail("serve workflow did not complete exactly once")
    if launches != YI.n_layers * out["decode_calls"]:
        _fail(f"workflow flash launches {launches} != {YI.n_layers} per decode replica")
    prompt = torch.tensor(workflow.prompt_ids(YI, 2, 16, 7), device="cuda")
    direct = greedy_generate(params, YI, prompt, 12).cpu().tolist()
    if direct != out["ids"]:
        _fail("workflow tokens differ from a direct greedy_generate call")
    _log("[workflow] committed tokens equal a direct greedy_generate call")


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
    phase_build()
    row = phase_kernels()
    phase_model()
    row["launches"] = phase_serve()
    gc.collect()
    torch.cuda.empty_cache()
    phase_workflow()
    _log(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f}s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kernels = {"kernels": [row]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": smi, **kernels}, f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
