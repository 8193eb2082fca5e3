"""Where training time goes: one step of ``make_train_step``, split and traced.

    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch yi-9b \\
        [--layers 4 --batch 2 --seq-len 2048 --remat dots] [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch mamba2-370m --layers 0
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch recurrentgemma-9b \\
        --layers 3 --batch 1 --seq-len 4096

Weights are random (``--seed``), data from the synthetic pipeline; ``--layers``
cuts the depth and keeps the arch's width.  After one untraced warm-up step
it times, on the host clock with each call ended by a device synchronise:

  * ``forward_ms``: the loss alone, without a gradient;
  * ``forward_backward_ms``: the loss and every parameter's gradient (the
    remat recompute included), so the backward is the difference;
  * ``step_ms``: the whole step, so clip + AdamW (+ the master casts) is
    ``step_ms − forward_backward_ms``;
  * ``flash_bwd_ms``: the flash-attention backward alone at one attention
    layer's shape (its window included), which the step runs once an
    attention layer (archs with attention): ``ops.flash_attention_bwd``,
    the kernel through its operator on the card and the plain FA2 backward
    on the CPU; ``flash_bwd_plain_ms``: the plain backward
    (``models/flash._flash_bwd_impl``) at the same shape on either device;
  * ``ssd_scan_bwd_ms`` / ``rglru_scan_bwd_ms``: each scan's backward alone
    at one layer's shape (archs with that layer), which the step runs once
    a layer: the kernel on the card, its explicit plain formulas
    (``kernels/ref.py``) on the CPU;
  * ``optimizer_ms``: clip + AdamW alone over the parameter tree.

Then it traces one whole step with torch.profiler: device busy time, idle
share, device time by kernel class and the largest kernels.  On the CPU only
host-side operator times exist.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import configs, resolve_device
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.profile_serve import _sync, _traced
from repro_torch.kernels import ops, ref
from repro_torch.models import flash, lm, rglru, ssm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import optim
from repro_torch.train.commit import batch_to
from repro_torch.train.step import make_train_step, train_state_init


def _host_ms(dev: torch.device, fn, iters: int = 3) -> float:
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / iters


def run(arch: str, *, smoke: bool = False, layers: int = 4, batch: int = 2,
        seq_len: int = 2048, remat: str = "dots", seed: int = 0,
        device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    cfg = (configs.get_smoke(arch) if smoke else configs.get(arch)).replace(remat=remat)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    state = train_state_init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    step_fn = make_train_step(cfg)
    data = batch_to(make_batch(cfg, seq_len, batch, step=0, seed=seed), dev)
    step_fn(state, data)                                      # warm-up, untraced
    params = state["params"]

    def forward():
        with torch.no_grad():
            lm.loss_fn(params, cfg, data)

    def forward_backward():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = lm.loss_fn(p, cfg, data)
        return torch.autograd.grad(loss, tree_leaves(p))

    grads = tree_map(lambda t: torch.ones_like(t), params)

    def optimizer():
        g, _ = optim.clip_by_global_norm(grads, 1.0)
        optim.adamw_update(params, g, state["opt"], state["step"], lr=3e-4)

    out: Dict[str, Any] = {
        "arch": cfg.name, "layers": cfg.n_layers, "batch": batch, "seq_len": seq_len,
        "remat": remat, "params": cfg.param_count(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "forward_ms": _host_ms(dev, forward),
        "forward_backward_ms": _host_ms(dev, forward_backward),
        "step_ms": _host_ms(dev, lambda: step_fn(state, data)),
        "optimizer_ms": _host_ms(dev, optimizer),
    }
    kinds = {cfg.pattern_of(i) for i in range(cfg.n_layers)}
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def rnd(*shape, dtype=cfg.cdtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    if kinds & {"attn", "local"}:
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        q, do = rnd(batch, seq_len, h, cfg.hd), rnd(batch, seq_len, h, cfg.hd)
        k, v = rnd(batch, seq_len, hkv, cfg.hd), rnd(batch, seq_len, hkv, cfg.hd)
        lse = torch.zeros((batch, h, seq_len), dtype=torch.float32, device=dev)
        blk = min(512, seq_len) if seq_len % min(512, seq_len) == 0 else seq_len
        window = cfg.window if "local" in kinds else 0
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        out["flash_bwd_ms"] = _host_ms(dev, lambda: ops.flash_attention_bwd(
            q, k, v, q, lse, do, block_q=blk, block_k=blk, **kw))
        out["flash_bwd_plain_ms"] = _host_ms(dev, lambda: flash.flash_bwd_plain(
            q, k, v, q, lse, do, bq=blk, bk=blk, **kw))
    if "ssm" in kinds:
        _, nh, p, n = ssm.dims(cfg)
        qc = min(cfg.ssm.chunk, seq_len)
        x, dy = rnd(batch, seq_len, nh, p), rnd(batch, seq_len, nh, p)
        # dt and A as the model's init draws them (dt_bias = log(expm1(0.01)))
        dt = torch.nn.functional.softplus(rnd(batch, seq_len, nh, dtype=torch.float32)
                                          + math.log(math.expm1(0.01)))
        a = -torch.linspace(1.0, 16.0, nh, device=dev)
        bm, cm = rnd(batch, seq_len, n), rnd(batch, seq_len, n)
        bwd = ops.ssd_scan_bwd if dev.type == "cuda" else ref.ssd_chunked_bwd
        out["ssd_scan_bwd_ms"] = _host_ms(dev, lambda: bwd(x, dt, a, bm, cm, qc, dy, None))
    if "rglru" in kinds:
        w = rglru.width(cfg)
        log_a = -torch.nn.functional.softplus(rnd(batch, seq_len, w, dtype=torch.float32))
        h, dh = rnd(batch, seq_len, w, dtype=torch.float32), rnd(batch, seq_len, w,
                                                                 dtype=torch.float32)
        bwd = ops.rglru_scan_bwd if dev.type == "cuda" else ref.rglru_scan_bwd_ref
        out["rglru_scan_bwd_ms"] = _host_ms(dev, lambda: bwd(log_a, h, dh))
    _, out["traced_step"] = _traced(dev, lambda: step_fn(state, data))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(configs.ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=4, help="depth (0: the arch's own)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--remat", choices=("none", "dots", "full"), default="dots")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.arch, smoke=args.smoke, layers=args.layers, batch=args.batch,
            seq_len=args.seq_len, remat=args.remat, seed=args.seed, device=args.device)
    print(json.dumps(r, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
