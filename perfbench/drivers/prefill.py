"""The prefill driver: a serving node's prefill pool under one closed-loop client.

Set-up makes the seeded weights on the card and runs one prefill at each
(batch, length) the mix sends.  In the window the client sends request ``i``
(its prompts made on the card from the seed), the node runs
``serve/engine.make_prefill_step`` and ``greedy_token`` on it, and the
client takes the first tokens after a synchronise: that is the request's
time to first token, from its issue.  The next request goes out then.  The
window closes with the first request to finish after ``--seconds``; every
request of the window is counted, and its time is the time from the first
issue to the last finish.

``ttft_ms_p95`` is the 95th percentile (nearest rank) of every request's
time to first token; ``prefill_tokens_per_s`` all prompt tokens of the
window over its length.  A traced run profiles ``trace_requests`` requests
from request ``trace_from`` on.

The check: the node's outputs of the requests the seed picks (a long one
among them, :meth:`Traffic.check_sample`) are kept as served: the greedy
tokens, the last position's logits and the whole cache the prefill leaves.
After the window the port's state is freed and the plain fp32 reference
runs over the same prompts from the same seeded weights.
"""

from __future__ import annotations

import math
import time
from collections import Counter
from typing import Any, Dict, List

import torch

from perfbench.harness import compare, weights
from perfbench.harness.bench import Bench, Check, Result
from perfbench.harness.trace import Chunks, span
from perfbench.harness.traffic import Traffic


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(b: Bench) -> Result:
    from repro_torch.kernels import library
    from repro_torch.models import lm
    from repro_torch.serve import engine

    cfg, dev, t = b.model_cfg, b.device, b.traffic
    traffic = Traffic(t, b.seed, b.config["vocab_size"])
    t_w = time.perf_counter()
    shapes = lm.init_shapes(cfg)
    params = weights.make(shapes, b.seed, dev)
    _sync(dev)
    t_warm = time.perf_counter()
    steps: Dict[int, Any] = {}

    def serve(tokens: torch.Tensor):
        l = tokens.shape[1]
        if l not in steps:
            steps[l] = engine.make_prefill_step(cfg, max_len=l)
        t_issue = time.perf_counter()
        with span("prefill_step"):
            cache, logits = steps[l](params, {"tokens": tokens})
        with span("greedy_token"):
            tok = engine.greedy_token(logits)
        with span("sync"):
            _sync(dev)
        return time.perf_counter() - t_issue, cache, logits, tok

    with torch.inference_mode():
        for bsz, l in traffic.shapes():
            g = weights.generator(dev, b.seed, "warmup", l)
            serve(torch.randint(0, b.config["vocab_size"], (bsz, l), generator=g, device=dev))
        _sync(dev)
        sample = set(traffic.check_sample())
        kept: Dict[int, Any] = {}
        ttfts: List[float] = []
        lengths: Counter = Counter()
        launches0 = {k: dict(v) for k, v in library.variant_launches.items()}
        chunks = Chunks(dev, t["trace_from"], t["trace_requests"], b.trace)
        traced: List[tuple] = []
        ahead: Dict[int, torch.Tensor] = {}
        prompt_tokens, i = 0, 0
        t_start = time.perf_counter()
        b.start_window(t_start)
        while True:
            ahead.update(chunks.enter(i, lambda j: traffic.prompt(j, dev)))
            if i in ahead:
                tokens = ahead.pop(i)
            else:
                with span("make_prompt"):
                    tokens = traffic.prompt(i, dev)
            ttft, cache, logits, tok = serve(tokens)
            chunks.leave(i)
            ttfts.append(ttft)
            prompt_tokens += tokens.numel()
            lengths[tokens.shape[1]] += 1
            if i in sample:
                kept[i] = (cache, logits, tok)
            if chunks.lo <= i < chunks.lo + chunks.n:
                traced.append(tuple(tokens.shape))
            i += 1
            if time.perf_counter() - t_start >= b.seconds and chunks.done(i):
                break
        window_s = time.perf_counter() - t_start
        attempted = i
        launches = {k: {v: n - launches0[k][v] for v, n in d.items() if n - launches0[k][v]}
                    for k, d in library.variant_launches.items()}
        while i <= max(sample):                 # late: due, but not finished in the window
            tokens = traffic.prompt(i, dev)
            _, cache, logits, tok = serve(tokens)
            if i in sample:
                kept[i] = (cache, logits, tok)
            i += 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    data = None
    if b.trace:
        data = chunks.data({"requests": len(traced), "items": traced, "layers": b.layers},
                           b.config, torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu")
    del params, steps, cache, logits, tok
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = b.reference()
    ref_params = weights.make(shapes, b.seed, dev)
    gap = l_err = c_err = 0.0
    for idx in sorted(kept):
        cache, logits, tok = kept.pop(idx)
        r_logits, r_cache = ref.prefill(ref_params, b.dims(), traffic.prompt(idx, dev))
        gap = max(gap, compare.token_gap(r_logits, tok[:, 0]))
        l_err = max(l_err, compare.rel_err(logits, r_logits))
        c_err = max(c_err, compare.cache_err(cache["blocks"]["s0"], r_cache))
        del cache, logits, tok, r_logits, r_cache
    del ref_params
    nums = {"token_gap": gap, "logits_err": l_err, "cache_err": c_err}
    checks = [Check(n, v, b.limits[n]) for n, v in nums.items() if n in b.limits]
    lines = [f"set-up: to the weights {t_w - b.t0:.2f} s, weights {t_warm - t_w:.2f} s, "
             f"warm-up {t_start - t_warm:.2f} s",
             f"requests {attempted} in {window_s:.3f} s; prompt lengths {dict(sorted(lengths.items()))}",
             f"launches by variant in the window: {launches}",
             f"memory_peak_bytes {peak}",
             f"checked requests {sorted(sample)} in {time.perf_counter() - t_check:.1f} s"]
    if data:
        lines.append(f"traced operator calls {len(data.ops)}, with scalar arguments "
                     f"{sum(any(x is not None for x in c.scalars) for c in data.ops)}")
    return Result(attempted=attempted, failed=0,
                  end_to_end={"ttft_ms_p95": p95(ttfts) * 1e3,
                              "prefill_tokens_per_s": prompt_tokens / window_s},
                  checks=checks, memory_peak_bytes=peak, trace=data, lines=lines)
