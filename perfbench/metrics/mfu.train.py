"""The model FLOPs of the traced training steps (the benchmark's own count,
``harness/modelflops.train_flops``: the forward three times, no remat
recompute) over the traced window, as a share of the card's published peak
in the configuration's compute dtype."""

from perfbench.harness import modelflops, peaks


def read(trace):
    peak = peaks.peak(trace.kind, trace.config["compute_dtype"])
    if peak is None or not trace.work.get("items"):
        return None
    layers = trace.work["layers"]
    flops = sum(modelflops.train_flops(trace.config, layers, b, l)
                for b, l in trace.work["items"])
    return 100.0 * flops / trace.window_s / peak
