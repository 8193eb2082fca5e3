"""The model FLOPs of the traced prefill requests (the benchmark's own count,
``harness/modelflops.prefill_flops``) over the traced window, as a share of
the card's published peak in the configuration's compute dtype."""

from perfbench.harness import modelflops, peaks


def read(trace):
    peak = peaks.peak(trace.kind, trace.config["compute_dtype"])
    if peak is None or not trace.work.get("items"):
        return None
    layers = trace.work["layers"]
    flops = sum(modelflops.prefill_flops(trace.config, layers, b, l)
                for b, l in trace.work["items"])
    return 100.0 * flops / trace.window_s / peak
