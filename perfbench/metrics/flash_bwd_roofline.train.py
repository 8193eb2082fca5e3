"""The flash backward kernels' share of their roofline in a traced window.

For each call of ``repro_torch::flash_attention_bwd``: the larger of its
bytes (q, k, v, out, do and the fp32 log-sum-exp read once, dq, dk, dv
written once) at the HBM's rate and the products the reference's FA2
backward needs (q·kᵀ, do·vᵀ, pᵀ·do, dsᵀ·q and ds·k, 2·hd each per kept
pair and head: the kernel's recompute is not counted) at the peak of q's
dtype; summed over the calls, over the device time of the backward's
kernels (delta, dk/dv, dq and the head shares' reduction).  Frozen here:
equal to the port's ``kernels/flash_attention.bwd_flops`` and its kernel
table's bytes.
"""

from perfbench.harness import peaks


def pairs(l, s_len, causal=True, window=0):
    """Kept (query, key) pairs of one head."""
    if causal:
        c = min(s_len, window) if window else s_len
        return l * (l + 1) // 2 if l <= c else c * (c + 1) // 2 + (l - c) * c
    if not window:
        return l * s_len
    return sum(max(0, s_len - max(0, i - window + 1)) for i in range(l))


def flops(b, l, s_len, h, hd, causal=True, window=0):
    return 10 * b * h * hd * pairs(l, s_len, causal, window)


def nbytes(q, k, itemsize):
    b, l, h, hd = q
    qsz = b * l * h * hd * itemsize
    kv = k[0] * k[1] * k[2] * k[3] * itemsize
    return 4 * qsz + 4 * kv + b * h * l * 4      # q out do dq; k v dk dv; lse


def read(trace):
    calls = trace.calls("flash_attention_bwd")
    t = trace.shaped_class_s().get("flash_attention_bwd")
    hbm = peaks.peak(trace.kind, "hbm_bytes_s")
    if not calls or not t or hbm is None or len(calls[0].scalars) < 8:
        return None
    bound = 0.0
    for c in calls:
        q, k = c.shapes[0], c.shapes[1]
        causal, window = c.scalars[6:8]
        peak = peaks.flop_peak(trace.kind, c.dtypes[0])
        if peak is None:
            return None
        bound += max(nbytes(q, k, peaks.ITEMSIZE[c.dtypes[0]]) / hbm,
                     flops(q[0], q[1], k[1], q[2], q[3], causal, window) / peak)
    return 100.0 * bound / t
