"""The flash forward kernels' share of their roofline in a traced window.

For each call of ``repro_torch::flash_attention_fwd`` the trace recorded,
the least time the card could take: the larger of its bytes (q, k, v read
once, out and, when returned, the fp32 log-sum-exp written once) at the
HBM's rate and its products (q·kᵀ and p·v, 2·hd each per kept pair and
head) at the peak of q's dtype; summed over the calls, over the device
time of the flash forward's kernels.  The formulas are frozen here: they
equal the port's ``kernels/flash_attention.flops`` and the byte counts of
its kernel table.
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
    return 4 * b * h * hd * pairs(l, s_len, causal, window)


def nbytes(q, k, itemsize, return_lse):
    b, l, h, hd = q
    qo = b * l * h * hd * itemsize
    kv = k[0] * k[1] * k[2] * k[3] * itemsize
    return 2 * qo + 2 * kv + (b * h * l * 4 if return_lse else 0)


def read(trace):
    calls = trace.calls("flash_attention_fwd")
    t = trace.shaped_class_s().get("flash_attention")
    hbm = peaks.peak(trace.kind, "hbm_bytes_s")
    if not calls or not t or hbm is None or len(calls[0].scalars) < 7:
        return None
    bound = 0.0
    for c in calls:
        q, k = c.shapes[0], c.shapes[1]
        causal, window, _, lse = c.scalars[3:7]
        peak = peaks.flop_peak(trace.kind, c.dtypes[0])
        if peak is None:
            return None
        bound += max(nbytes(q, k, peaks.ITEMSIZE[c.dtypes[0]], lse) / hbm,
                     flops(q[0], q[1], k[1], q[2], q[3], causal, window) / peak)
    return 100.0 * bound / t
