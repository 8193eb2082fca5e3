"""The SSD scan forward kernels' share of their roofline in a traced window.

For each call of ``repro_torch::ssd_scan_fwd``: the larger of its bytes (x,
dt, a, B, C read once, y and, when returned, the fp32 final state written
once) at the HBM's rate and its products (C·Bᵀ over each chunk's causal
pairs, shared by the heads; per head the masked scores times X, C·h_prevᵀ
and the state update) at the peak of x's dtype; summed over the calls, over
the device time of the scan's kernels.  Frozen here: equal to the port's
``kernels/ssd_scan.flops`` and its kernel table's bytes.
"""

from perfbench.harness import peaks


def flops(bt, l, h, p, n, q):
    nc, pairs = l // q, q * (q + 1) // 2
    return 2 * bt * nc * pairs * n + 2 * bt * nc * h * (pairs * p + 2 * q * p * n)


def _size(shape, dtype):
    out = peaks.ITEMSIZE[dtype]
    for d in shape:
        out *= d
    return out


def nbytes(shapes, dtypes, return_state):
    x = shapes[0]
    inputs = sum(_size(s, d) for s, d in zip(shapes[:5], dtypes[:5]))
    state = x[0] * x[2] * x[3] * shapes[3][2] * 4 if return_state else 0
    return inputs + _size(x, dtypes[0]) + state


def read(trace):
    calls = trace.calls("ssd_scan_fwd")
    t = trace.shaped_class_s().get("ssd_scan")
    hbm = peaks.peak(trace.kind, "hbm_bytes_s")
    if not calls or not t or hbm is None or len(calls[0].scalars) < 7:
        return None
    bound = 0.0
    for c in calls:
        x, bm = c.shapes[0], c.shapes[3]
        q, state = c.scalars[5:7]
        peak = peaks.flop_peak(trace.kind, c.dtypes[0])
        if peak is None:
            return None
        bound += max(nbytes(c.shapes, c.dtypes, state) / hbm,
                     flops(x[0], x[1], x[2], x[3], bm[2], q) / peak)
    return 100.0 * bound / t
