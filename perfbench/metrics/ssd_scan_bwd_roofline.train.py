"""The SSD scan backward kernels' share of their roofline in a traced window.

For each call of ``repro_torch::ssd_scan_bwd``: the larger of its bytes (x,
dt, a, B, C and dy read once, their five gradients written once) at the
HBM's rate and the products the backward needs (per chunk C·Bᵀ over the
causal pairs, shared by the heads; per head dy·xᵀ over the pairs, the three
pair products into dx, dB, dC and six state-sized products) at the peak of
x's dtype; summed over the calls, over the device time of the backward's
kernels.  Frozen here: equal to the port's ``kernels/ssd_scan.bwd_flops``
and its kernel table's bytes.
"""

from perfbench.harness import peaks


def flops(bt, l, h, p, n, q):
    nc, pairs = l // q, q * (q + 1) // 2
    return (2 * bt * nc * pairs * n
            + 2 * bt * nc * h * (pairs * (2 * p + 2 * n) + 6 * q * p * n))


def _size(shape, dtype):
    out = peaks.ITEMSIZE[dtype]
    for d in shape:
        out *= d
    return out


def nbytes(shapes, dtypes):
    inputs = sum(_size(s, d) for s, d in zip(shapes[:5], dtypes[:5]))
    return 2 * inputs + _size(shapes[6], dtypes[6])


def read(trace):
    calls = trace.calls("ssd_scan_bwd")
    t = trace.shaped_class_s().get("ssd_scan_bwd")
    hbm = peaks.peak(trace.kind, "hbm_bytes_s")
    if not calls or not t or hbm is None or len(calls[0].scalars) < 6:
        return None
    bound = 0.0
    for c in calls:
        x, bm = c.shapes[0], c.shapes[3]
        q = c.scalars[5]
        peak = peaks.flop_peak(trace.kind, c.dtypes[0])
        if peak is None:
            return None
        bound += max(nbytes(c.shapes, c.dtypes) / hbm,
                     flops(x[0], x[1], x[2], x[3], bm[2], q) / peak)
    return 100.0 * bound / t
