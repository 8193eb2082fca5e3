"""The yardstick's frozen counts reproduce the worked figures of the port's
kernel table (``PERF.md``), and the per-layer readers read a trace."""

from __future__ import annotations

import pytest

from perfbench.harness import bench, modelflops
from perfbench.harness.trace import OpCall, TraceData, kernel_class

KIND = "NVIDIA H100 80GB HBM3"


def metric(name):
    return bench.file_module("metrics", name)


def test_flash_forward_at_yi_training_shape():
    m = metric("flash_fwd_roofline.prefill")
    q, k = [2, 2048, 32, 128], [2, 2048, 4, 128]
    assert round(m.nbytes(q, k, 2, True) / 1e6, 1) == 76.0
    assert m.flops(2, 2048, 2048, 32, 128) == pytest.approx(68.7e9, abs=0.06e9)
    q, k = [4, 512, 32, 128], [4, 512, 4, 128]
    assert round(m.nbytes(q, k, 2, False) / 1e6, 1) == 37.7
    assert round(m.flops(4, 512, 512, 32, 128) / 1e9, 2) == 8.61


def test_flash_backward_at_yi_training_shape():
    m = metric("flash_bwd_roofline.train")
    assert round(m.nbytes([2, 2048, 32, 128], [2, 2048, 4, 128], 2) / 1e6, 1) == 151.5
    assert m.flops(2, 2048, 2048, 32, 128) == pytest.approx(171.9e9, abs=0.06e9)


def test_ssd_scan_at_mamba_serving_shape():
    m = metric("ssd_scan_roofline.train")
    shapes = [[4, 512, 32, 64], [4, 512, 32], [32], [4, 512, 128], [4, 512, 128]]
    dtypes = ["c10::BFloat16", "float", "float", "c10::BFloat16", "c10::BFloat16"]
    assert round(m.nbytes(shapes, dtypes, True) / 1e6, 1) == 22.3
    assert round(m.flops(4, 512, 32, 64, 128, 256) / 1e9, 2) == 3.29


def test_ssd_backward_at_mamba_training_shape():
    m = metric("ssd_scan_bwd_roofline.train")
    shapes = [[2, 2048, 32, 64], [2, 2048, 32], [32], [2, 2048, 128], [2, 2048, 128], [],
              [2, 2048, 32, 64]]
    dtypes = ["c10::BFloat16", "float", "float", "c10::BFloat16", "c10::BFloat16", "Scalar",
              "c10::BFloat16"]
    assert round(m.nbytes(shapes, dtypes) / 1e6, 1) == 55.6
    assert round(m.flops(2, 2048, 32, 64, 128, 256) / 1e9, 1) == 26.0


def test_model_flops_count_products_only():
    yi = bench.config_file("yi-9b")
    # a block's products: 173.0 M parameters; the head 262.1 M; no embedding
    one = modelflops.forward_flops(yi, 1, 1, 1, 0) - 4 * 32 * 128 * 1
    assert round(one / 2 / 1e6, 1) == 173.0
    head = modelflops.forward_flops(yi, 0, 1, 1, 1)
    assert round(head / 2 / 1e6, 1) == 262.1
    assert modelflops.train_flops(yi, 4, 2, 16) == 3 * modelflops.forward_flops(yi, 4, 2, 16, 32)
    mb = bench.config_file("mamba2-370m")
    assert modelflops.prefill_flops(mb, 48, 1, 256) > 0


def _trace(device_ops, ops, work, config):
    end = max(e for _, _, e in device_ops)
    return TraceData(window_s=end / 1e9, device_ops=device_ops,
                     spans=[("bench.window", 0, end), ("bench.prefill_step", 0, end)],
                     window_ns=(0, end), ops=ops, shaped_device_ops=device_ops, work=work,
                     config=config, kind=KIND)


def test_readers_on_a_trace():
    yi = bench.config_file("yi-9b")
    q, k = [2, 512, 32, 128], [2, 512, 4, 128]
    m = metric("flash_fwd_roofline.prefill")
    bound_ns = max(m.nbytes(q, k, 2, False) / 3.35e12, m.flops(2, 512, 512, 32, 128) / 989e12) * 1e9
    ops = [("flash_fwd_kernel_wgmma<128>", 100, 100 + int(2 * bound_ns)),
           ("elementwise_kernel", 2 * int(bound_ns) + 200, 2 * int(bound_ns) + 400)]
    calls = [OpCall("repro_torch::flash_attention_fwd", [q, k, k, [], [], [], []],
                    ["c10::BFloat16"] * 3 + ["Scalar"] * 4, [None] * 3 + [True, 0, 0.0, False])]
    tr = _trace(ops, calls, {"requests": 2, "items": [(2, 512)], "layers": 48}, yi)
    assert metric("flash_fwd_roofline.prefill").read(tr) == pytest.approx(50.0, rel=1e-3)
    assert metric("prefill_launches.prefill").read(tr) == 1.0
    busy = tr.busy_s
    assert metric("device_idle_share.prefill").read(tr) == pytest.approx(
        100 * (1 - busy / tr.window_s))
    assert 0 < metric("elementwise_share.prefill").read(tr) < 100
    assert metric("mfu.prefill").read(tr) > 0
    assert metric("flash_bwd_roofline.train").read(tr) is None     # nothing to read
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps and gaps[0][0] == "bench.prefill_step"
    assert tr.breakdown()["device_ops"][0][0].startswith("flash_fwd_kernel")
    tr.kind = "cpu"
    assert metric("mfu.prefill").read(tr) is None
    assert metric("flash_fwd_roofline.prefill").read(tr) is None


def test_kernel_classes():
    assert kernel_class("flash_fwd_kernel_wgmma<128>") == "flash_attention"
    assert kernel_class("flash_bwd_dkdv_wgmma<128>") == "flash_attention_bwd"
    assert kernel_class("void ssd_sm90::chunk_scan<64>") == "ssd_scan"
    assert kernel_class("ssd_bwd_mma_cols") == "ssd_scan_bwd"
    assert kernel_class("sm90_xmma_gemm_bf16") == "matmul"
    assert kernel_class("vectorized_elementwise_kernel") == "elementwise/cast"
