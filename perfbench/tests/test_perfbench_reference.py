"""The references at smoke size on the CPU: each agrees with the port within
its cell's limits through a whole run of the cell (the check after the
window included), and its control, the same reference with fp8 products put
in the port's place, comes out not correct through the same run."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench.harness import bench, compare
from perfbench.reference import mamba2
from perfbench.tests import readings
from perfbench.tests.smoke import run_smoke, smoke_bench

CELLS = [w["name"] for w in bench.benchmark_spec()["workloads"]]
SEED = 3_000_000_019          # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_port_is_correct(cell):
    b, r = run_smoke(cell, SEED)
    out, err = bench.report(b, r, bench.benchmark_spec())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   bench.cell_metrics(bench.benchmark_spec(), cell, "end_to_end")}
    assert list(out)[-1] == "checks"
    assert all(line.startswith("check ") for line in err)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    b = smoke_bench(cell, SEED)
    with readings.control(b):
        r = bench.run_bench(b)
    out, err = bench.report(b, r, bench.benchmark_spec())
    assert not out["correct"], out["checks"]
    assert any(line.endswith("FAILED") for line in err), err


def test_same_seed_same_inputs():
    b = smoke_bench("yi-9b.train", SEED)
    from perfbench.harness.traffic import Traffic
    t1, t2 = (Traffic(b.traffic, SEED, 512) for _ in range(2))
    assert torch.equal(t1.batch(3, torch.device("cpu"))["tokens"],
                       t2.batch(3, torch.device("cpu"))["tokens"])
    t3 = Traffic(b.traffic, SEED + 1, 512)
    assert not torch.equal(t1.batch(3, torch.device("cpu"))["tokens"],
                           t3.batch(3, torch.device("cpu"))["tokens"])


def test_prefill_lengths_are_the_same_work_for_every_seed():
    b = smoke_bench("yi-9b.prefill", 1)
    from perfbench.harness.traffic import Traffic
    cycle = b.traffic["cycle"]
    a, c = Traffic(b.traffic, 1, 512), Traffic(b.traffic, 2**31 + 11, 512)
    for k in range(3):
        la = [a.length(k * cycle + i) for i in range(cycle)]
        lc = [c.length(k * cycle + i) for i in range(cycle)]
        assert sorted(la) == sorted(lc) and la[-1] == b.traffic["long_length"]
    sample = a.check_sample()
    assert any(a.is_long(i) for i in sample) and max(sample) < b.traffic["check_from"]


def test_ssd_reference_matches_the_recurrence():
    g = torch.Generator().manual_seed(0)
    l, h, p, n = 12, 3, 4, 5
    x = torch.randn(l, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(l, h, generator=g, dtype=torch.float64) * 0.5
    a = -torch.rand(h, generator=g, dtype=torch.float64) * 2
    bm = torch.randn(l, n, generator=g, dtype=torch.float64)
    cm = torch.randn(l, n, generator=g, dtype=torch.float64)
    y, last = mamba2.ssd(x, dt, a, bm, cm, chunk=4)
    state = torch.zeros(h, p, n, dtype=torch.float64)
    for t in range(l):
        state = state * torch.exp(dt[t] * a)[:, None, None] \
            + dt[t][:, None, None] * x[t][:, :, None] * bm[t][None, None, :]
        assert torch.allclose(y[t], torch.einsum("hpn,n->hp", state, cm[t]), atol=1e-10)
    assert torch.allclose(last, state, atol=1e-10)


def test_fp8_control_rounds_and_passes_gradients():
    from perfbench.reference.common import fp8, mm
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    q = fp8(x)
    assert not torch.equal(q.detach(), x.detach())
    assert torch.allclose(q.detach(), x.detach(), rtol=2 ** -3, atol=1e-3)
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    a, w = torch.randn(4, 8), torch.randn(8, 3)
    assert torch.allclose(mm(a, w, "fp32"), a @ w)
    with pytest.raises(ValueError):
        mm(a, w, "int4")
    assert math.isfinite(float(mm(a, w, "fp8").sum()))


def test_one_small_leaf_moves_the_worst_gap_not_the_median():
    ref = {f"blocks/w[{i}]": 1.0 for i in range(8)}
    ref["blocks/D[0]"] = 0.01
    keep = compare.kept_leaves(ref)
    noisy = dict(ref, **{"blocks/D[0]": 0.2})
    assert compare.leaf_gap(noisy, ref, keep) == pytest.approx(0.19)
    assert compare.worst_leaf(noisy, ref, keep) == "blocks/D[0]"
    assert compare.median_leaf_gap(noisy, ref, keep) == 0.0
    scaled = {k: 1.1 * v for k, v in ref.items()}
    assert compare.median_leaf_gap(scaled, ref, keep) == pytest.approx(0.1)

