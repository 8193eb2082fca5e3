"""On the card: every cell at smoke size through the port's kernels, the check
included, and a traced run whose per-layer readers find their numbers.
Skips without a CUDA card."""

from __future__ import annotations

import pytest
import torch

from perfbench.harness import bench
from perfbench.tests.smoke import smoke_bench

SPEC = bench.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    b = smoke_bench(cell, 4_000_000_007, trace=True)
    b.device = card
    r = bench.run_bench(b)
    out, _ = bench.report(b, r, SPEC)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert any(m.startswith(("prefill_launches.", "train_launches.")) for m in out["metrics"])
