"""A whole run of each cell at smoke size (the look for a card left out) with
the timed path broken underneath: ``correct`` has to come out false, once
for each fault the cell can have.  Serving: a token altered where it is
produced (the least likely one served), a prefill that returns its cache
unchanged (as initialised), half of the batch left out.  Training: a step
that returns its state unchanged, half of the batch left out (the mean over
the rest).  One card, so no exchange between chips exists to leave out."""

from __future__ import annotations

import pytest
import torch

from perfbench.harness import bench
from perfbench.tests import readings
from perfbench.tests.smoke import run_smoke

SPEC = bench.benchmark_spec()
PREFILL = [w["name"] for w in SPEC["workloads"] if w["name"].endswith(".prefill")]
TRAIN = [w["name"] for w in SPEC["workloads"] if w["name"].endswith(".train")]
SEED = 2_147_483_659


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(cell):
    b, r = run_smoke(cell, SEED)
    return bench.report(b, r, SPEC)[0]["correct"]


def _altered_token(monkeypatch, engine, lm):
    monkeypatch.setattr(engine, "greedy_token", lambda logits: logits.argmin(-1)[:, None])


def _cache_unchanged(monkeypatch, engine, lm):
    orig = engine.make_prefill_step

    def make(cfg, *, max_len):
        step = orig(cfg, max_len=max_len)

        def prefill_step(params, inputs):
            cache, logits = step(params, inputs)
            fresh = lm.init_cache(cfg, inputs["tokens"].shape[0], max_len,
                                  device=inputs["tokens"].device)
            return fresh, logits
        return prefill_step
    monkeypatch.setattr(engine, "make_prefill_step", make)


def _half_prompts(monkeypatch, engine, lm):
    orig = engine.make_prefill_step

    def make(cfg, *, max_len):
        step = orig(cfg, max_len=max_len)

        def prefill_step(params, inputs):
            half = inputs["tokens"][: inputs["tokens"].shape[0] // 2]
            cache, logits = step(params, {"tokens": half})
            twice = lambda t: torch.cat([t, t], dim=1 if t.dim() > 2 else 0)  # noqa: E731
            blocks = {k: {n: twice(v) for n, v in d.items()} for k, d in cache["blocks"].items()}
            return {**cache, "blocks": blocks}, torch.cat([logits, logits])
        return prefill_step
    monkeypatch.setattr(engine, "make_prefill_step", make)


@pytest.mark.parametrize("fault", [_altered_token, _cache_unchanged, _half_prompts],
                         ids=["token", "unchanged", "half"])
@pytest.mark.parametrize("cell", PREFILL)
def test_prefill_fault_is_caught(cell, fault, monkeypatch):
    from repro_torch.models import lm
    from repro_torch.serve import engine
    fault(monkeypatch, engine, lm)
    assert not _correct(cell)


def _state_unchanged(monkeypatch, step_mod):
    orig = step_mod.make_train_step

    def make(cfg, **kw):
        inner = orig(cfg, **kw)

        def train_step(state, batch):
            return state, inner(state, batch)[1]
        return train_step
    monkeypatch.setattr(step_mod, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_is_caught(cell, fault, monkeypatch):
    from repro_torch.train import step as step_mod
    if fault == "unchanged":
        _state_unchanged(monkeypatch, step_mod)
        assert not _correct(cell)
    else:
        with readings.half_batch():
            assert not _correct(cell)
