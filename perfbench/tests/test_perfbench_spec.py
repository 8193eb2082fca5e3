"""BENCHMARK.json and the files the harness finds by name agree, and a new
cell, traffic mix, driver or metric is found from its file alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from perfbench.harness import bench

SPEC = bench.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_workload_file_names_existing_files(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = bench.workload_file(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key], key
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    config = bench.config_file(wl["config"])
    traffic = bench.traffic_file(wl["traffic"])
    assert (bench.PERFBENCH / "drivers" / (traffic["driver"] + ".py")).is_file()
    assert (bench.PERFBENCH / "reference" / (config["reference"] + ".py")).is_file()
    depth = bench.published_depth(config)
    assert 1 <= config.get("layers", {}).get(traffic["driver"], depth) <= depth
    for section in ("end_to_end", "per_layer"):
        for m in bench.cell_metrics(SPEC, cell, section):
            if section == "per_layer":
                assert callable(bench.file_module("metrics", m["name"]).read)
    names = {m["name"] for m in bench.cell_metrics(SPEC, cell, "end_to_end")}
    assert "setup_s" in names and len(names) >= 2
    assert bench.cell_metrics(SPEC, cell, "per_layer")


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entries_match_their_files(config):
    data = json.loads((bench.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert config["file"].startswith("perfbench/")
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in config["reduced"])
    # a depth cut for some driver is the one key changed from the source
    depth_key = next(k for k in bench.DEPTH_KEYS if k in data)
    assert (depth_key in config["reduced"]) == bool(data.get("layers"))


def test_names_units_and_lines():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(bench.NAME_RE.match(n) for n in names), names
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert bench.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for cell in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in bench.cell_metrics(SPEC, cell, "end_to_end")}
    for w in SPEC["workloads"] + SPEC["configs"]:
        assert LINE.match(w["why"])
    for path in bench.PERFBENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(bench.ROOT))), path


def test_dropped_files_are_found_without_an_edit(tmp_path, monkeypatch):
    """A new cell, traffic mix, driver and per-layer metric are new files
    only: the configuration file they run stays as it is."""
    for kind in ("workloads", "configs", "traffic", "metrics", "drivers", "reference"):
        shutil.copytree(bench.PERFBENCH / kind, tmp_path / kind)
    (tmp_path / "traffic" / "echo_mix.json").write_text(json.dumps(
        {"driver": "echo", "batch": 1, "seq_len": 8}))
    (tmp_path / "workloads" / "yi-9b.echo.json").write_text(json.dumps(
        {"name": "yi-9b.echo", "config": "yi-9b", "traffic": "echo_mix", "chips": 1,
         "why": "a cell dropped in", "limits": {"echo_gap": 0.5}}))
    (tmp_path / "drivers" / "echo.py").write_text(
        "from perfbench.harness.bench import Check, Result\n"
        "def run(b):\n"
        "    b.start_window(b.t0 + 0.25)\n"
        "    return Result(attempted=b.layers, failed=0, end_to_end={'echo_s': 1.0},\n"
        "                  checks=[Check('echo_gap', 0.0, b.limits['echo_gap'])],\n"
        "                  memory_peak_bytes=0)\n")
    (tmp_path / "metrics" / "echo_count.train.py").write_text(
        "def read(trace):\n    return 7.0\n")
    before = (bench.PERFBENCH / "configs" / "yi-9b.json").read_text()
    monkeypatch.setattr(bench, "PERFBENCH", tmp_path)
    assert (tmp_path / "configs" / "yi-9b.json").read_text() == before
    b = bench.make_bench("yi-9b.echo", 1, 1.0, False, torch.device("cpu"), 0.0)
    assert b.layers == 48 and b.model_cfg.n_layers == 48      # the published depth
    r = bench.run_bench(b)
    spec = {"end_to_end": [{"name": "echo_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "echo_count.train", "unit": "n", "moves": "echo_s"}]}
    out, _ = bench.report(b, r, spec)
    assert out["correct"] and out["attempted"] == 48
    assert out["metrics"] == {"echo_s": {"value": 1.0, "unit": "s"},
                              "setup_s": {"value": 0.25, "unit": "s"}}
    b.trace, r.trace = True, None
    assert bench.report(b, r, spec)[0]["metrics"] == {"echo_count.train": {"value": 7.0,
                                                                           "unit": "n"}}


def test_grouped_metric_reads_the_drivers_quantity():
    """``<quantity>.<group>`` is the driver's ``<quantity>`` in that group's cells."""
    b = bench.Bench(cell="c", workload={}, config={}, traffic={}, seed=1, seconds=1.0,
                    trace=False, device=torch.device("cpu"), t0=0.0, window_t0=2.0)
    r = bench.Result(attempted=1, failed=0, end_to_end={"train_tokens_per_s": 5.0},
                     checks=[], memory_peak_bytes=0)
    spec = {"end_to_end": [{"name": "train_tokens_per_s.host_paced", "unit": "tokens/s",
                            "workloads": ["c"]}], "per_layer": []}
    assert bench.report(b, r, spec)[0]["metrics"] == {
        "train_tokens_per_s.host_paced": {"value": 5.0, "unit": "tokens/s"}}
