"""Cells at smoke size on the CPU: the port's smoke configurations and short
mixes, everything else as a run on the card does it (the look for a card
left out).  Used by the tests here."""

from __future__ import annotations

import copy
import time

import torch

from perfbench.harness import bench

#: each configuration file's widths cut to the port's smoke config
SMOKE_CONFIG = {
    "yi-9b": {"hidden_size": 64, "num_attention_heads": 8, "num_key_value_heads": 2,
              "intermediate_size": 128, "vocab_size": 512},
    "mamba2-370m": {"d_model": 64, "vocab_size": 512, "d_state": 16, "headdim": 16,
                    "chunk_size": 16},
}
SMOKE_LAYERS = 3
#: each kind of traffic at smoke size
SMOKE_TRAFFIC = {
    "prefill": {"batch": 2, "cycle": 4, "min_length": 16, "max_length": 48, "multiple": 16,
                "long_length": 64, "trace_from": 4, "trace_requests": 4, "check_from": 8,
                "check_requests": 3},
    "train": {"batch": 2, "seq_len": 32, "check_steps": 3, "trace_from": 1, "trace_steps": 1},
}


#: each cell's limits at smoke size, set from smoke-size readings by the rule
#: the cells' own follow (above the sound port's widest reading over six
#: seeds on the CPU and one on the card, below the fp8 control's narrowest):
#: smoke widths and depths read other numbers than the cells' sizes do.
#: yi-9b.train's loss gap is not compared here: the sound port read 0.0042 on
#: the card, the control 0.006 at its narrowest, less than three times apart
SMOKE_LIMITS = {
    "yi-9b.prefill": {"token_gap": 0.2, "logits_err": 0.06, "cache_err": 0.06},
    "mamba2-370m.prefill": {"token_gap": 0.2, "logits_err": 0.06, "cache_err": 0.08},
    "yi-9b.train": {"grad_gap": 0.015, "update_gap": 0.005},
    "mamba2-370m.train": {"grad_gap": 0.04, "update_gap": 0.06},
}


def smoke_bench(cell: str, seed: int, seconds: float = 0.3, trace: bool = False) -> bench.Bench:
    from repro_torch import configs
    wl = dict(bench.workload_file(cell), limits=SMOKE_LIMITS[cell])
    config = copy.deepcopy(bench.config_file(wl["config"]))
    config.update(SMOKE_CONFIG[wl["config"]])
    traffic = dict(bench.traffic_file(wl["traffic"]))
    traffic.update(SMOKE_TRAFFIC[traffic["driver"]])
    config["layers"] = {traffic["driver"]: SMOKE_LAYERS}
    b = bench.Bench(cell=cell, workload=wl, config=config, traffic=traffic, seed=seed,
                    seconds=seconds, trace=trace, device=torch.device("cpu"),
                    t0=time.perf_counter())
    b.model_cfg = bench.port_config(config, SMOKE_LAYERS,
                                    base=configs.get_smoke(config["port"]["arch"]))
    return b


def run_smoke(cell: str, seed: int, **kw):
    b = smoke_bench(cell, seed, **kw)
    r = bench.run_bench(b)
    return b, r
