"""The port's prefill and decode on sharded parameters for the recurrent and
enc-dec families, on gloo process groups of CPU ranks, against the JAX
package's jitted sharded prefill and decode on 8 virtual devices (as in
``test_torch_mesh_serve.py``, whose checks these cases share), for every
fp32 case of ``torch_mesh_serve_worker.RECURRENT_CASES`` (smoke configs, B
8, prompt 32, rings of 40 slots, a prefill and 3 greedy decode steps):
mamba2-370m on (2, 4) (its SSM state over the heads, the B/C conv tails
over N) with and without ``seq_shard_activations``; recurrentgemma-9b on
(2, 4) (its RG-LRU state over the width; the local layer's window ring,
rolled by the prompt, over its one kv head's head_dim, or with
``shard_kv_seq`` over its slots; 2 remainder layers); seamless-m4t-medium
with 4 frames on (2, 2, 2) with FSDP over ("pod", "data") (the projected
memory over the kv heads), on (2, 4) with ``shard_kv_seq`` (the memory's 4
rows over the model axis) and with ``seq_shard_activations``.  Held at the
reference tests' 1e-4: the logits of every step, every rank's block of
every cache leaf (``h``, each conv tail, ``k``/``v``, ``mk``/``mv``) and
its placement, and the greedy tokens, equal.  Also a bf16 mamba2-370m case
against the port's own single-process steps, the fp32 ones likewise, each
rank's cache bytes against the rule table's share, and the collectives of
one SSM decode step and of one cross-attention on the memory's rows.

The ranks run in ``tests/torch_mesh_serve_worker.py`` (a subprocess with a
timeout), the reference in two subprocesses with 8 host devices; all start
together.  A file of its own, so that xdist's ``loadfile`` runs it beside
``test_torch_mesh_serve.py`` and neither comes near its timeout.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_torch_mesh_serve as base  # noqa: E402
import torch_mesh_serve_worker as worker  # noqa: E402
from repro_torch.launch.mesh import make_ctx  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.parallel.sharding import param_spec  # noqa: E402

CASES = list(worker.RECURRENT_CASES)
FP32_CASES = [c for c in CASES if c not in worker.BF16_CASES]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return base.serve_run(tmp_path_factory.mktemp("mesh_serve_recurrent"), CASES, 40)


@pytest.mark.parametrize("case", FP32_CASES)
def test_sharded_serving_logits_and_tokens_match_jax(run, case):
    """:func:`test_torch_mesh_serve.check_logits_and_tokens`."""
    base.check_logits_and_tokens(run, case)


@pytest.mark.parametrize("key", ["prefill", "decode"])
@pytest.mark.parametrize("case", FP32_CASES)
def test_each_ranks_cache_block_matches_jax(run, case, key):
    """:func:`test_torch_mesh_serve.check_cache_blocks`: the recurrent
    states and the projected memory too."""
    base.check_cache_blocks(run, case, key)


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_the_rule_tables_share_of_the_cache(run, case):
    """:func:`test_torch_mesh_serve.check_cache_bytes` (mamba2-bf16's
    global shapes are mamba2's; its ``h`` stays fp32)."""
    base.check_cache_bytes(run, case, case if case not in worker.BF16_CASES else "mamba2")


@pytest.mark.parametrize("case", FP32_CASES)
def test_sharded_serving_matches_single_process(run, case):
    """:func:`test_torch_mesh_serve.check_single_process`."""
    base.check_single_process(run, case)


def test_sharded_serving_bf16_matches_single_process(run):
    """mamba2-370m smoke in bf16 compute on (2, 4):
    :func:`test_torch_mesh_serve.check_bf16_single_process`."""
    base.check_bf16_single_process(run, "mamba2-bf16")


def _gathered_bytes(names, shapes, mesh, knobs):
    """The fp32 bytes that ``use_param`` all-reduces to read the parameters
    ``names`` of global ``shapes`` on a rank: each one's FSDP-gathered block
    (its model-axis split kept), for those whose spec has an FSDP axis."""
    ctx = make_ctx(dict(zip(mesh[1], mesh[0])), **knobs)
    total, calls = 0, 0
    for name, shape in zip(names, shapes):
        spec = param_spec(name, shape, ctx)
        fsdp = [a for e in spec for a in ((e,) if isinstance(e, str) else (e or ()))
                if a != ctx.model_axis]
        if not fsdp:
            continue
        n = 4
        for dim, e in zip(shape, spec):
            n *= dim // (ctx.model_size if e == ctx.model_axis else 1)
        total, calls = total + n, calls + len(fsdp)
    return total, calls


def test_ssm_decode_step_joins_b_and_c_and_moves_no_state(run):
    """mamba2-370m on (2, 4), its N 16 over the model axis: one SSM decode
    step a layer makes the FSDP gathers of its weights, one all-reduce that
    joins the rank's 4 channels of B and C after the conv ([2, B_loc, N]),
    and the output's sum over the model axis ([B_loc, 1, D]); none of the
    state (``h``, the conv tails) moves."""
    _, mesh, _, knobs = worker.RECURRENT_CASES["mamba2"]
    cfg = worker.case_config("mamba2")
    di, nh, _, n = tssm.dims(cfg)
    d, b_loc = cfg.d_model, worker.BATCH // mesh[0][0]
    weights = {"wz": (d, di), "wx": (d, di), "wb": (d, n), "wc": (d, n), "wdt": (d, nh),
               "w_out": (di, d)}
    wbytes, wcalls = _gathered_bytes(list(weights), list(weights.values()), mesh, knobs)
    join, out_sum = 2 * b_loc * n * 4, b_loc * d * 4
    for out in run["ranks"]:
        calls = out["mamba2/ssm_collectives"]        # [step, layer, (calls, bytes, largest)]
        assert calls.shape == (worker.DECODE, cfg.n_layers, 3)
        assert (calls[..., 0] == wcalls + 2).all()
        assert (calls[..., 1] == wbytes + join + out_sum).all()


def test_cross_attention_on_memory_rows_moves_scores_not_the_memory(run):
    """seamless-m4t-medium on (2, 4) with ``shard_kv_seq``: the memory's 4
    rows over the model axis, one a rank.  One cross-attention decode step a
    layer makes the FSDP gathers of ``wq`` and ``wo``, the gather of q's
    heads, the split softmax's max, denominator and numerator, and the
    output's sum over the model axis; the attention's own traffic (q and
    the softmax's three) is less than one of the batch block's ``mk``
    whole."""
    _, mesh, _, knobs = worker.RECURRENT_CASES["m4t-kvseq"]
    cfg = worker.case_config("m4t-kvseq")
    d, hd, h, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    b_loc = worker.BATCH // mesh[0][0]
    wbytes, wcalls = _gathered_bytes(["wq", "wo"], [(d, h * hd), (h * hd, d)], mesh, knobs)
    attend = b_loc * h * hd * 4 + 2 * b_loc * h * 4 + b_loc * h * hd * 4
    assert attend < b_loc * worker.FRAMES * hkv * hd * 4
    for out in run["ranks"]:
        calls = out["m4t-kvseq/cross_collectives"]
        assert calls.shape == (worker.DECODE, cfg.n_layers, 3)
        assert (calls[..., 0] == wcalls + 5).all()
        assert (calls[..., 1] == wbytes + attend + b_loc * d * 4).all()
