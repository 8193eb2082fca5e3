"""A model axis that does not divide a split dim: the port's sharded train
step, prefill and decode on a (2, 3) ``("data", "model")`` mesh of 6 gloo
CPU ranks, against the JAX package's jitted sharded step and its jitted
sharded prefill + decode on 6 virtual devices.

The rule table is divisibility-guarded: a model axis of 3 is dropped from
every leaf whose dim it does not divide (the padded vocab 512, ``d_ff``
128, ``n_heads·head_dim`` 64, …), and every model rank computes those
products whole, as GSPMD runs the reference there, while the leaves whose
dim it divides stay split.  The cases (``torch_mesh_train_worker.
UNDIVIDED_CASES`` and ``torch_mesh_serve_worker.UNDIVIDED_CASES``): yi-9b
smoke with every split dim whole, in training also under
``seq_shard_activations``; deepseek-moe-16b smoke, its shared experts
split and its experts through the global dispatch; and one case of each
other family with a width made by ``cfg.replace`` so that 3 divides one
split dim and not another: mamba2-370m (its inner width split, its heads
whole: the rank's channels joined for the scan), recurrentgemma-9b (its
RG-LRU width split, the rest whole), phi-3-vision-4.2b with its patches
and seamless-m4t-medium (the MLPs split, the attentions whole; in training
under ``seq_shard_activations``, the frames cut).

Held at the reference tests' tolerances: training's loss, aux loss and
grad norm at 1e-4 relative and every parameter and moment after 2 steps at
1e-4; serving's logits of the prefill and of 3 greedy decode steps at 1e-4,
the tokens equal, and every rank's block of every cache leaf, laid out as
the reference's ``cache_shardings``, at 1e-4.  Also: each rank's state and
cache bytes against the rule table's share, and every config, full and
smoke, admitted on model axes of 3 and 6.

The ranks run in ``tests/torch_mesh_train_worker.py`` and
``tests/torch_mesh_serve_worker.py`` (world 6), the reference in three
subprocesses of 6 host devices; all start together.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.parallel import mesh_ctx  # noqa: E402
from repro_torch.parallel.sharding import param_shardings, spec_for  # noqa: E402
from repro_torch.train.step import train_state_shapes  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_torch_mesh_serve as serve_tests  # noqa: E402
import test_torch_mesh_train as train_tests  # noqa: E402
import torch_mesh_serve_worker as serve_worker  # noqa: E402
import torch_mesh_train_worker as train_worker  # noqa: E402

torch.set_num_threads(2)

SRC = os.path.join(HERE, "..", "src")
WORLD = 6
TIMEOUT = 300
TOL = 1e-4
TRAIN_CASES = list(train_worker.UNDIVIDED_CASES)
SERVE_CASES = list(serve_worker.UNDIVIDED_CASES)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The train task's ranks and the reference's sharded steps (two
    processes), started, then the serve task's ranks beside the
    reference's sharded prefill and decode (``serve_run``), then the train
    processes awaited."""
    d = tmp_path_factory.mktemp("mesh_undivided_train")
    inputs = train_tests._inputs(d, TRAIN_CASES, seed=300)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jax_env = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                   JAX_PLATFORMS="cpu")
    parts = [TRAIN_CASES[i::2] for i in range(2)]

    def start(args, env):
        return subprocess.Popen([sys.executable, *args], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = [start(["-c", textwrap.dedent(train_tests._JAX_STEPS), str(d), HERE,
                    ",".join(part)], jax_env) for part in parts]
    procs.append(start([os.path.join(HERE, "torch_mesh_train_worker.py"), str(d), str(WORLD),
                        "train", ",".join(TRAIN_CASES)], env))
    try:
        serve = serve_tests.serve_run(tmp_path_factory.mktemp("mesh_undivided_serve"),
                                      SERVE_CASES, 400, world=WORLD)
        logs = []
        for proc in procs:
            o, e = proc.communicate(timeout=TIMEOUT)
            logs.append((proc.returncode, o[-2000:] + e[-4000:]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for rc, log in logs:
        assert rc == 0, log
    jax_out = {}
    for part in parts:
        jax_out.update(np.load(d / f"jax_steps-{part[0]}.npz"))
    return {"inputs": inputs, "jax": jax_out, "serve": serve,
            "train": [dict(np.load(d / f"train-rank{r}.npz")) for r in range(WORLD)]}


def _ctx(case, cases):
    _, (shape, axes) = cases[case][:2]
    knobs = cases[case][-1]
    return launch_mesh.make_ctx(dict(zip(axes, shape)), **knobs)


def _whole(cfg, ctx):
    """The leaves of ``cfg``'s parameter tree whose spec the rule table
    (ours) gives no model axis although its rule names one: the products a
    rank computes whole."""
    specs = param_shardings(tlm.init_shapes(cfg), ctx)
    full = param_shardings(tlm.init_shapes(cfg), launch_mesh.make_ctx({"data": 2, "model": 1}))
    out = []
    for path, spec in train_worker.flatten(specs).items():
        split_somewhere = "model" in str(train_worker.flatten(full)[path])
        if split_somewhere and not any(ctx.model_axis in mesh_ctx.spec_axes(e) for e in spec):
            out.append(path)
    return out


# ==========================================================================
# training
# ==========================================================================


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_undivided_step_matches_jax_sharded_step(run, case):
    """Loss, MoE aux loss and grad norm of both steps at 1e-4 relative on
    every rank, every rank the same loss, and every gathered parameter and
    moment after the last step at 1e-4 (``_hold_state``)."""
    want, ranks = run["jax"], run["train"]
    for r, out in enumerate(ranks):
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(out[f"{case}/{key}"], want[f"{case}/{key}"], rtol=TOL,
                                       err_msg=f"rank {r} {key}")
        np.testing.assert_array_equal(out[f"{case}/loss"], ranks[0][f"{case}/loss"])
    train_tests._hold_state(ranks[0], want, case)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_undivided_step_holds_the_rule_tables_share(run, case):
    """A rank's bytes of parameters and moments: each leaf's global bytes
    over the sizes of the axes its spec shards it on, a whole leaf's over
    the data axis alone; the case leaves some leaves whole and splits
    others over the model axis."""
    ctx = _ctx(case, train_worker.UNDIVIDED_CASES)
    cfg = train_worker.case_config(case)
    state = train_state_shapes(cfg)
    specs = param_shardings(state, ctx)
    want = 0
    for leaf, spec in zip(tree_leaves(state), tree_leaves(specs)):
        n = 1
        for e in spec:
            for a in mesh_ctx.spec_axes(e):
                n *= ctx.axis_size(a)
        want += leaf.numel() * leaf.element_size() // n
    for out in run["train"]:
        assert int(out[f"{case}/state_bytes"]) == want
    whole = _whole(cfg, ctx)
    assert whole and "embed" in whole
    split = {"ds3": "blocks/s0/moe/shared/w_up", "mamba3": "blocks/s0/ssm/wx",
             "rg3": "blocks/s0/rec/w_x", "phi3": "blocks/s0/mlp/w_up",
             "m4t3-seq": "encoder/blocks/mlp/w_up"}.get(case)
    if split:
        assert split not in whole


# ==========================================================================
# serving
# ==========================================================================


@pytest.mark.parametrize("case", SERVE_CASES)
def test_undivided_serving_logits_and_tokens_match_jax(run, case):
    """``test_torch_mesh_serve.check_logits_and_tokens`` on the (2, 3)
    ranks: the logits over the whole vocab on every model rank, placed as
    the reference's out_shardings (the guard drops the model axis)."""
    serve_tests.check_logits_and_tokens(run["serve"], case)
    assert "model" not in str(run["serve"]["ranks"][0][f"{case}/logits_spec"])


@pytest.mark.parametrize("key", ["prefill", "decode"])
@pytest.mark.parametrize("case", SERVE_CASES)
def test_undivided_cache_blocks_match_jax(run, case, key):
    """``test_torch_mesh_serve.check_cache_blocks``: every rank's block of
    every cache leaf, whole where the guard leaves it whole."""
    serve_tests.check_cache_blocks(run["serve"], case, key)


@pytest.mark.parametrize("case", SERVE_CASES)
def test_undivided_cache_holds_the_rule_tables_share(run, case):
    """``test_torch_mesh_serve.check_cache_bytes``."""
    serve_tests.check_cache_bytes(run["serve"], case, case)


# ==========================================================================
# every config admitted
# ==========================================================================


@pytest.mark.parametrize("model", [3, 6])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_check_sharded_admits_every_config_on_undivided_axes(arch, model):
    """``lm.check_sharded`` admits each config, full and smoke, on (2,
    model), as the reference's guard runs them all; a model axis of 3 or 6
    leaves some split dim of each whole (the padded vocab of most)."""
    for cfg in (tconfigs.get(arch), tconfigs.get_smoke(arch)):
        ctx = launch_mesh.make_ctx({"data": 2, "model": model})
        tlm.check_sharded(cfg, ctx, seq_len=2048)
        assert _whole(cfg, ctx), cfg.name


def test_spec_for_drops_only_what_it_does_not_divide():
    """The (2, 3) rule table on the mamba3 case's config: the inner width
    192 split, the 4 heads' ``wdt`` and the vocab whole."""
    cfg = train_worker.case_config("mamba3")
    ctx = launch_mesh.make_ctx({"data": 2, "model": 3})
    d = cfg.d_model
    assert spec_for(("wx",), torch.empty(d, 192, device="meta"), ctx) == ("data", "model")
    assert spec_for(("wdt",), torch.empty(d, 4, device="meta"), ctx) == ("data", None)
    assert spec_for(("embed",), torch.empty(512, d, device="meta"), ctx) == (None, "data")
