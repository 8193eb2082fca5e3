"""The port's sharded train step on gloo process groups of CPU ranks,
against the JAX package's jitted sharded step on 8 virtual devices:

    jax.jit(make_train_step(cfg),
            in_shardings=(param_shardings(state), input_shardings(batch)),
            out_shardings=(state_shardings, None))

on the same converted weights and batches, for every case of
``torch_mesh_train_worker.CASES``: yi-9b smoke on (2, 4) at L 64 and at L
2048 (the reference's flash branch and heads hint; the model axis splits
each kv head), qwen1.5-110b smoke (q/k/v biases), gemma2-27b smoke (local
and global layers, both softcaps, tied embeddings, post-norms) on (2, 2, 2)
``("pod", "data", "model")`` with FSDP over ``data`` and over ``("pod",
"data")``, yi-9b with ``seq_shard_activations``, yi-9b with
``gather_dtype="bfloat16"`` and yi-9b in bf16 compute; the recurrent
families: mamba2-370m smoke on (2, 4) (the SSM's heads over the model
axis), with and without ``seq_shard_activations``, and recurrentgemma-9b
smoke on (2, 2, 2) with FSDP over ``("pod", "data")`` (the RG-LRU width
over the model axis, stacked and remainder layers, local attention with
one kv head), in fp32 and in bf16 compute; the MoE family, expert
parallel at the configs' own capacity factor: deepseek-moe-16b smoke on
(2, 4) (shared experts wider than the flag ``d_ff``), with and without
``seq_shard_activations``, and dbrx-132b smoke on (2, 2, 2) with FSDP over
``("pod", "data")``, and dbrx-132b smoke on (1, 8), whose 4 experts the
model axis does not divide (the global dispatch on the gathered tokens),
with and without ``seq_shard_activations``; the multimodal families:
phi-3-vision-4.2b smoke on
(2, 4) with its patch prefix (L 72), with and without
``seq_shard_activations``, and seamless-m4t-medium smoke (encoder and
cross-attention, 8 frames) on (2, 2, 2) with FSDP over ``("pod", "data")``,
in fp32 and in bf16 compute, and on (2, 4) with
``seq_shard_activations``.  After 2 steps: each step's loss, MoE aux loss and
grad norm, and every gathered parameter and both moments, fp32 within the
reference tests' 1e-4, the bf16 losses within 3e-2.  The same against the
port's own single-process step, but for the expert-parallel MoE cases,
whose sharded step drops other assignments than the plain one (as the
reference's does), and ``worker.REFERENCE_ONLY``'s "dbrx-global-seq".
Also the twin of
``test_seq_shard_reduces_saved_activations``, each collective's backward
against its adjoint (4 ranks, fp64), each rank's state bytes against the
rule table's share, a sharded save restored sharded (and by the
reference), what the sharded step refuses, and every
full recurrent, MoE and multimodal config's shapes at a rank against the
kernels' domains.

The ranks run in ``tests/torch_mesh_train_worker.py`` (subprocesses with a
timeout, so a hung collective fails these tests and not the suite), the
reference in a subprocess with 8 host devices; all start together.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from unittest import mock

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.parallel import mesh_ctx  # noqa: E402
from repro_torch.parallel import ref as pref  # noqa: E402
from repro_torch.parallel.sharding import param_shardings  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mesh_train_worker as worker  # noqa: E402

torch.set_num_threads(2)

SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 600
FP32_CASES = [c for c in worker.CASES if c not in ("yi-gather",) + worker.BF16_CASES]
TOL = 1e-4          # the reference's train-step tests, fp32
BF16_LOSS_TOL = 3e-2
LR = 3e-4           # make_train_step's default, both packages
#: the reference's cases in three processes of 8 host devices each, run together
JAX_PARTS = [list(worker.CASES)[i::3] for i in range(3)]

_JAX_STEPS = """
import sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import torch_mesh_train_worker as w
from repro import configs
from repro.launch.mesh import make_ctx, make_mesh
from repro.parallel.mesh_ctx import mesh_context
from repro.parallel.sharding import input_shardings, param_shardings
from repro.train import optim
from repro.train.step import make_train_step
d, names = sys.argv[1], sys.argv[3].split(",")
inp = dict(np.load(d + "/inputs.npz"))
out = {}
for name in names:
    arch, (shape, axes), b, l, over, knobs = w.ALL_CASES[name]
    cfg = w.configure(configs.get_smoke(arch), {**w.FP32_OVERRIDES, **over})
    params = jax.tree.map(jnp.asarray, w.unflatten(inp, "params/" + name))
    state = {"params": params, "opt": optim.adamw_init(params),
             "step": jnp.zeros((), jnp.int32)}
    ctx = make_ctx(make_mesh(shape, axes), **knobs)
    with mesh_context(ctx):
        st_sh = param_shardings(state, ctx)
        batches = [{k: jnp.asarray(v) for k, v in w.batch_np(inp, name, s).items()}
                   for s in range(w.STEPS)]
        fn = jax.jit(make_train_step(cfg),
                     in_shardings=(st_sh, input_shardings(ctx, batches[0])),
                     out_shardings=(st_sh, None))
        losses, norms, aux = [], [], []
        for batch in batches:
            state, m = fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            aux.append(float(m["aux"]))
    out[name + "/loss"], out[name + "/grad_norm"] = np.array(losses), np.array(norms)
    out[name + "/aux"] = np.array(aux)
    for k, v in w.flatten(state).items():
        out[f"{name}/state/{k}"] = np.asarray(v.astype(jnp.float32))
        out[f"{name}/dtype/{k}"] = np.array(str(v.dtype))
np.savez(f"{d}/jax_steps-{names[0]}.npz", **out)
print("JAX_STEPS_OK")
"""


def _inputs(d, cases=tuple(worker.CASES), seed=0):
    """Each case's initial parameters from the reference's ``lm.init`` and
    its batches (tokens, next-token labels, a random mask, and a VLM's
    patches [B, n_patches, 1024] or an enc-dec's frames [B, L / 8, 1024]),
    from a seed, the i-th case's ``seed + i``."""
    inputs = {}
    for i, name in enumerate(cases, seed):
        arch, _, b, l, over, _ = worker.ALL_CASES[name]
        jcfg = worker.configure(jconfigs.get_smoke(arch), {**worker.FP32_OVERRIDES, **over})
        params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(i), jcfg))
        inputs.update({f"params/{name}/{k}": v for k, v in worker.flatten(params).items()})
        rng = np.random.default_rng(i)
        for s in range(worker.STEPS):
            toks = rng.integers(0, jcfg.vocab, (b, l + 1)).astype(np.int32)
            inputs[f"batch/{name}/{s}/tokens"] = toks[:, :-1]
            inputs[f"batch/{name}/{s}/labels"] = toks[:, 1:]
            inputs[f"batch/{name}/{s}/mask"] = (rng.random((b, l)) > 0.1).astype(np.float32)
            if jcfg.n_patches:
                inputs[f"batch/{name}/{s}/patches"] = rng.standard_normal(
                    (b, jcfg.n_patches, 1024)).astype(np.float32)
            if jcfg.enc_dec:
                inputs[f"batch/{name}/{s}/frames"] = rng.standard_normal(
                    (b, worker.frames(name), 1024)).astype(np.float32)
    np.savez(d / "inputs.npz", **inputs)
    return inputs


def _single_process(inputs, name):
    """The port's own step in this process on the same weights and batches."""
    cfg = worker.case_config(name)
    params = to_torch(worker.unflatten(inputs, f"params/{name}"), device="cpu")
    state = {"params": params, "opt": optim.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(cfg)
    losses, norms = [], []
    for s in range(worker.STEPS):
        state, m = step(state, worker._batch(inputs, name, s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": np.array(losses), "grad_norm": np.array(norms), "state": state}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    inputs = _inputs(d)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    script = os.path.join(HERE, "torch_mesh_train_worker.py")

    def start(args, env):
        return subprocess.Popen([sys.executable, *args], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = [start(["-c", textwrap.dedent(_JAX_STEPS), str(d), HERE, ",".join(part)], jax_env)
             for part in JAX_PARTS]
    procs += [start([script, str(d), "8", "train,saved,thread,ckpt,refuse"], env),
              start([script, str(d), "4", "adjoint"], env)]
    single = {name: _single_process(inputs, name) for name in worker.CASES}
    logs = []
    for proc in procs:
        try:
            o, e = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{proc.args[:3]} did not finish in {TIMEOUT} s")
        logs.append((proc.returncode, o[-2000:] + e[-4000:]))
    for rc, log in logs:
        assert rc == 0, log

    def ranks(task, n):
        return [dict(np.load(d / f"{task}-rank{r}.npz")) for r in range(n)]

    jax_out = {}
    for part in JAX_PARTS:
        jax_out.update(np.load(d / f"jax_steps-{part[0]}.npz"))
    return {"dir": d, "inputs": inputs, "jax": jax_out,
            "single": single, "train": ranks("train", 8), "saved": ranks("saved", 8),
            "thread": ranks("thread", 8), "ckpt": ranks("ckpt", 8),
            "refuse": ranks("refuse", 8),
            "adjoint": ranks("adjoint", 4)}


def _state_np(state):
    return {k: worker._np(v) for k, v in worker.flatten(state).items()}


# ==========================================================================
# the sharded step against the reference's and the port's own
# ==========================================================================


def _hold_state(got, want, case, *, moments=TOL):
    """Every parameter and moment of ``case`` after the steps, ``got``
    against ``want`` (flat ``<case>/state/<path>`` arrays): the step count
    equal, the moments within ``moments`` of their leaf's largest value, the
    parameters within 1e-4, except where a step's gradient vanished into
    rounding without being zero: with 0 < √v below 1e-6 of its leaf's
    largest, Adam's step m̂/(√v̂ + eps) takes the direction that the
    summation order gives the gradient's sign (fp32 jitted and eager JAX
    disagree there too), so those elements are held to the bound of the
    steps, 2·lr each, and those of them beyond 1e-4 must be fewer than 1e-4
    of the elements (a leaf whose gradient is small everywhere, as the
    RG-LRU's saturated gates, may hold many such elements that agree
    within 1e-4 all the same)."""
    keys = sorted(k for k in want if k.startswith(f"{case}/state/"))
    assert keys and keys == sorted(k for k in got if k.startswith(f"{case}/state/"))
    vanished = total = 0
    for k in keys:
        a, b = got[k], want[k]
        if k.endswith("/state/step"):
            assert int(a) == int(b) == worker.STEPS
            continue
        if "/state/opt/" in k:
            scale = max(float(np.abs(b).max()), 1e-30)
            np.testing.assert_allclose(a, b, atol=moments * scale, err_msg=k)
            continue
        root = np.sqrt(want[k.replace("/state/params/", "/state/opt/v/")])
        flat = (root > 0) & (root < 1e-6 * float(root.max()))
        diff = np.abs(a - b)
        assert float(diff[~flat].max(initial=0.0)) <= TOL, k
        assert float(diff[flat].max(initial=0.0)) <= 2 * LR * worker.STEPS, k
        vanished += int((flat & (diff > TOL)).sum())
        total += flat.size
    assert vanished <= 1e-4 * total, (vanished, total)


@pytest.mark.parametrize("case", FP32_CASES)
def test_sharded_step_matches_jax_sharded_step(run, case):
    """Loss, MoE aux loss and grad norm at every step (rel 1e-4), every
    parameter and moment after the last (1e-4, :func:`_hold_state`), every
    rank the same loss."""
    want, ranks = run["jax"], run["train"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{case}/loss"], want[f"{case}/loss"], rtol=TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{case}/aux"], want[f"{case}/aux"], rtol=TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{case}/grad_norm"], want[f"{case}/grad_norm"],
                                   rtol=TOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{case}/loss"], ranks[0][f"{case}/loss"])
    _hold_state(ranks[0], want, case)


@pytest.mark.parametrize("case", [c for c in FP32_CASES if c not in worker.REFERENCE_ONLY])
def test_sharded_step_matches_single_process_step(run, case):
    single, out = run["single"][case], run["train"][0]
    np.testing.assert_allclose(out[f"{case}/loss"], single["loss"], rtol=TOL)
    np.testing.assert_allclose(out[f"{case}/grad_norm"], single["grad_norm"], rtol=TOL)
    want = {f"{case}/state/{k}": v for k, v in _state_np(single["state"]).items()}
    _hold_state(out, want, case)


def test_sharded_step_bf16_loss(run):
    """bf16 compute: the loss of every step within the reference tests'
    3e-2 of the reference's sharded step and of the port's single-process
    step."""
    for out in run["train"]:
        np.testing.assert_allclose(out["yi-bf16/loss"], run["jax"]["yi-bf16/loss"],
                                   atol=BF16_LOSS_TOL)
        np.testing.assert_allclose(out["yi-bf16/loss"], run["single"]["yi-bf16"]["loss"],
                                   atol=BF16_LOSS_TOL)


def test_multimodal_sharded_step_bf16_loss(run):
    """seamless-m4t-medium smoke in bf16 compute on (2, 2, 2) with FSDP over
    ("pod", "data"): the encoder, the cross-attention and the decoder; the
    loss of every step within 3e-2 of the reference's sharded step and of
    the port's single-process step."""
    for out in run["train"]:
        np.testing.assert_allclose(out["m4t-bf16/loss"], run["jax"]["m4t-bf16/loss"],
                                   atol=BF16_LOSS_TOL)
        np.testing.assert_allclose(out["m4t-bf16/loss"], run["single"]["m4t-bf16"]["loss"],
                                   atol=BF16_LOSS_TOL)


def test_recurrent_sharded_step_bf16_loss(run):
    """recurrentgemma-9b smoke in bf16 compute (the RG-LRU's gate products
    stay fp32, its scan runs in fp32): the loss of every step within 3e-2 of
    the reference's sharded step and of the port's single-process step."""
    for out in run["train"]:
        np.testing.assert_allclose(out["rg-bf16/loss"], run["jax"]["rg-bf16/loss"],
                                   atol=BF16_LOSS_TOL)
        np.testing.assert_allclose(out["rg-bf16/loss"], run["single"]["rg-bf16"]["loss"],
                                   atol=BF16_LOSS_TOL)


def test_gather_dtype_casts_the_blocks_as_the_reference(run):
    """``gather_dtype="bfloat16"``: after the steps the parameters are bf16
    and m, v fp32 on both sides; the first step's loss (the cast weights
    in fp32 compute) within 1e-4.  The gradients are bf16 and the ranks sum
    them in another order than the reference, so the rest is held at bf16's
    resolution: the grad norms within 1e-3, the moments within 3e-2 of their
    leaf's largest; each parameter within the bound of the steps (2·lr
    each: at bf16's resolution a small gradient's sign, and so its Adam
    step, is the summation order's), and all but 1e-3 of them within 2 bf16
    ulps of their leaf's largest."""
    want, out = run["jax"], run["train"][0]
    kinds = dict(str(v).split(":") for v in out["yi-gather/dtypes"])
    ref_kinds = {k[len("yi-gather/dtype/"):]: str(want[k]) for k in want
                 if k.startswith("yi-gather/dtype/")}
    assert kinds == ref_kinds
    assert {v for k, v in kinds.items() if k.startswith("params/")} == {"bfloat16"}
    assert {v for k, v in kinds.items() if k.startswith("opt/")} == {"float32"}
    np.testing.assert_allclose(out["yi-gather/loss"][0], want["yi-gather/loss"][0], rtol=TOL)
    np.testing.assert_allclose(out["yi-gather/loss"], want["yi-gather/loss"], rtol=1e-3)
    np.testing.assert_allclose(out["yi-gather/grad_norm"], want["yi-gather/grad_norm"],
                               rtol=1e-3)
    far = total = 0
    for k in (k for k in want if k.startswith("yi-gather/state/")):
        if "/state/opt/" in k:
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            np.testing.assert_allclose(out[k], want[k], atol=BF16_LOSS_TOL * scale, err_msg=k)
        elif "/state/params/" in k:
            diff = np.abs(out[k] - want[k])
            assert float(diff.max()) <= 2 * LR * worker.STEPS, k
            far += int((diff > 2 ** -7 * float(np.abs(want[k]).max())).sum())
            total += diff.size
    assert far <= 1e-3 * total, (far, total)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_each_rank_holds_the_rule_tables_share(run, case):
    """A rank's bytes of parameters and moments after the steps: each leaf's
    global bytes over the sizes of the axes its spec shards it on."""
    _, (shape, axes), _, _, _, knobs = worker.CASES[case]
    ctx = launch_mesh.make_ctx(dict(zip(axes, shape)), **knobs)
    state = run["single"][case]["state"]
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


def test_sharded_steps_run_collectives(run):
    for out in run["train"]:
        for case in worker.CASES:
            assert int(out[f"{case}/collectives"]) > 0


# ==========================================================================
# activations kept for the backward
# ==========================================================================


def test_seq_shard_reduces_saved_activations(run):
    """The twin of the reference's test: yi-9b smoke, remat "full", (2, 4),
    B 8, L 64.  Rank 0 keeps fewer bytes for the backward with
    ``seq_shard_activations``: the residual stream each checkpointed group
    keeps shrinks by the model axis (4), the tensors autograd saves outside
    the groups shrink too (the final norm runs on the sequence block)."""
    saved, groups = run["saved"][0]["saved/plain"]
    saved_seq, groups_seq = run["saved"][0]["saved/seq"]
    assert saved_seq + groups_seq < saved + groups
    assert groups_seq * 4 == groups
    assert saved_seq < saved


def test_recompute_keeps_the_mesh_context_on_another_thread(run):
    """The remat recompute re-enters the forward's mesh context: with the
    backward on a thread that does not see it (as autograd's device thread
    on the card), the gradients are the same bits."""
    for out in run["thread"]:
        assert float(out["thread/max_diff"]) == 0.0


# ==========================================================================
# the collectives
# ==========================================================================


@pytest.mark.parametrize("name", ["gather", "gather2", "scatter", "reduce", "replicate",
                                  "param_block"])
def test_collective_backward_is_the_adjoint(run, name):
    """fp64 on 4 ranks: Σ_ranks <f(x), y> against Σ_ranks <x, f'(y)> with the
    worker's convention for values held alike (``_adjoint``), on every rank."""
    for out in run["adjoint"]:
        a, b = out[f"adjoint/{name}"]
        assert a == pytest.approx(b, rel=1e-12)


def test_collectives_without_blocks_return_their_input():
    """Without a context, or on a mapping of sizes, the hints and the
    tensor-parallel entry and exit change nothing."""
    x = torch.randn(2, 4, 8)
    assert mesh_ctx.constrain(x, "data", None, "model", src=("data",)) is x
    assert mesh_ctx.constrain_batch(x) is x and mesh_ctx.tp_input(x) is x
    ctx = launch_mesh.make_ctx({"data": 2, "model": 2}, seq_shard_activations=True)
    with mesh_ctx.mesh_context(dataclasses.replace(ctx, local_blocks=True)):
        assert mesh_ctx.blocks_ctx() is None        # a mapping runs no collective
        assert mesh_ctx.constrain_batch(x, src=("data",)) is x
        assert mesh_ctx.tp_output(x) is x


# ==========================================================================
# checkpoints, refusals, meshes
# ==========================================================================


def test_sharded_save_restores_sharded_and_in_the_reference(run):
    for out in run["ckpt"]:
        assert bool(out["ckpt/exists"]) and bool(out["ckpt/equal"])
    jcfg = jconfigs.get_smoke("yi-9b").replace(compute_dtype="float32")
    template = jstep.train_state_shapes(jcfg)
    jstate = jckpt.restore(template, str(run["dir"] / "ckpt"))
    assert int(jstate["step"]) == 0
    for k, v in worker.flatten(jax.tree.map(np.asarray, jstate["params"])).items():
        np.testing.assert_array_equal(v, run["inputs"][f"params/yi/{k}"], err_msg=k)


def test_sharded_save_joins_a_piece_at_a_time(run):
    """No rank holds a leaf's global value during a sharded save: the bytes
    it allocates at its peak stay within two pieces (the one being written
    and the next), below the largest leaf's global bytes."""
    for out in run["ckpt"]:
        peak, leaf = int(out["ckpt/peak_bytes"]), int(out["ckpt/leaf_bytes"])
        assert 0 < peak <= 2 * worker.SAVE_PIECE_BYTES < leaf, (peak, leaf)


@pytest.mark.parametrize("case,what", [("phi", "of 8 patches and 62 tokens (70)"),
                                       ("m4t", "the frames (6)")], ids=["phi", "m4t"])
def test_seq_shard_refuses_a_sequence_the_model_axis_does_not_divide(run, case, what):
    """Under ``seq_shard_activations`` on (2, 4) the block boundary cuts the
    VLM's whole sequence, its patches and tokens (8 + 62 = 70), and the
    enc-dec encoder's frames (6): each raises ``ValueError`` before any
    collective, on every rank."""
    for out in run["refuse"]:
        msg = str(out[f"refuse/seq/{case}"])
        assert msg.startswith("ValueError") and what in msg, msg


def _block(n, model):
    """A rank's share of a dim the rule table splits over a model axis of
    ``model``: the block where the axis divides it, else the whole (its
    guard)."""
    return n // model if n % model == 0 else n


def _rank_heads(cfg, model):
    """(q heads, kv heads) of a rank's flash call on a model axis of
    ``model``: the q heads' block where the axis divides ``n_heads``, else
    all of them; the kv heads' block where it divides ``n_kv_heads``, else
    those the rank's q heads read (``_local_kv``: a whole GQA group of
    them), or all of them."""
    g = cfg.n_heads // cfg.n_kv_heads
    hl = _block(cfg.n_heads, model)
    if cfg.n_kv_heads % model == 0:
        return hl, cfg.n_kv_heads // model
    return hl, (hl // g if hl % g == 0 else 1)


@pytest.mark.parametrize("model", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_full_multimodal_configs_shard_into_the_kernels_domains(arch, model):
    """The sharded step admits each full multimodal config on the (2, model)
    meshes at the training length 2048 (phi-3-vision-4.2b: 576 patches and
    1472 tokens; seamless-m4t-medium: 2048 tokens and 256 frames), with
    ``seq_shard_activations`` where the model axis cuts those sequences (2,
    4, 8) and without it where it does not (3, 6: refused with it, a
    ``ValueError``); a rank's flash call (its q heads and their kv heads,
    MHA, bf16: the model axis's block, or every head where the guard leaves
    the attention whole) takes the wgmma variant at the config's hd (96,
    64).  The smoke configs' hd 16 cannot show a gap here."""
    cfg = tconfigs.get(arch)
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    seqs = dict(seq_len=2048 - cfg.n_patches,
                patches=meta(1, cfg.n_patches, 1024) if cfg.n_patches else None,
                frames=meta(1, 2048 // 8, 1024) if cfg.enc_dec else None)
    cut = 2048 % model == 0 and (2048 // 8) % model == 0
    ctx = launch_mesh.make_ctx({"data": 2, "model": model}, seq_shard_activations=cut)
    tlm.check_sharded(cfg, ctx, **seqs)
    if not cut:
        with pytest.raises(ValueError, match="seq_shard_activations"):
            tlm.check_sharded(cfg, dataclasses.replace(ctx, seq_shard_activations=True), **seqs)
    want = {"phi-3-vision-4.2b": (32128, 96), "seamless-m4t-medium": (256256, 64)}[arch]
    assert (cfg.padded_vocab, cfg.hd) == want
    hl, kv = _rank_heads(cfg, model)
    assert hl == kv and hl in (cfg.n_heads, cfg.n_heads // model)
    assert cfg.n_heads == cfg.n_kv_heads and fa.variant(cfg.hd, torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("model", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_full_recurrent_configs_shard_into_the_scan_kernels_domains(arch, model):
    """The sharded step admits each full recurrent config on the (2, model)
    meshes, and a rank's scans lie in the card's domains, at the rank's
    block or, where the model axis does not divide the dim (3, 6), the
    whole: the SSM's heads and inner width alike, the mma forward and
    backward take P, N and the chunk in bf16, the backward's pair passes
    group 8 of the rank's heads (its 4 at a model axis of 8); the RG-LRU's width is the vec4 variant's
    and tiles at the training and serving lengths.  The smoke configs
    cannot show a gap here: they are narrower than every domain's edge."""
    cfg = tconfigs.get(arch)
    ctx = launch_mesh.make_ctx({"data": 2, "model": model})
    tlm.check_sharded(cfg, ctx, seq_len=2048)
    if cfg.ssm is not None:
        di, nh, p, n = tssm.dims(cfg)
        hl, q = _block(nh, model), cfg.ssm.chunk
        assert _block(di, model) == hl * p
        assert ssd.variant(p, n, q, torch.bfloat16) == "mma"
        assert ssd.bwd_variant(p, n, q, torch.bfloat16) == "mma"
        assert ssd.bwd_heads_per_block(hl) == min(hl, ssd.BWD_HEADS_PER_BLOCK)
        assert ssd.check_chunk(2048, q) == q
    if cfg.rglru is not None:
        wl = _block(trglru.width(cfg), model)
        assert rg.variant(wl) == "vec4"
        for l in (2048, 4096):
            rg.check_tiles(l, wl, trglru.SCAN_BLOCK, trglru.SCAN_BLOCK)


@pytest.mark.parametrize("model", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_full_moe_configs_shard_into_the_kernels_domains(arch, model):
    """The sharded step admits each full MoE config on the (2, model)
    meshes.  Where the model axis divides the experts (2, 4, 8) they are
    expert parallel, and a rank's capacity on its 1 × 2048 tokens at the
    configs' capacity factor is ⌈2048·k·1.25/E⌉ (deepseek-moe-16b 240,
    dbrx-132b 640); where it does not (3, 6) every rank runs the global
    dispatch on all 2 × 2048 tokens, at a capacity of a multiple of 128.
    The shared experts' width is the model axis's block or whole.  A rank's
    flash call (its q heads, hd 128, bf16) takes the wgmma variant with a
    whole GQA group of kv heads."""
    cfg = tconfigs.get(arch)
    m = cfg.moe
    ctx = launch_mesh.make_ctx({"data": 2, "model": model})
    tlm.check_sharded(cfg, ctx, seq_len=2048)
    if m.num_experts % model == 0:
        assert tmoe.ep_capacity(1 * 2048, cfg) == {"deepseek-moe-16b": 240,
                                                  "dbrx-132b": 640}[arch]
    else:
        assert tmoe.capacity(2 * 2048, cfg) % 128 == 0
    if m.num_shared:
        assert _block(tmoe.shared_width(cfg), model) in (tmoe.shared_width(cfg),
                                                          tmoe.shared_width(cfg) // model)
    hl, kv = _rank_heads(cfg, model)
    assert hl in (cfg.n_heads, cfg.n_heads // model) and hl % kv == 0
    assert cfg.hd == 128 and fa.variant(cfg.hd, torch.bfloat16) == "wgmma"


def _moe_dropped(inputs, case):
    """Assignments that the MoE layers of ``case``'s first step drop on its
    mesh (``parallel.ref.dropped`` on each layer's input, from the port's
    plain forward on the same weights and batch)."""
    cfg = worker.case_config(case)
    _, (shape, axes), _, _, _, knobs = worker.CASES[case]
    ctx = launch_mesh.make_ctx(dict(zip(axes, shape)), **knobs)
    params = to_torch(worker.unflatten(inputs, f"params/{case}"), device="cpu")
    batch = {k: torch.from_numpy(inputs[f"batch/{case}/0/{k}"])
             for k in ("tokens", "labels", "mask")}
    calls, apply = [], tmoe.apply

    def recorded(p, c, x):
        calls.append((p, x))
        return apply(p, c, x)

    with torch.no_grad(), mock.patch.object(tmoe, "apply", recorded):
        tlm.loss_fn(params, cfg, batch)
    assert len(calls) == cfg.n_layers
    return sum(pref.dropped(p, cfg, x, ctx.shape, batch_axes=ctx.batch_axes) for p, x in calls)


@pytest.mark.parametrize("case", worker.MOE_CASES)
def test_moe_cases_drop_assignments(run, case):
    """At the configs' capacity factor 1.25 the ranks of every MoE case drop
    assignments past an expert's capacity in the first step (some 90–170 of
    the 1024 a layer), so the trash row's zero gradient is held with the
    rest."""
    assert _moe_dropped(run["inputs"], case) > 0


def test_production_mesh_needs_its_ranks(run):
    for out in run["refuse"]:
        assert "256 ranks" in str(out["refuse/production"])


@pytest.mark.parametrize("fsdp_over_pod", [False, True])
def test_make_ctx_fsdp_over_pod(fsdp_over_pod):
    """The reference's rule: FSDP over the batch axes when asked and a
    ``pod`` axis exists, else over ``data``."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    ctx = launch_mesh.make_ctx(sizes, fsdp_over_pod=fsdp_over_pod)
    assert ctx.batch_axes == ("pod", "data")
    assert ctx.fsdp_axes == (("pod", "data") if fsdp_over_pod else ("data",))
    two = launch_mesh.make_ctx({"data": 2, "model": 2}, fsdp_over_pod=fsdp_over_pod)
    assert two.fsdp_axes == ("data",)
