"""The port's prefill and decode on sharded parameters, on gloo process
groups of CPU ranks, against the JAX package's jitted sharded prefill and
decode on 8 virtual devices:

    jax.jit(make_prefill_step(cfg, max_len),
            in_shardings=(param_shardings(params), input_shardings(inputs)),
            out_shardings=(cache_shardings(cache), logits over (batch, model)))
    jax.jit(make_decode_step(cfg),
            in_shardings=(param_shardings, input_shardings(token), cache_shardings),
            out_shardings=(logits over (batch, model), cache_shardings))

on the same converted weights and prompts, for every fp32 case of
``torch_mesh_serve_worker.CASES`` (smoke configs, B 8, prompt 32, rings of
40 slots, a prefill and 3 greedy decode steps): yi-9b on (2, 4) (the
ring's head_dim over the model axis), with ``shard_kv_seq`` (its slots)
and with ``seq_shard_activations``, gemma2-27b on (2, 2, 2) with FSDP over
("pod", "data") (its kv heads; local windows, softcaps), phi-3-vision-4.2b
on (2, 4) with its 8 patches, deepseek-moe-16b on (2, 4) (expert parallel)
and dbrx-132b on (1, 8) (its 4 experts over a model axis of 8: the global
dispatch).  Held at the reference tests' 1e-4: the logits of every step,
every rank's block of every cache leaf against the reference's global
array cut by the rank's placement (the placement itself equal to the
reference's), and the greedy tokens, equal.  Also: a bf16 case against
the port's own single-process steps, the fp32 ones likewise, each rank's
cache bytes against the rule table's share, and the head_dim layout's
decode moving scores between ranks, not the ring.  The full configs'
sharded prefills against the flash kernel's domain.

The ranks run in ``tests/torch_mesh_serve_worker.py`` (a subprocess with a
timeout), the reference in two subprocesses with 8 host devices; all start
together.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
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
from repro_torch.parallel.sharding import param_shardings  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mesh_serve_worker as worker  # noqa: E402

torch.set_num_threads(2)

SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 300
TOL = 1e-4           # the reference's serving tests, fp32
BF16_TOL = 3e-2
FP32_CASES = [c for c in worker.CASES if c not in worker.BF16_CASES]

_JAX_SERVE = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
sys.path.insert(0, sys.argv[2])
import torch_mesh_serve_worker as w
from repro import configs
from repro.launch.mesh import make_ctx, make_mesh
from repro.parallel.mesh_ctx import mesh_context
from repro.parallel.sharding import cache_shardings, input_shardings, param_shardings, safe_spec
from repro.serve.engine import make_decode_step, make_prefill_step
d, names = sys.argv[1], sys.argv[3].split(",")
inp = dict(np.load(d + "/inputs.npz"))
out = {}


def flat(tree):
    return {k: v for k, v in w.flatten(tree).items() if k != "pos"}


for name in names:
    arch, (shape, axes), over, knobs = w.ALL_CASES[name]
    cfg = w.configure(configs.get_smoke(arch), {**w.FP32_OVERRIDES, **over})
    params = jax.tree.map(jnp.asarray, w.unflatten(inp, "params/" + name))
    inputs = {k: jnp.asarray(v) for k, v in w.inputs_np(inp, name).items()}
    mesh = make_mesh(shape, axes)
    ctx = make_ctx(mesh, **knobs)
    with mesh_context(ctx):
        p_sh = param_shardings(params, ctx)
        fn = make_prefill_step(cfg, max_len=w.MAX_LEN)
        cache_sds, logits_sds = jax.eval_shape(fn, params, inputs)
        c_sh = cache_shardings(cache_sds, ctx)
        l_sh = NamedSharding(mesh, safe_spec(logits_sds.shape,
                                             [tuple(ctx.batch_axes), ctx.model_axis], mesh))
        prefill = jax.jit(fn, in_shardings=(p_sh, input_shardings(ctx, inputs)),
                          out_shardings=(c_sh, l_sh))
        tok_sds = jax.ShapeDtypeStruct((w.BATCH, 1), jnp.int32)
        decode = jax.jit(make_decode_step(cfg),
                         in_shardings=(p_sh, input_shardings(ctx, tok_sds), c_sh),
                         out_shardings=(l_sh, c_sh))
        cache, logits = prefill(params, inputs)
        for k, v in flat(cache).items():
            out[f"{name}/prefill/{k}"] = np.asarray(v)
        logits_all, toks = [logits], [jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)]
        for _ in range(w.DECODE):
            logits, cache = decode(params, toks[-1], cache)
            logits_all.append(logits)
            toks.append(jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32))
    out[f"{name}/logits"] = np.stack([np.asarray(x) for x in logits_all])
    out[f"{name}/tokens"] = np.concatenate([np.asarray(t) for t in toks], axis=1)
    out[f"{name}/logits_spec"] = np.array(repr(w.spec_axes_list(l_sh.spec, 2)))
    out[f"{name}/pos"] = np.asarray(cache["pos"])
    for k, v in flat(cache).items():
        out[f"{name}/decode/{k}"] = np.asarray(v)
    for k, s in flat(c_sh).items():
        ndim = out[f"{name}/decode/{k}"].ndim
        out[f"{name}/spec/{k}"] = np.array(repr(w.spec_axes_list(s.spec, ndim)))
np.savez(f"{d}/jax_serve-{names[0]}.npz", **out)
print("JAX_SERVE_OK")
"""


def _inputs(d, cases, seed):
    """Each case's parameters from the reference's ``lm.init`` and its
    prompt (a VLM's patches [B, n_patches, 1024], an enc-dec config's
    frames [B, FRAMES, 1024]), from a seed, the i-th case's ``seed + i``."""
    inputs = {}
    for i, name in enumerate(cases):
        arch, _, over, _ = worker.ALL_CASES[name]
        jcfg = worker.configure(jconfigs.get_smoke(arch), {**worker.FP32_OVERRIDES, **over})
        params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(seed + i), jcfg))
        inputs.update({f"params/{name}/{k}": v for k, v in worker.flatten(params).items()})
        rng = np.random.default_rng(seed + i)
        inputs[f"inputs/{name}/tokens"] = rng.integers(
            0, jcfg.vocab, (worker.BATCH, worker.PROMPT)).astype(np.int32)
        if jcfg.n_patches:
            inputs[f"inputs/{name}/patches"] = rng.standard_normal(
                (worker.BATCH, jcfg.n_patches, 1024)).astype(np.float32)
        if jcfg.enc_dec:
            inputs[f"inputs/{name}/frames"] = rng.standard_normal(
                (worker.BATCH, worker.FRAMES, 1024)).astype(np.float32)
    np.savez(d / "inputs.npz", **inputs)
    return inputs


def single_process(inputs, name, tokens):
    """The port's plain prefill and decode in this process on the same
    weights and prompt, each decode step fed ``tokens`` (the ranks' greedy
    tokens): the logits of every step."""
    cfg = worker.case_config(name)
    params = to_torch(worker.unflatten(inputs, f"params/{name}"), device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in worker.inputs_np(inputs, name).items()}
    with torch.inference_mode():
        cache, logits = tlm.prefill(params, cfg, inp["tokens"], max_len=worker.MAX_LEN,
                                    patches=inp.get("patches"), frames=inp.get("frames"))
        out = [logits]
        for s in range(worker.DECODE):
            logits, cache = tlm.decode_step(params, cfg,
                                            torch.from_numpy(tokens[:, s:s + 1]), cache)
            out.append(logits)
    return np.stack([x.float().numpy() for x in out])


def serve_run(d, cases, seed, world=8):
    """The ranks' ``serve`` task on ``cases`` beside the reference's jitted
    sharded steps on their fp32 cases (two processes of ``world`` host
    devices), all started together, in directory ``d``: the inputs, the
    reference's record and each of the ``world`` ranks'."""
    inputs = _inputs(d, cases, seed)
    fp32 = [c for c in cases if c not in worker.BF16_CASES]
    parts = [fp32[i::2] for i in range(2)]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jax_env = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={world}",
                   JAX_PLATFORMS="cpu")

    def start(args, env):
        return subprocess.Popen([sys.executable, *args], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = [start(["-c", textwrap.dedent(_JAX_SERVE), str(d), HERE, ",".join(part)], jax_env)
             for part in parts]
    procs.append(start([os.path.join(HERE, "torch_mesh_serve_worker.py"), str(d), str(world),
                        "serve", ",".join(cases)], env))
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
    jax_out = {}
    for part in parts:
        jax_out.update(np.load(d / f"jax_serve-{part[0]}.npz"))
    ranks = [dict(np.load(d / f"serve-rank{r}.npz")) for r in range(world)]
    return {"inputs": inputs, "jax": jax_out, "ranks": ranks}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return serve_run(tmp_path_factory.mktemp("mesh_serve"), list(worker.CASES), 20)


def _leaves(out, case, key):
    """The cache leaves' paths of ``case`` in a rank's record."""
    pre = f"{case}/{key}/block/"
    return sorted(k[len(pre):] for k in out if k.startswith(pre))


# ==========================================================================
# against the reference's jitted sharded prefill and decode
# ==========================================================================


def check_logits_and_tokens(run, case):
    """The logits of the prefill and of every decode step within 1e-4, the
    greedy tokens equal, on every rank; the logits placed as the
    reference's out_shardings."""
    want = run["jax"]
    for r, out in enumerate(run["ranks"]):
        np.testing.assert_allclose(out[f"{case}/logits"], want[f"{case}/logits"], atol=TOL,
                                   rtol=0, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{case}/tokens"], want[f"{case}/tokens"])
        assert str(out[f"{case}/logits_spec"]) == str(want[f"{case}/logits_spec"])


def check_cache_blocks(run, case, key):
    """Every rank's block of every cache leaf, after the prefill and after
    the last decode step, against the reference's global array cut by the
    rank's slices, within 1e-4; each leaf laid out as the reference's
    ``cache_shardings``; ``pos`` as the reference's."""
    want = run["jax"]
    for r, out in enumerate(run["ranks"]):
        leaves = _leaves(out, case, key)
        assert leaves and leaves == sorted(k[len(f"{case}/spec/"):] for k in want
                                           if k.startswith(f"{case}/spec/"))
        for path in leaves:
            assert str(out[f"{case}/{key}/spec/{path}"]) == str(want[f"{case}/spec/{path}"]), \
                (r, path)
            cut = tuple(slice(a, b) for a, b in out[f"{case}/{key}/slices/{path}"])
            np.testing.assert_allclose(out[f"{case}/{key}/block/{path}"],
                                       want[f"{case}/{key}/{path}"][cut], atol=TOL, rtol=0,
                                       err_msg=f"rank {r} {path}")
    pos = worker.PROMPT + tconfigs.get_smoke(worker.ALL_CASES[case][0]).n_patches
    assert int(run["ranks"][0][f"{case}/prefill/pos"]) == pos
    assert int(run["ranks"][0][f"{case}/decode/pos"]) == int(want[f"{case}/pos"]) == \
        pos + worker.DECODE


def check_cache_bytes(run, case, ref):
    """A rank's cache bytes: each leaf's global bytes over the sizes of the
    axes its spec shards it on (the reference's layout; the global shapes
    of the fp32 case ``ref``, a bf16 case's compute-dtype leaves at 2
    bytes)."""
    _, (shape, axes), _, _ = worker.ALL_CASES[case]
    sizes = dict(zip(axes, shape))
    out0 = run["ranks"][0]
    bf16 = case in worker.BF16_CASES
    want = 0
    for path in _leaves(out0, case, "decode"):
        n = 1
        for axes_of_dim in ast.literal_eval(str(out0[f"{case}/decode/spec/{path}"])):
            for a in axes_of_dim:
                n *= sizes[a]
        itemsize = 2 if bf16 and path.split("/")[-1] != "h" else 4
        want += run["jax"][f"{ref}/decode/{path}"].size * itemsize // n
    assert want > 0
    for out in run["ranks"]:
        assert int(out[f"{case}/cache_bytes"]) == want


def check_single_process(run, case):
    """The ranks' logits against the port's own plain prefill and decode
    on the same weights and tokens, within 1e-4."""
    out = run["ranks"][0]
    got = single_process(run["inputs"], case, out[f"{case}/tokens"])
    np.testing.assert_allclose(out[f"{case}/logits"], got, atol=TOL, rtol=0)


def check_bf16_single_process(run, case):
    """Every step's logits of a bf16 case within 3e-2 of their largest
    magnitude of the port's own plain steps fed the same tokens, on every
    rank (the row-parallel products sum bf16 partials over the model axis,
    as the reference's do, where the plain product rounds once: a few bf16
    ulps apart)."""
    for out in run["ranks"]:
        got = single_process(run["inputs"], case, out[f"{case}/tokens"])
        scale = float(np.abs(got).max())
        np.testing.assert_allclose(out[f"{case}/logits"], got, atol=BF16_TOL * scale, rtol=0)


@pytest.mark.parametrize("case", FP32_CASES)
def test_sharded_serving_logits_and_tokens_match_jax(run, case):
    """:func:`check_logits_and_tokens`."""
    check_logits_and_tokens(run, case)


@pytest.mark.parametrize("key", ["prefill", "decode"])
@pytest.mark.parametrize("case", FP32_CASES)
def test_each_ranks_cache_block_matches_jax(run, case, key):
    """:func:`check_cache_blocks`."""
    check_cache_blocks(run, case, key)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_each_rank_holds_the_rule_tables_share_of_the_cache(run, case):
    """:func:`check_cache_bytes` (yi-bf16's global shapes are yi's)."""
    check_cache_bytes(run, case, case if case not in worker.BF16_CASES else "yi")


@pytest.mark.parametrize("case", [c for c in FP32_CASES if c != "ds"])
def test_sharded_serving_matches_single_process(run, case):
    """:func:`check_single_process` (not "ds": its expert-parallel capacity
    is a rank's, and it drops other assignments than the plain layer, as
    the reference's does)."""
    check_single_process(run, case)


def test_sharded_serving_bf16_matches_single_process(run):
    """yi-9b smoke in bf16 compute on (2, 4), the ring's head_dim over the
    model axis: :func:`check_bf16_single_process`."""
    check_bf16_single_process(run, "yi-bf16")


def test_head_dim_decode_moves_scores_not_the_ring(run):
    """yi-9b on (2, 4): the ring's head_dim over the model axis.  In each
    decode step the attention on the ring's blocks makes, per layer, 3
    all-reduces: q's heads gathered, the partial scores [B_loc, Hkv, G, 1,
    S] summed (the largest) and the output's hd blocks gathered; together
    less than the rank's batch block of one layer's k ring whole."""
    cfg = worker.case_config("yi")
    b_loc, slots = worker.BATCH // 2, worker.MAX_LEN
    scores = b_loc * cfg.n_heads * slots * 4
    ring = b_loc * slots * cfg.n_kv_heads * cfg.hd * 4
    for out in run["ranks"]:
        rings = out["yi/ring_collectives"]            # [step, layer, (calls, bytes, largest)]
        assert rings.shape == (worker.DECODE, cfg.n_layers, 3)
        assert (rings[..., 0] == 3).all() and (rings[..., 2] == scores).all()
        assert (rings[..., 1] < ring).all()
        steps = out["yi/decode_collectives"]
        assert (steps[:, 0] > rings[..., 0].sum(axis=1)).all()


# ==========================================================================
# the families admitted, and the full configs
# ==========================================================================


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_check_sharded_admits_every_family_to_serve(arch):
    """Sharded serving admits each of the 10 smoke configs (every family:
    dense, VLM, MoE, the recurrent ones, enc-dec) on a (2, 2) context of
    sizes, as the train step does."""
    tlm.check_sharded(tconfigs.get_smoke(arch), launch_mesh.make_ctx({"data": 2, "model": 2}))


@pytest.mark.parametrize("arch,lru_width,model,leaf", [
    ("mamba2-370m", None, 16, ("blocks", "s0", "ssm", "wdt")),
    ("recurrentgemma-9b", 68, 8, ("blocks", "s0", "rec", "w_x")),
    ("seamless-m4t-medium", None, 3, ("embed",)),
], ids=["ssm-heads", "rglru-width", "vocab"])
def test_check_sharded_admits_what_the_model_axis_does_not_divide(arch, lru_width, model,
                                                                   leaf):
    """A model axis that does not divide a split dim of the recurrent or
    enc-dec families (the SSM's 8 heads, an RG-LRU width of 68, the padded
    vocab 512) is admitted, as the reference's guard admits it: the rule
    table leaves that dim of the named leaf whole, and a rank computes its
    product whole (``test_torch_mesh_undivided.py`` holds such ranks
    against the reference).  (recurrentgemma-9b smoke with an RG-LRU width
    of 68, where the model axis of 8 divides every other split dim.)"""
    cfg = tconfigs.get_smoke(arch)
    if lru_width:
        cfg = cfg.replace(rglru=dataclasses.replace(cfg.rglru, lru_width=lru_width))
    ctx = launch_mesh.make_ctx({"data": 2, "model": model})
    tlm.check_sharded(cfg, ctx)
    node = param_shardings(tlm.init_shapes(cfg), ctx)
    for k in leaf:
        node = node[k]
    assert "model" not in str(node), node
    if arch == "recurrentgemma-9b":              # the rest of the model still splits
        assert param_shardings(tlm.init_shapes(cfg), ctx)["embed"][0] == "model"


#: the full configs that serve sharded: every family
SERVED = ("yi-9b", "mistral-large-123b", "qwen1.5-110b", "gemma2-27b", "phi-3-vision-4.2b",
          "deepseek-moe-16b", "dbrx-132b", "mamba2-370m", "recurrentgemma-9b",
          "seamless-m4t-medium")


def _rank_heads(cfg, model):
    """(q heads, kv heads) of a rank's flash call in the sharded prefill on
    a model axis of ``model``: the model axis's block of the q heads where
    it divides ``n_heads``, else all of them (gathered where it divides
    ``n_heads·hd``, whole where it does not); the kv heads they read (the
    rank's block where the model axis divides ``n_kv_heads``, else those
    ``_local_kv`` picks, or all of them)."""
    g = cfg.n_heads // cfg.n_kv_heads
    hl = cfg.n_heads // model if cfg.n_heads % model == 0 else cfg.n_heads
    if cfg.n_kv_heads % model == 0:
        kv = cfg.n_kv_heads // model
    else:
        kv = hl // g if hl % g == 0 else (1 if g % hl == 0 else hl)
    return hl, kv


@pytest.mark.parametrize("model", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("arch", SERVED)
def test_full_configs_serve_sharded_into_the_flash_domain(arch, model):
    """The sharded prefill admits each full config on the (2, model) meshes,
    and where it has causal self-attention a rank's flash call lies in the
    kernel's domain: its q heads and the kv heads they read
    (:func:`_rank_heads`; every head where the guard leaves the attention
    whole, at a model axis of 3 or 6), so many q heads to a kv head, at an
    instantiated head dim on the wgmma variant in bf16.  The smoke configs'
    hd 8 and 16 cannot show a gap here."""
    cfg = tconfigs.get(arch)
    ctx = launch_mesh.make_ctx({"data": 2, "model": model})
    tlm.check_sharded(cfg, ctx, seq_len=2048)
    if not set(cfg.layer_pattern) & {"attn", "local"}:
        return
    hl, kv = _rank_heads(cfg, model)
    assert hl * model == cfg.n_heads or hl == cfg.n_heads
    assert hl % kv == 0
    assert cfg.hd in fa.HEAD_DIMS and fa.variant(cfg.hd, torch.bfloat16) == "wgmma"
    if cfg.moe is not None:
        assert cfg.moe.num_experts % model == 0 or tmoe.capacity(2048, cfg) % 128 == 0


def _rank_scan_widths(cfg, model):
    """A rank's scan shapes on a model axis of ``model``: (the SSM heads,
    the SSM inner width) or (the RG-LRU width,), each the model axis's
    block where it divides the dim, else whole (the rule table's guard)."""
    def block(n):
        return n // model if n % model == 0 else n
    if cfg.ssm is not None:
        di, nh, _, _ = tssm.dims(cfg)
        return block(nh), block(di)
    return (block(trglru.width(cfg)),)


@pytest.mark.parametrize("model", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_full_recurrent_configs_serve_sharded_into_the_scan_domains(arch, model):
    """A rank's scans in the sharded prefill of each full recurrent config
    on the (2, model) meshes lie in the card's fast variants, at the rank's
    block or, where the model axis does not divide the dim (3, 6), the
    whole: the SSD scan on the rank's heads takes the mma variant at P, N
    and the chunk in bf16 and tiles the serving lengths; the RG-LRU scan's
    width is the vec4 variant's and tiles them too."""
    cfg = tconfigs.get(arch)
    tlm.check_sharded(cfg, launch_mesh.make_ctx({"data": 2, "model": model}), seq_len=512)
    if cfg.ssm is not None:
        di, nh, p, n = tssm.dims(cfg)
        hl, dl = _rank_scan_widths(cfg, model)
        q = cfg.ssm.chunk
        assert dl == hl * p and (hl * model == nh or hl == nh)
        assert ssd.variant(p, n, q, torch.bfloat16) == "mma"
        for l in (512, 2048):
            assert ssd.check_chunk(l, q) == q
    if cfg.rglru is not None:
        (wl,) = _rank_scan_widths(cfg, model)
        assert (wl * model == trglru.width(cfg) or wl == trglru.width(cfg))
        assert rg.variant(wl) == "vec4"
        for l in (512, 2048):
            rg.check_tiles(l, wl, trglru.SCAN_BLOCK, trglru.SCAN_BLOCK)
