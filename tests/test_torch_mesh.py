"""The port's distributed branches on a gloo process group of 8 CPU ranks,
a (2, 4) ``("data", "model")`` mesh, against the JAX package's on 8
virtual devices: the claims of ``tests/test_sharding_mesh.py``.

* expert-parallel MoE: the port's ``moe.apply`` under a mesh context
  (``apply_ep``) against the reference's ``apply_ep`` (shard_map) on the
  same converted parameters and inputs, fp32 within 1e-5 and bf16 within
  the reference test's 3e-2, with cases where tokens drop; the one-process
  emulation ``parallel.ref.apply_ep_emulated`` against both; where nothing
  drops (``parallel.ref.no_drop``), ``apply_ref`` against the ranks too;
  under a gradient the ranks refuse to run;
* sequence-sharded decode (the twin of
  ``test_flash_decoding_seqshard_matches_plain``): greedy decode with the
  KV rings placed as DTensors over the model axis against the plain decode,
  bf16 logits within 1e-1 with equal argmax, fp32 logits within 1e-4 with
  equal greedy tokens, and each rank's ring blocks equal to the plain
  ring's;
* elastic restore: a checkpoint saved in one process restores onto the
  mesh, each rank's block of ``wq`` equal to its slice of the saved value.

The ranks run in ``tests/torch_mesh_worker.py`` (one subprocess with a
timeout, so a hung collective fails these tests and not the suite), the
reference in a subprocess with 8 host devices; both start together.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import ref as pref  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import train_state_init  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
N_DATA, N_MODEL = 2, 4
SIZES = {"data": N_DATA, "model": N_MODEL}
CASES = ["float32-random", "bfloat16-random", "float32-drop", "bfloat16-drop",
         "float32-nodrop", "bfloat16-nodrop"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TIMEOUT = 300

_JAX_EP = """
import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.models import moe
from repro.parallel.mesh_ctx import MeshCtx, mesh_context
from repro.launch.mesh import make_mesh
d = sys.argv[1]
inp = dict(np.load(d + "/inputs.npz"))
p = {k[2:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("p/")}
p["shared"] = {k[7:]: p.pop(k) for k in list(p) if k.startswith("shared/")}
ctx = MeshCtx(make_mesh((2, 4), ("data", "model")), batch_axes=("data",))
out = {}
for case in str(inp["cases"]).split(","):
    dtype = case.split("-")[0]
    cfg = configs.get_smoke("deepseek-moe-16b").replace(compute_dtype=dtype)
    if case.endswith("nodrop"):
        m = cfg.moe
        cfg = cfg.replace(moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    x = jnp.asarray(inp["x/" + case]).astype(getattr(jnp, dtype))
    with mesh_context(ctx):
        y = jax.jit(lambda p, x: moe.apply(p, cfg, x))(p, x)
    out[case] = np.asarray(y.astype(jnp.float32))
np.savez(d + "/jax_ep.npz", **out)
print("JAX_EP_OK")
"""


def _x(case, d_model):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 16, d_model)).astype(np.float32)
    if case.endswith("-drop"):
        # 12 of each sequence's 16 tokens are one vector: their top-k experts
        # get 24 of the 32 local tokens' assignments against a capacity of 16
        x[:, :12] = x[0, 0]
    return x


def _round(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    jcfg = jconfigs.get_smoke("deepseek-moe-16b")
    p_np = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jmoe.init(jax.random.PRNGKey(0), jcfg))
    inputs = {f"p/{k}": v for k, v in p_np.items() if k != "shared"}
    inputs.update({f"p/shared/{k}": v for k, v in p_np["shared"].items()})
    inputs["cases"] = np.array(",".join(CASES))
    for case in CASES:
        x = _x(case, jcfg.d_model)
        inputs[f"x/{case}"] = _round(x, case.split("-")[0]).float().numpy()
    ycfg = configs.get_smoke("yi-9b")
    inputs["toks"] = np.random.default_rng(0).integers(0, ycfg.vocab, (2, 17)).astype(np.int64)
    np.savez(d / "inputs.npz", **inputs)
    state = train_state_init(torch.Generator().manual_seed(0), ycfg, device="cpu")
    ckpt.save(state, str(d / "ckpt"), 3)

    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_EP), str(d)],
                              env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True),
             subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
                               str(d), str(N_DATA), str(N_MODEL), "cpu",
                               "ep,decode,restore,grad"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    logs = []
    for proc in procs:
        try:
            o, e = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{proc.args[:2]} did not finish in {TIMEOUT} s")
        logs.append((proc.returncode, o[-2000:] + e[-4000:]))
    for rc, log in logs:
        assert rc == 0, log
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(N_DATA * N_MODEL)]
    return {"jax_ep": dict(np.load(d / "jax_ep.npz")), "ranks": ranks, "inputs": inputs,
            "wq": state["params"]["blocks"]["s0"]["attn"]["wq"].numpy()}


def _moe_params(inputs, case):
    dtype = case.split("-")[0]
    cfg = configs.get_smoke("deepseek-moe-16b").replace(compute_dtype=dtype)
    if case.endswith("nodrop"):
        cfg = pref.no_drop(cfg)
    p = {k[2:]: v for k, v in inputs.items() if k.startswith("p/") and "shared" not in k}
    p["shared"] = {k[9:]: v for k, v in inputs.items() if k.startswith("p/shared/")}
    return cfg, to_torch(p, device="cpu")


# ==========================================================================
# expert-parallel MoE
# ==========================================================================


@pytest.mark.parametrize("case", CASES)
def test_apply_ep_on_gloo_ranks_matches_jax_apply_ep(run, case):
    """Every rank returns the global output, equal to the reference's
    shard_map ``apply_ep`` on a (2, 4) mesh."""
    tol = TOL[case.split("-")[0]]
    want = run["jax_ep"][case]
    for r, out in enumerate(run["ranks"]):
        np.testing.assert_allclose(out[f"ep/{case}"], want, atol=tol, rtol=tol,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES)
def test_apply_ep_emulated_matches_jax_apply_ep(run, case):
    """The one-process emulation (the card's oracle) against the reference,
    and against the ranks: the ranks sum the same partials, only in
    another order."""
    dtype = case.split("-")[0]
    cfg, p = _moe_params(run["inputs"], case)
    x = _round(run["inputs"][f"x/{case}"], dtype)
    got = pref.apply_ep_emulated(p, cfg, x, SIZES).float().numpy()
    np.testing.assert_allclose(got, run["jax_ep"][case], atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(run["ranks"][0][f"ep/{case}"], got, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("case", ["float32-drop", "bfloat16-drop"])
def test_drop_cases_drop_and_differ_from_apply_ref(run, case):
    """Assignments past the local capacity are dropped, so EP is not
    ``apply_ref`` there (ROADMAP Queue 3 d: which tokens drop depends on
    the path), while the reference's EP agrees with the port's."""
    dtype = case.split("-")[0]
    cfg, p = _moe_params(run["inputs"], case)
    x = _round(run["inputs"][f"x/{case}"], dtype)
    assert pref.dropped(p, cfg, x, SIZES) > 0
    t_loc = x.shape[0] * x.shape[1] // N_DATA
    cap = moe.ep_capacity(t_loc, cfg)
    ids, _ = moe.route(p, cfg, x.reshape(-1, cfg.d_model)[:t_loc])
    assert int(torch.bincount(ids.reshape(-1)).max()) > cap
    assert not np.allclose(moe.apply_ref(p, cfg, x).float().numpy(), run["jax_ep"][case],
                           atol=TOL[dtype])


@pytest.mark.parametrize("case", ["float32-nodrop", "bfloat16-nodrop"])
def test_apply_ep_on_gloo_ranks_matches_apply_ref_without_drops(run, case):
    """An oracle that does not run ``ep_partial``: where no assignment
    drops on either path, every rank's ``apply_ep`` equals ``apply_ref``."""
    dtype = case.split("-")[0]
    cfg, p = _moe_params(run["inputs"], case)
    x = _round(run["inputs"][f"x/{case}"], dtype)
    assert pref.dropped(p, cfg, x) == 0 and pref.dropped(p, cfg, x, SIZES) == 0
    want = moe.apply_ref(p, cfg, x).float().numpy()
    for r, out in enumerate(run["ranks"]):
        np.testing.assert_allclose(out[f"ep/{case}"], want, atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=f"rank {r}")


def test_apply_ep_refuses_a_gradient(run):
    """The all-reduces are not differentiable (the reference's psum is), so
    a loss under the context with parameters that need a gradient raises on
    every rank, before any collective."""
    for out in run["ranks"]:
        assert "do not differentiate" in str(out["grad/refused"])


def test_mesh_groups_are_gloo(run):
    for r, out in enumerate(run["ranks"]):
        assert list(out["backends"]) == ["gloo", "gloo"], r
    assert sorted(tuple(out["coord"]) for out in run["ranks"]) == [
        (d, m) for d in range(N_DATA) for m in range(N_MODEL)]


# ==========================================================================
# sequence-sharded decode
# ==========================================================================


def test_seqshard_decode_takes_the_distributed_branch(run):
    """The sharded cache's decode steps all-reduce (3 a layer a step, plus
    the batch gather); the plain cache's none."""
    for out in run["ranks"]:
        for dtype in ("bfloat16", "float32"):
            plain, seq = out[f"calls/{dtype}"]
            assert plain == 0 and seq > 0


def test_seqshard_decode_matches_plain_bf16(run):
    """The reference test's claim: bf16 logits within 1e-1, argmax equal
    (first step; later steps feed each path its own tokens)."""
    for r, out in enumerate(run["ranks"]):
        plain, seq = out["plain/bfloat16"][0], out["seq/bfloat16"][0]
        assert np.abs(plain - seq).max() < 1e-1, r
        np.testing.assert_array_equal(plain.argmax(-1), seq.argmax(-1))


def test_seqshard_decode_matches_plain_fp32_greedy(run):
    """fp32: every step's logits within 1e-4, so the greedy tokens agree."""
    for r, out in enumerate(run["ranks"]):
        plain, seq = out["plain/float32"], out["seq/float32"]
        np.testing.assert_allclose(seq, plain, atol=1e-4, rtol=1e-4, err_msg=f"rank {r}")
        np.testing.assert_array_equal(seq.argmax(-1), plain.argmax(-1))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_seqshard_ring_blocks_equal_the_plain_ring(run, dtype):
    """Only a row's owner writes it.  Each rank's local block of the first
    layer's rings against its slice of the plain rings: the prefill's rows
    placed exactly, the rows no step wrote still zero, and (fp32, where the
    greedy tokens agree) the decode steps' rows within 1e-4."""
    for out in run["ranks"]:
        prefill, decode, unwritten = out[f"ring_err/{dtype}"]
        assert prefill == 0.0 and unwritten == 0.0
        if dtype == "float32":
            assert decode < 1e-4


# ==========================================================================
# elastic restore
# ==========================================================================


def test_elastic_restore_onto_the_mesh(run):
    wq = run["wq"]
    for r, out in enumerate(run["ranks"]):
        assert bool(out["restore/all_dtensors"])
        sl = tuple(slice(a, b) for a, b in out["wq/slices"])
        assert out["wq/local"].shape != wq.shape          # sharded, not replicated
        np.testing.assert_array_equal(out["wq/local"], wq[sl], err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["wq/full"], wq)
    blocks = {tuple(map(tuple, out["wq/slices"])) for out in run["ranks"]}
    assert len(blocks) == N_DATA * N_MODEL

