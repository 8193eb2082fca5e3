"""Port model stack against the JAX package: configs, primitives, attention,
and whole-LM prefill/decode logits on the same converted weights."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.models import attention, common, lm  # noqa: E402

torch.set_num_threads(2)

L, B = 24, 2
DENSE = ["yi-9b", "gemma2-27b", "qwen1.5-110b", "mistral-large-123b"]
NOT_PORTED = ["mamba2-370m", "deepseek-moe-16b", "dbrx-132b", "recurrentgemma-9b",
              "phi-3-vision-4.2b", "seamless-m4t-medium"]
# fp32 compute differs from JAX only in summation order; bf16 at the
# reference's own prefill/decode tolerance (tests/test_models.py)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _jax_mode(dtype):
    """How the JAX side runs.  The port rounds bf16 after every op, as JAX
    does op by op; XLA's fusion of the jitted layer scan drops some of those
    roundings, and at the yi-9b smoke config jitted and eager JAX differ by
    up to 0.047 on bf16 logits (13 elements past 3e-2).  So bf16 is held
    against JAX evaluated op by op; fp32 against the jitted functions."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _perturbed_params(cfg, seed):
    """JAX init, with the zero-initialised norms/biases made nonzero so the
    (1 + scale) and bias paths are exercised; returns (jax tree, numpy tree)."""
    rng = np.random.default_rng(seed)
    tree = _np_tree(jlm.init(jax.random.PRNGKey(seed), cfg))

    def bump(a):
        return a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype) if not a.any() else a
    tree = jax.tree.map(bump, tree)
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_config_fields_and_param_count(arch):
    for getter in ("get", "get_smoke"):
        mine, theirs = getattr(configs, getter)(arch), getattr(jconfigs, getter)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.hd == theirs.hd and mine.padded_vocab == theirs.padded_vocab
        for active in (False, True):
            assert mine.param_count(active) == theirs.param_count(active)
    assert configs.get(arch).cdtype == torch.bfloat16


def test_registry_cells_and_skip_reasons():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.all_cells() == jconfigs.all_cells()
    for arch, shape in jconfigs.all_cells():
        assert configs.skip_reason(arch, shape) == jconfigs.skip_reason(arch, shape)
        assert configs.runnable(arch, shape) == jconfigs.runnable(arch, shape)


def test_norm_rope_softcap_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        atol=1e-6, rtol=1e-6)
    pos = np.arange(5)[None].repeat(2, 0)
    c, s = common.rope_angles(torch.from_numpy(pos), 16, 10_000.0)
    jc, js = jcommon.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), c, s).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(common.softcap(torch.from_numpy(x) * 40, 30.0).numpy(),
                               np.asarray(jcommon.softcap(jnp.asarray(x) * 40, 30.0)),
                               atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("arch,window", [("yi-9b", 0), ("gemma2-27b", 16),
                                         ("qwen1.5-110b", 0)])
def test_attention_apply_with_kv_and_decode(arch, window):
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    jcfg = jconfigs.get_smoke(arch).replace(compute_dtype="float32")
    rng = np.random.default_rng(1)
    p_np = _np_tree(jattention.init(jax.random.PRNGKey(1), jcfg))
    if cfg.qkv_bias:
        p_np = {k: (v + rng.standard_normal(v.shape).astype(np.float32)
                    if k.startswith("b") else v) for k, v in p_np.items()}
    p_j, p_t = jax.tree.map(jnp.asarray, p_np), to_torch(p_np, device="cpu")
    x = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    pos = np.arange(L)[None].repeat(B, 0)

    out_j, (k_j, v_j) = jattention.apply_with_kv(p_j, jcfg, jnp.asarray(x),
                                                 jnp.asarray(pos), window=window)
    out_t, (k_t, v_t) = attention.apply_with_kv(p_t, cfg, torch.from_numpy(x),
                                                torch.from_numpy(pos), window=window)
    for a, b in ((out_t, out_j), (k_t, k_j), (v_t, v_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    out_a = attention.apply(p_t, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                            window=window)
    np.testing.assert_allclose(out_a.numpy(), out_t.numpy(), atol=0, rtol=0)

    # decode one token at position 19 against a ring of random history
    empty = attention.init_cache(cfg, B, 32, window=window, device="cpu")
    empty_j = jattention.init_cache(jcfg, B, 32, window=window)
    assert empty["k"].shape == empty_j["k"].shape and not empty["v"].any()
    slots = min(window, 32) if window else 32
    cache_np = {n: rng.standard_normal((B, slots, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
                for n in ("k", "v")}
    xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    dj, cj = jattention.decode_step(p_j, jcfg, jnp.asarray(xd),
                                    jax.tree.map(jnp.asarray, cache_np),
                                    jnp.asarray(19, jnp.int32), window=window)
    dt, ct = attention.decode_step(p_t, cfg, torch.from_numpy(xd),
                                   to_torch(cache_np, device="cpu"), 19, window=window)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5, rtol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(ct[n].numpy(), np.asarray(cj[n]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_prefill_decode_match_jax(arch, dtype):
    cfg = configs.get_smoke(arch).replace(compute_dtype=dtype)
    jcfg = jconfigs.get_smoke(arch).replace(compute_dtype=dtype)
    p_j, p_np = _perturbed_params(jcfg, seed=2)
    p_t = to_torch(p_np, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, L)).astype(np.int32)
    tol = TOL[dtype]

    with _jax_mode(dtype):
        logits_j, _ = jlm.forward(p_j, jcfg, jnp.asarray(toks))
        cache_j, pre_j = jlm.prefill(p_j, jcfg, jnp.asarray(toks[:, :-1]), max_len=L + 4)
        dec_j, _ = jlm.decode_step(p_j, jcfg, jnp.asarray(toks[:, -1:]), cache_j)
    logits_t, aux = lm.forward(p_t, cfg, torch.from_numpy(toks))
    assert logits_t.shape == (B, L, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j, np.float32),
                               atol=tol, rtol=tol)

    cache_t, pre_t = lm.prefill(p_t, cfg, torch.from_numpy(toks[:, :-1]), max_len=L + 4)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j, np.float32),
                               atol=tol, rtol=tol)
    for name, c in cache_t["blocks"].items():
        np.testing.assert_allclose(c["k"].float().numpy(),
                                   np.asarray(cache_j["blocks"][name]["k"], np.float32),
                                   atol=tol, rtol=tol)
    assert cache_t["pos"] == int(cache_j["pos"]) == L - 1

    dec_t, cache_t = lm.decode_step(p_t, cfg, torch.from_numpy(toks[:, -1:]), cache_t)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j, np.float32),
                               atol=tol, rtol=tol)
    assert cache_t["pos"] == L


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-27b"])
def test_init_tree_layout_matches_jax(arch):
    cfg = configs.get_smoke(arch)
    mine = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    theirs = jlm.init(jax.random.PRNGKey(0), jconfigs.get_smoke(arch))
    flat_m = {jax.tree_util.keystr(p): tuple(v.shape)
              for p, v in jax.tree_util.tree_leaves_with_path(mine)}
    flat_t = {jax.tree_util.keystr(p): tuple(v.shape)
              for p, v in jax.tree_util.tree_leaves_with_path(theirs)}
    assert flat_m == flat_t
    cache_m = lm.init_cache(cfg, 2, 40, device="cpu")
    cache_t = jlm.init_cache(jconfigs.get_smoke(arch), 2, 40)
    assert cache_m["pos"] == int(cache_t["pos"])
    assert ({k: tuple(v["k"].shape) for k, v in cache_m["blocks"].items()}
            == {k: tuple(v["k"].shape) for k, v in cache_t["blocks"].items()})


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="not ported"):
        lm.init(torch.Generator().manual_seed(0), configs.get_smoke(arch), device="cpu")


def test_convert_round_trip_keeps_bf16_through_fp32():
    tree = jlm.init(jax.random.PRNGKey(0),
                    jconfigs.get_smoke("yi-9b").replace(param_dtype="bfloat16"))
    t = to_torch(jax.tree.map(np.asarray, tree), device="cpu")
    assert t["embed"].dtype == torch.bfloat16
    back = to_numpy(t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b.astype(jnp.float32)))
