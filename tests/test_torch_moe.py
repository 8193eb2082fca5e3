"""The port's Mixture-of-Experts layer and the MoE branches of ``lm`` against
the JAX package, on the same seeded numpy inputs and converted weights:
capacity, routing (ties included), the sort-based dispatch with drops, the
expert FFN, the aux loss, the tree layouts, whole-model prefill and decode,
greedy tokens, and the loss with its gradient.

fp32 is held against the jitted JAX functions at 1e-4, bf16 against JAX run
op by op at 3e-2 (as ``test_torch_models.py``).  In bf16 a rounding
difference upstream can move a token across a near-tie in the router, which
puts a whole expert's output on another token: module tests feed both sides
the same input and require equal expert ids; the whole-model test compares
logits only where every layer's ids agree, and reports the flips.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve.engine import greedy_generate as jgreedy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

torch.set_num_threads(2)

MOE = ["deepseek-moe-16b", "dbrx-132b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, L = 2, 24


def _cfgs(arch, dtype="float32"):
    return (configs.get_smoke(arch).replace(compute_dtype=dtype),
            jconfigs.get_smoke(arch).replace(compute_dtype=dtype))


def _jax_mode(dtype):
    """bf16 against JAX op by op (XLA's fusion drops roundings the port
    keeps); fp32 against the jitted functions."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _pair(x: np.ndarray, dtype: str):
    """The same numpy input on both sides, rounded once to ``dtype``."""
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


def _moe_params(jcfg, seed):
    """One MoE layer's parameters: (JAX tree, torch tree)."""
    p_np = _np_tree(jmoe.init(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(jnp.asarray, p_np), to_torch(p_np, device="cpu")


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


# ==========================================================================
# capacity, routing, dispatch
# ==========================================================================


@pytest.mark.parametrize("t", [1, 4, 48, 200, 256, 1000, 2048, 4096])
@pytest.mark.parametrize("arch", MOE)
def test_capacity_matches_jax(arch, t):
    """Full and smoke configs; 200 tokens of the smoke configs give 63 and
    125 rows before the rounding up to 128."""
    for getter in ("get", "get_smoke"):
        assert (moe.capacity(t, getattr(configs, getter)(arch))
                == jmoe.capacity(t, getattr(jconfigs, getter)(arch)))


def test_capacity_at_the_deepseek_serving_point():
    """Prefill of 4 × 512 tokens: ⌈2048·6·1.25/64⌉ = 240 → 256 rows; a
    decode step of 4 tokens still gets 128."""
    cfg = configs.get("deepseek-moe-16b")
    assert moe.capacity(4 * 512, cfg) == 256 and moe.capacity(4, cfg) == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_route_matches_jax(arch, dtype):
    cfg, jcfg = _cfgs(arch, dtype)
    p_j, p_t = _moe_params(jcfg, seed=3)
    x_t, x_j = _pair(np.random.default_rng(3).standard_normal((64, cfg.d_model))
                     .astype(np.float32), dtype)
    ids_t, w_t = moe.route(p_t, cfg, x_t)
    with _jax_mode(dtype):
        ids_j, w_j = jmoe.route(p_j, jcfg, x_j)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert w_t.dtype == torch.float32
    _close(w_t, w_j, 1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_route_breaks_ties_toward_the_lower_expert_as_jax(arch):
    """Integer router and inputs make the logits exact, so equal columns tie
    bit for bit; a zero input ties every expert.  ``jax.lax.top_k`` takes
    the lower index first, and so does the port."""
    cfg, jcfg = _cfgs(arch)
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    rng = np.random.default_rng(4)
    router = rng.integers(-2, 3, (cfg.d_model, e)).astype(np.float32)
    router[:, 1] = router[:, 0]
    router[:, 3] = router[:, 2]
    x = rng.integers(-2, 3, (32, cfg.d_model)).astype(np.float32)
    x[0] = 0.0
    p_np = {"router": router}
    ids_t, w_t = moe.route(to_torch(p_np, device="cpu"), cfg, torch.from_numpy(x))
    ids_j, w_j = jmoe.route({"router": jnp.asarray(router)}, jcfg, jnp.asarray(x))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(ids_t[0].numpy(), np.arange(k))
    _close(w_t, w_j, 1e-6)
    # some row picks a tied pair (0, 1) or (2, 3), in index order
    picked = ids_t.numpy()
    assert any(list(r[:2]) in ([0, 1], [2, 3]) for r in picked[1:])


def _np_dispatch(ids, e, cap):
    """The reference's dispatch in numpy: stable sort, rank within expert."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    expert = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(expert, np.arange(e), side="left")[expert]
    return order, expert, pos


def _biased(cfg, p_np, t, seed):
    """Inputs and a router that send almost every token's top-2 to experts 0
    and 1: a large shared component on feature 0, which those two router
    columns weigh heavily."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t // 2, cfg.d_model)).astype(np.float32)
    x[..., 0] += 4.0
    p_np = dict(p_np)
    router = p_np["router"].copy()
    router[0, 0] += 10.0
    router[0, 1] += 8.0
    p_np["router"] = router
    return x, p_np


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_positions_and_drops(arch):
    """512 tokens, a router that overloads experts 0 and 1 past their
    capacity: sort order, sorted ids, ranks and the drop flags equal the
    reference's formulas in numpy; dropped assignments go to the trash row."""
    cfg, jcfg = _cfgs(arch)
    _, p_t = _moe_params(jcfg, seed=5)
    x, p_np = _biased(cfg, to_numpy(p_t), 512, seed=5)
    ids, _ = moe.route(to_torch(p_np, device="cpu"), cfg,
                       torch.from_numpy(x).reshape(-1, cfg.d_model))
    e, cap = cfg.moe.num_experts, moe.capacity(512, cfg)
    s = moe.dispatch(ids, e, cap)
    order, expert, pos = _np_dispatch(ids.numpy(), e, cap)
    np.testing.assert_array_equal(s["order"].numpy(), order)
    np.testing.assert_array_equal(s["expert"].numpy(), expert)
    np.testing.assert_array_equal(s["pos"].numpy(), pos)
    np.testing.assert_array_equal(s["kept"].numpy(), pos < cap)
    np.testing.assert_array_equal(s["row"].numpy(), np.where(pos < cap, expert, e))
    assert (pos >= cap).sum() >= 2 * (512 - cap)          # experts 0 and 1 overflow


# ==========================================================================
# the layer: apply_ref, drops, aux loss
# ==========================================================================


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_ref_matches_jax(arch, dtype):
    cfg, jcfg = _cfgs(arch, dtype)
    p_j, p_t = _moe_params(jcfg, seed=6)
    x_t, x_j = _pair(np.random.default_rng(6).standard_normal((B, L, cfg.d_model))
                     .astype(np.float32), dtype)
    ids_t, _ = moe.route(p_t, cfg, x_t.reshape(-1, cfg.d_model))
    out_t = moe.apply(p_t, cfg, x_t)
    with _jax_mode(dtype):
        ids_j, _ = jmoe.route(p_j, jcfg, x_j.reshape(-1, cfg.d_model))
        out_j = jmoe.apply_ref(p_j, jcfg, x_j)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert out_t.shape == (B, L, cfg.d_model) and out_t.dtype == cfg.cdtype
    _close(out_t, out_j, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_ref_with_drops_matches_jax(arch, dtype):
    """512 tokens with experts 0 and 1 overloaded: the dropped assignments
    contribute nothing, on both sides alike."""
    cfg, jcfg = _cfgs(arch, dtype)
    _, p_t = _moe_params(jcfg, seed=7)
    x, p_np = _biased(cfg, to_numpy(p_t), 512, seed=7)
    p_t, p_j = to_torch(p_np, device="cpu"), jax.tree.map(jnp.asarray, p_np)
    x_t, x_j = _pair(x, dtype)
    ids_t, _ = moe.route(p_t, cfg, x_t.reshape(-1, cfg.d_model))
    assert not moe.dispatch(ids_t, cfg.moe.num_experts, moe.capacity(512, cfg))["kept"].all()
    out_t = moe.apply_ref(p_t, cfg, x_t)
    with _jax_mode(dtype):
        ids_j, _ = jmoe.route(p_j, jcfg, x_j.reshape(-1, cfg.d_model))
        out_j = jmoe.apply_ref(p_j, jcfg, x_j)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    _close(out_t, out_j, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_aux_loss_matches_jax(arch, dtype):
    cfg, jcfg = _cfgs(arch, dtype)
    p_j, p_t = _moe_params(jcfg, seed=8)
    x_t, x_j = _pair(np.random.default_rng(8).standard_normal((B, L, cfg.d_model))
                     .astype(np.float32), dtype)
    got = moe.aux_loss(p_t, cfg, x_t)
    with _jax_mode(dtype):
        want = jmoe.aux_loss(p_j, jcfg, x_j)
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want, 1e-5)


def test_apply_ref_has_static_shapes_and_reads_nothing_back():
    """Under fake tensors (shapes without data) any host read (``.item()``)
    or data-dependent shape (``.nonzero()``, boolean-mask indexing) raises:
    the layer and its aux loss run through."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_smoke("deepseek-moe-16b")
    p = moe.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((B, L, cfg.d_model)).to(cfg.cdtype)
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fp = jax.tree.map(mode.from_tensor, p)
        fx = mode.from_tensor(x)
        y = moe.apply_ref(fp, cfg, fx)
        aux = moe.aux_loss(fp, cfg, fx)
    assert tuple(y.shape) == (B, L, cfg.d_model) and aux.dim() == 0


# ==========================================================================
# the model: layouts, conversion, forward / prefill / decode, greedy, loss
# ==========================================================================


@pytest.mark.parametrize("arch", MOE)
def test_init_tree_layout_matches_jax(arch):
    """Same keys and shapes (``blocks/s0/moe/{router, w_gate, w_up, w_down,
    shared/*}`` behind the ``[G]`` dim) and decode cache; every expert
    weight drawn at the reference's scale 1/√fan-in, ``w_down`` at 1/√D."""
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    mine = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    theirs = jlm.init(jax.random.PRNGKey(0), jcfg)
    assert ({k: tuple(v.shape) for k, v in _flat(mine).items()}
            == {k: tuple(v.shape) for k, v in _flat(theirs).items()})
    p = mine["blocks"]["s0"]["moe"]
    m = cfg.moe
    g = lm.groups_of(cfg)[0]
    assert tuple(p["w_down"].shape) == (g, m.num_experts, m.d_expert, cfg.d_model)
    assert ("shared" in p) == bool(m.num_shared)
    for name in ("router", "w_gate", "w_up", "w_down"):
        # a sample std of n normal draws is off by 1/√(2n) relative: allow 5 of those
        tol = 5 / np.sqrt(2 * p[name].numel())
        ref = np.asarray(_flat(theirs)[f"['blocks']['s0']['moe']['{name}']"])
        for w in (p[name].numpy(), ref):
            assert abs(w.std() * cfg.d_model ** 0.5 - 1) < tol, name
    cache_m = lm.init_cache(cfg, 2, 40, device="cpu")
    cache_t = jlm.init_cache(jcfg, 2, 40)
    assert cache_m.pop("pos") == int(cache_t.pop("pos"))
    assert ({k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in _flat(cache_m).items()}
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(cache_t).items()})


@pytest.mark.parametrize("arch", MOE)
def test_convert_round_trip_of_the_moe_tree(arch):
    tree = _np_tree(jlm.init(jax.random.PRNGKey(1), jconfigs.get_smoke(arch)))
    t = to_torch(tree, device="cpu")
    assert t["blocks"]["s0"]["moe"]["w_gate"].dtype == torch.float32
    back = to_numpy(t)
    assert _flat(back).keys() == _flat(tree).keys()
    for key, a in _flat(back).items():
        np.testing.assert_array_equal(a, _flat(tree)[key], err_msg=key)


def _perturbed_params(jcfg, seed):
    """JAX init with the zero-initialised norms made nonzero."""
    rng = np.random.default_rng(seed)
    tree = _np_tree(jlm.init(jax.random.PRNGKey(seed), jcfg))

    def bump(a):
        return a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype) if not a.any() else a
    tree = jax.tree.map(bump, tree)
    return jax.tree.map(jnp.asarray, tree), tree


@contextlib.contextmanager
def _recorded_routes():
    """Record every ``route`` call's expert ids on both sides, in call order."""
    calls = {"torch": [], "jax": []}
    t_route, j_route = moe.route, jmoe.route

    def t_rec(*a):
        out = t_route(*a)
        calls["torch"].append(out[0].numpy().copy())
        return out

    def j_rec(*a):
        out = j_route(*a)
        # the reference's remat traces its groups even with jit disabled
        jax.debug.callback(lambda ids: calls["jax"].append(np.asarray(ids)), out[0])
        return out
    moe.route, jmoe.route = t_rec, j_rec
    try:
        yield calls
    finally:
        moe.route, jmoe.route = t_route, j_route


def _agreeing_prefix(calls, b, l):
    """Per batch row, the number of leading positions before the first token
    whose expert ids differ in any layer; a flip changes that token and,
    through attention, every later one.  Returns (lengths, flipped tokens)."""
    assert len(calls["torch"]) == len(calls["jax"]) > 0
    flipped = np.zeros((b, l), bool)
    for ids_t, ids_j in zip(calls["torch"], calls["jax"]):
        flipped |= (ids_t != ids_j).any(-1).reshape(b, l)
    lengths = np.where(flipped.any(1), flipped.argmax(1), l)
    return lengths, int(flipped.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_lm_forward_prefill_decode_match_jax(arch, dtype):
    """Forward (logits and aux), prefill (last logits and every cache leaf),
    one decode step (logits and the updated cache).  In bf16 the logits and
    KV rows are compared where every layer's expert ids agree (a flip across
    a router near-tie moves a whole expert's output); the flips are printed
    and at most a few tokens may flip."""
    cfg, jcfg = _cfgs(arch, dtype)
    p_j, p_np = _perturbed_params(jcfg, seed=2)
    p_t = to_torch(p_np, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, L)).astype(np.int32)
    tol = TOL[dtype]
    bf16 = dtype == "bfloat16"
    record = _recorded_routes if bf16 else contextlib.nullcontext

    with record() as calls, _jax_mode(dtype):
        logits_j, aux_j = jlm.forward(p_j, jcfg, jnp.asarray(toks))
        logits_t, aux_t = lm.forward(p_t, cfg, torch.from_numpy(toks))
    keep = np.full(B, L)
    if bf16:
        keep, n_flipped = _agreeing_prefix(calls, B, L)
        print(f"{arch} bf16 forward: {n_flipped} of {B * L} tokens flip an expert; "
              f"compared prefixes {keep.tolist()}")
        assert keep.sum() >= B * L // 2
    assert logits_t.shape == (B, L, cfg.padded_vocab) and aux_t.dtype == torch.float32
    for b in range(B):
        _close(logits_t[b, :keep[b]], np.asarray(logits_j, np.float32)[b, :keep[b]], tol)
    _close(aux_t, aux_j, 1e-4 if not bf16 else 1e-2)
    assert float(aux_t) > 0

    keep = np.full(B, L - 1)
    with record() as calls, _jax_mode(dtype):
        cache_j, pre_j = jlm.prefill(p_j, jcfg, jnp.asarray(toks[:, :-1]), max_len=L + 4)
        cache_t, pre_t = lm.prefill(p_t, cfg, torch.from_numpy(toks[:, :-1]), max_len=L + 4)
    if bf16:
        keep, n_flipped = _agreeing_prefix(calls, B, L - 1)
        print(f"{arch} bf16 prefill: {n_flipped} flipped tokens; compared prefixes "
              f"{keep.tolist()}")
    _check_cache(cache_t, cache_j, keep, tol)
    rows = np.flatnonzero(keep == L - 1)
    _close(pre_t[rows], np.asarray(pre_j, np.float32)[rows], tol)
    assert cache_t["pos"] == int(cache_j["pos"]) == L - 1

    with record() as calls, _jax_mode(dtype):
        dec_j, dec_cache_j = jlm.decode_step(p_j, jcfg, jnp.asarray(toks[:, -1:]), cache_j)
        dec_t, dec_cache_t = lm.decode_step(p_t, cfg, torch.from_numpy(toks[:, -1:]),
                                            cache_t)
    if bf16:
        agree, n_flipped = _agreeing_prefix(calls, B, 1)
        print(f"{arch} bf16 decode: {n_flipped} flipped tokens")
        rows = np.intersect1d(rows, np.flatnonzero(agree == 1))
        assert len(rows) >= 1
    _close(dec_t[rows], np.asarray(dec_j, np.float32)[rows], tol)
    keep[rows] = L
    _check_cache(dec_cache_t, dec_cache_j, keep, tol)
    assert dec_cache_t["pos"] == L


def _check_cache(got, want, keep, tol):
    """Every KV ring leaf ``[G, B, slots, Hkv, hd]``, row b over its first
    ``keep[b]`` slots (the positions written so far that were compared)."""
    flat_t = _flat({k: v for k, v in got.items() if k != "pos"})
    flat_j = _flat({k: v for k, v in want.items() if k != "pos"})
    assert flat_t.keys() == flat_j.keys()
    for key, leaf in flat_t.items():
        ref = np.asarray(flat_j[key], np.float32)
        for b in range(B):
            _close(leaf[:, b, :keep[b]], ref[:, b, :keep[b]], tol, key)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_tokens_equal_jax(arch):
    """fp32 greedy tokens equal the JAX engine's."""
    cfg, jcfg = _cfgs(arch)
    p_j = jlm.init(jax.random.PRNGKey(1), jcfg)
    p_t = to_torch(jax.tree.map(np.asarray, p_j), device="cpu")
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(jgreedy(p_j, jcfg, jnp.asarray(prompt), 8))
    got = engine.greedy_generate(p_t, cfg, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("remat", ["dots", "none"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grad_match_jax(arch, remat):
    """fp32 loss (CE + weight · aux), its metrics and the gradient of every
    leaf against ``jax.value_and_grad`` at 1e-4; under remat "dots" the
    experts' batched products are recomputed in the backward."""
    cfg, jcfg = (c.replace(remat=remat) for c in _cfgs(arch))
    p_j, p_np = _perturbed_params(jcfg, seed=10)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab, (B, L + 1)).astype(np.int32)
    batch_np = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "mask": (rng.random((B, L)) > 0.2).astype(np.float32)}
    (loss_j, met_j), grads_j = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch_np.items()}),
        has_aux=True)(p_j)
    p_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p_np)
    loss_t, met_t = lm.loss_fn(p_t, cfg, {k: torch.from_numpy(v) for k, v in batch_np.items()})
    loss_t.backward()
    _close(loss_t, loss_j, 1e-4)
    for name in ("ce", "aux", "tokens"):
        _close(met_t[name], met_j[name], 1e-4, name)
    flat_g = _flat(jax.tree.map(lambda t: t.grad, p_t))
    for key, g in _flat(grads_j).items():
        _close(flat_g[key], g, 1e-4, key)
    router_g = flat_g["['blocks']['s0']['moe']['router']"]
    assert float(router_g.abs().max()) > 0            # the aux loss reaches the router


@pytest.mark.parametrize("scope,name,cls", [
    ("moe.experts", "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT", "moe_experts_bmm"),
    ("moe.experts", "void at::native::vectorized_elementwise_kernel<4, "
                    "at::native::bfloat16_copy_kernel_cuda>", "moe_experts_elementwise"),
    ("moe.dispatch", "void at::native::index_put_kernel_impl<8>", "moe_dispatch"),
    ("moe.dispatch", "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel",
     "moe_dispatch"),
    ("moe.combine", "void at::native::index_elementwise_kernel<128, 4>", "moe_dispatch"),
    ("moe.route", "void at::native::bitonicSortKVInPlace<float, long>", "moe_route"),
    (None, "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", "index/sort/cat"),
    (None, "void at::native::searchsorted_cuda_kernel<long>", "index/sort/cat"),
    (None, "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT", "matmul"),
    ("moe.experts", "void flash_fwd_kernel<float, 64>", "flash_attention")])
def test_profile_classes_moe_kernels_by_their_range(scope, name, cls):
    """A kernel launched inside a ``moe.*`` range is classed by that range
    (the expert products apart from the weight casts); outside one, a sort
    kernel is "index/sort/cat", not "other"."""
    assert profile_serve.kernel_class(name, scope) == cls


def test_profile_finds_the_moe_range_of_each_kernel():
    """The MoE layer marks its steps while the profiler records, with every
    operator of a step under its range; on the device timeline a range is
    one span over its kernels, and each kernel inside a span takes its name
    (here with stand-in events: the CPU has no device kernels)."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get_smoke("deepseek-moe-16b")
    p = moe.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((B, L, cfg.d_model)).to(cfg.cdtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        moe.apply_ref(p, cfg, x)
    events = list(prof.events())
    assert {e.name for e in events} >= set(moe.SCOPES)
    bmm = [e for e in events if e.name == "aten::bmm"]
    assert len(bmm) == 4                              # 3 expert products + the combine
    under = []
    for e in bmm:
        while e is not None and e.name not in moe.SCOPES:
            e = e.cpu_parent
        under.append(e.name)
    assert under == ["moe.experts"] * 3 + ["moe.combine"]

    def ev(name, start, end):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end))
    ranges = [ev("moe.experts", 12, 40), ev("moe.dispatch", 0, 10)]
    kernels = [ev("index_put", 1, 4), ev("nvjet_a", 12, 30), ev("copy", 31, 40),
               ev("nvjet_b", 45, 50), ev("fill", 10, 13)]
    assert profile_serve.kernel_scopes(kernels, ranges) == [
        "moe.dispatch", "moe.experts", "moe.experts", None, None]
