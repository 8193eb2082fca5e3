"""The port's rule table, the mesh context and the plain versions of the
distributed branches against the JAX package, in one process.

The reference's rules need only the mesh's axis sizes, so its side runs on
a ``jax.sharding.AbstractMesh`` (no devices) and the port's on a mapping of
the same sizes; every leaf of every config's parameter tree (full and
smoke, through each side's ``init_shapes``) and decode cache (with and
without ``shard_kv_seq``) must get the same spec.  The multi-rank checks
are in ``test_torch_mesh.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel.mesh_ctx import MeshCtx as JMeshCtx  # noqa: E402
from repro.parallel.sharding import cache_shardings as jcache_shardings  # noqa: E402
from repro.parallel.sharding import input_shardings as jinput_shardings  # noqa: E402
from repro.parallel.sharding import param_shardings as jparam_shardings  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models import attention, lm, moe  # noqa: E402
from repro_torch.parallel import ref as pref  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel import mesh_ctx  # noqa: E402
from repro_torch.parallel.mesh_ctx import MeshCtx, current_ctx, mesh_context  # noqa: E402

torch.set_num_threads(2)

#: (axis sizes, batch axes): the reference test's (2,2,2) pod/data/model,
#: its (2,4) data/model, and the production (16,16)
MESHES = {
    "pod2-data2-model2": ({"pod": 2, "data": 2, "model": 2}, ("pod", "data")),
    "data2-model4": ({"data": 2, "model": 4}, ("data",)),
    "data16-model16": ({"data": 16, "model": 16}, ("data",)),
}
SIZES = ("full", "smoke")
CACHE_BATCH, CACHE_LEN = 16, 64


def _cfgs(arch, size):
    get = "get" if size == "full" else "get_smoke"
    return getattr(configs, get)(arch), getattr(jconfigs, get)(arch)


def _ctx(mesh, **knobs):
    sizes, batch = MESHES[mesh]
    return MeshCtx(sizes, batch_axes=batch, fsdp_axes=("data",), **knobs)


def _jctx(mesh, **knobs):
    sizes, batch = MESHES[mesh]
    return JMeshCtx(AbstractMesh(tuple(sizes.values()), tuple(sizes)), batch_axes=batch,
                    fsdp_axes=("data",), **knobs)


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _jspecs(tree) -> dict:
    """path → spec (one entry per dim) of a tree of NamedShardings over SDS."""
    shardings, leaves = tree
    out = {}
    for (path, sh), leaf in zip(jax.tree_util.tree_leaves_with_path(shardings),
                                jax.tree.leaves(leaves)):
        names = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        spec = tuple(_norm(e) for e in sh.spec)
        out[names] = spec + (None,) * (len(leaf.shape) - len(spec))
    return out


def _port_specs(specs, tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_port_specs(specs[k], tree[k], path + (k,)))
        return out
    return {path: tuple(_norm(e) for e in specs)}


@functools.lru_cache(maxsize=None)
def _jax_params(arch, size):
    return jlm.init_shapes(_cfgs(arch, size)[1])


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, size):
    jcfg = _cfgs(arch, size)[1]
    return jax.eval_shape(lambda: jlm.init_cache(jcfg, CACHE_BATCH, CACHE_LEN))


# ==========================================================================
# init_shapes
# ==========================================================================


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_shapes_match_jax_init_shapes(arch, size):
    """Keys, shapes and dtypes on the ``meta`` device, no allocation, equal
    to the reference's abstract tree (dbrx-132b and mistral-large-123b at
    full width included)."""
    cfg, _ = _cfgs(arch, size)
    tree = lm.init_shapes(cfg)
    flat = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat[path] = t
    walk(tree)
    assert all(t.device.type == "meta" for t in flat.values())
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in flat.items()}
    want = {tuple(str(k.key) for k in path): (tuple(s.shape), str(s.dtype))
            for path, s in jax.tree_util.tree_leaves_with_path(_jax_params(arch, size))}
    assert got == want


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_shapes_match_init(arch):
    """The smoke config's ``init_shapes`` has ``init``'s keys, shapes and
    dtypes."""
    cfg = configs.get_smoke(arch)
    shapes = lm.init_shapes(cfg)
    real = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")

    def pairs(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                pairs(a[k], b[k])
            else:
                assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    pairs(shapes, real)


# ==========================================================================
# the rule table
# ==========================================================================


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_jax(arch, size, mesh):
    """``param_shardings`` (so ``spec_for`` with its divisibility guards)
    equals the reference's for every leaf."""
    cfg, _ = _cfgs(arch, size)
    tree = lm.init_shapes(cfg)
    got = _port_specs(sharding.param_shardings(tree, _ctx(mesh)), tree)
    jtree = _jax_params(arch, size)
    want = _jspecs((jparam_shardings(jtree, _jctx(mesh)), jtree))
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_specs_match_jax(arch, size, mesh):
    """``cache_shardings`` of the decode cache, with ``shard_kv_seq`` off and
    on, equals the reference's for every leaf (``pos`` is an int in the
    port and a 0-d array in the reference: both replicated)."""
    cfg, _ = _cfgs(arch, size)
    cache = lm.init_cache(cfg, CACHE_BATCH, CACHE_LEN, device="meta")
    jcache = _jax_cache(arch, size)
    for kv_seq in (False, True):
        got = _port_specs(sharding.cache_shardings(cache, _ctx(mesh, shard_kv_seq=kv_seq)),
                          cache)
        got[("pos",)] = ()
        want = _jspecs((jcache_shardings(jcache, _jctx(mesh, shard_kv_seq=kv_seq)), jcache))
        assert got == want, kv_seq


def test_rules_at_the_reference_tests_points():
    """The reference test's own assertions (yi-9b smoke on (2,2,2)), and a
    sequence-sharded ring at the seq-shard test's point."""
    ctx = _ctx("pod2-data2-model2")
    sh = sharding.param_shardings(lm.init_shapes(configs.get_smoke("yi-9b")), ctx)
    assert sh["blocks"]["s0"]["attn"]["wq"] == (None, "data", "model")
    assert sh["blocks"]["s0"]["attn"]["wo"] == (None, "model", "data")
    assert sh["embed"] == ("model", "data")
    assert sh["final_norm"] == (None,)
    cfg = configs.get_smoke("yi-9b")
    cache = lm.init_cache(cfg, 2, 32, device="meta")
    specs = sharding.cache_shardings(cache, _ctx("data2-model4", shard_kv_seq=True))
    assert specs["blocks"]["s0"]["k"] == (None, "data", "model", None, None)


def test_input_and_batch_specs_match_jax():
    for mesh in MESHES:
        ctx, jctx = _ctx(mesh), _jctx(mesh)
        tree = {"tokens": torch.zeros((8, 32), dtype=torch.int32, device="meta"),
                "odd": torch.zeros((3, 5), device="meta"),
                "scalar": torch.zeros((), device="meta")}
        jtree = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in tree.items()}
        got = _port_specs(sharding.input_shardings(ctx, tree), tree)
        assert got == _jspecs((jinput_shardings(jctx, jtree), jtree))
        from repro.parallel.sharding import batch_spec as jbatch_spec
        for rank, bd in ((2, 0), (3, 1)):
            assert sharding.batch_spec(ctx, rank, batch_dim=bd) == tuple(
                _norm(e) for e in jbatch_spec(jctx, rank, batch_dim=bd))


def test_safe_spec_drops_what_does_not_divide():
    sizes = {"data": 2, "model": 4}
    assert sharding.safe_spec((6, 8, 3), ("model", ("data", "model"), None), sizes) == (
        None, ("data", "model"), None)
    assert sharding.safe_spec((4, 2), ("data",), sizes) == ("data", None)


class _Mesh:
    """The two attributes :func:`sharding.placements` reads of a DeviceMesh."""
    mesh_dim_names = ("pod", "data", "model")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements((None, ("pod", "data"), "model"), _Mesh()) == [
        Shard(1), Shard(1), Shard(2)]
    assert sharding.placements((None, None), _Mesh()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sharding.placements((("data", "pod"),), _Mesh())


def test_local_slices_follow_the_mesh_coordinates():
    class Ctx(MeshCtx):
        def coord(self, axis):
            return {"pod": 1, "data": 0, "model": 3}[axis]
    ctx = Ctx({"pod": 2, "data": 2, "model": 4}, batch_axes=("pod", "data"))
    assert sharding.local_slices((8, 16, 3), (("pod", "data"), "model", None), ctx) == (
        slice(4, 6), slice(12, 16), slice(0, 3))
    with pytest.raises(ValueError, match="split"):
        sharding.local_slices((6,), ("model",), ctx)


# ==========================================================================
# the context itself
# ==========================================================================


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m", "recurrentgemma-9b",
                                  "seamless-m4t-medium", "deepseek-moe-16b"])
def test_forward_is_unchanged_by_a_context_of_sizes(arch):
    """A context of axis sizes alone has no ranks: every branch stays
    plain (the MoE layer ``apply_ref``, not ``apply_ep``), so the logits
    are the same with and without it, and the context is gone after the
    block."""
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    kw = ({"frames": torch.randn(2, 2, 1024, generator=torch.Generator().manual_seed(2))}
          if cfg.frame_input else {})
    want, _ = lm.forward(params, cfg, toks, **kw)
    ctx = _ctx("data2-model4", shard_kv_seq=True)
    assert not ctx.on_ranks
    with mesh_context(ctx):
        assert current_ctx() is ctx
        got, _ = lm.forward(params, cfg, toks, **kw)
    assert current_ctx() is None
    assert torch.equal(got, want)


def test_make_ctx_derives_the_axes():
    ctx = launch_mesh.make_ctx({"pod": 2, "data": 16, "model": 16}, shard_kv_seq=True)
    assert (ctx.batch_axes, ctx.fsdp_axes, ctx.model_size, ctx.batch_size) == (
        ("pod", "data"), ("data",), 16, 32)
    assert ctx.shard_kv_seq and ctx.all_axes == ("pod", "data", "model")
    assert launch_mesh.make_ctx({"data": 2, "model": 4}).batch_axes == ("data",)


def test_all_reduce_refuses_a_tensor_that_needs_a_gradient():
    """Autograd does not see ``dist.all_reduce``: the distributed branches
    refuse to train rather than give a wrong gradient.  The check comes
    before the collective, so no process group is needed to see it."""
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="do not differentiate"):
        mesh_ctx.all_reduce(w * 2, group=None)


def test_make_mesh_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_mesh.make_mesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_mesh.init_ranks(0, 1, "tcp://localhost:1")


# ==========================================================================
# the plain versions of the distributed branches, in one process
# ==========================================================================


def test_moe_apply_dispatches_to_ep_only_where_experts_divide():
    """Without a context, or with a model axis that does not divide the
    experts, ``moe.apply`` is ``apply_ref``."""
    cfg = configs.get_smoke("deepseek-moe-16b").replace(compute_dtype="float32")
    p = moe.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    want = moe.apply_ref(p, cfg, x)
    assert torch.equal(moe.apply(p, cfg, x), want)
    with mesh_context(MeshCtx({"data": 1, "model": 3})):     # 8 experts % 3 != 0
        assert torch.equal(moe.apply(p, cfg, x), want)


@pytest.mark.parametrize("t_loc", [1, 2, 16, 32, 200, 1024])
def test_ep_capacity_rounds_to_8_on_the_local_tokens(t_loc):
    """The reference's ``apply_ep`` capacity (``moe.py:164-165``); 1024
    tokens of deepseek-moe-16b give 120 rows (``apply_ref``'s 128 rounding
    would give 128)."""
    for cfg in (configs.get_smoke("deepseek-moe-16b"), configs.get("deepseek-moe-16b")):
        m = cfg.moe
        cap = -(-t_loc * m.top_k * m.capacity_factor // m.num_experts)
        assert moe.ep_capacity(t_loc, cfg) == max(8, -(-int(cap) // 8) * 8)
    assert moe.ep_capacity(1024, configs.get("deepseek-moe-16b")) == 120


def test_ep_emulation_on_one_rank_is_apply_ref_when_nothing_drops():
    """A (1, 1) mesh puts every token and expert on one rank; with the
    capacity no assignment exceeds, EP and ``apply_ref`` compute the same
    function (they differ only in which tokens drop)."""
    cfg = configs.get_smoke("deepseek-moe-16b").replace(compute_dtype="float32")
    p = moe.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    got = pref.apply_ep_emulated(p, cfg, x, {"data": 1, "model": 1})
    torch.testing.assert_close(got, moe.apply_ref(p, cfg, x), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_decode_seqshard_emulation_matches_plain_decode(n_model, window):
    """The two-phase softmax over slot blocks against the plain masked
    decode (fp32, 1e-5), the ring written the same way, at a position that
    wraps the ring and one that does not."""
    cfg = configs.get_smoke("yi-9b").replace(compute_dtype="float32", attn_softcap=30.0)
    rng = np.random.default_rng(0)
    b, slots, hkv, g, hd = 2, 16, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    for pos in (9, 21):
        q = torch.from_numpy(rng.standard_normal((b, 1, hkv * g, hd)).astype(np.float32))
        kn, vn = (torch.from_numpy(rng.standard_normal((b, 1, hkv, hd)).astype(np.float32))
                  for _ in range(2))
        ck, cv = (torch.from_numpy(rng.standard_normal((b, slots, hkv, hd)).astype(np.float32))
                  for _ in range(2))
        ck2, cv2 = ck.clone(), cv.clone()
        got = pref.decode_seqshard_emulated(cfg, q, kn, vn, ck, cv, pos, window, n_model)
        slot = pos % slots
        ck2[:, slot:slot + 1], cv2[:, slot:slot + 1] = kn, vn
        idx = torch.arange(slots)
        age = pos - attention._slot_position(idx, slot, slots, pos)
        valid = (age >= 0) & (age <= pos)
        if window:
            valid &= age < window
        want = attention._sdpa(q, ck2, cv2, valid[None, None, :].expand(b, 1, slots),
                               cfg.attn_softcap)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


def test_restore_with_shardings_needs_a_context(tmp_path):
    from repro_torch.train import checkpoint as ckpt
    tree = {"w": torch.ones(4, 4)}
    ckpt.save(tree, str(tmp_path), 1)
    with pytest.raises(ValueError, match="mesh context"):
        ckpt.restore(tree, str(tmp_path), device="cpu", shardings={"w": ("data", None)})
    restored = ckpt.restore(tree, str(tmp_path), device="cpu")
    assert torch.equal(restored["w"], tree["w"])


def test_to_torch_trees_keep_their_specs():
    """Specs address the tree by key path, so a tree converted from the
    reference's gets the specs the reference's tree gets."""
    jcfg = jconfigs.get_smoke("deepseek-moe-16b")
    jtree = jlm.init(jax.random.PRNGKey(0), jcfg)
    tree = to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), jtree), device="cpu")
    got = _port_specs(sharding.param_shardings(tree, _ctx("data2-model4")), tree)
    want = _jspecs((jparam_shardings(jtree, _jctx("data2-model4")), jtree))
    assert got == want
