"""The port's training path against the JAX package's: AdamW, the loss and
its gradients, remat, the train step, checkpoints both ways, and the
committed (exactly-once) trainer, all on the CPU."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.commit import CommittedTrainer as JCommittedTrainer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common, lm  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.commit import CommittedTrainer, batch_to  # noqa: E402
from repro_torch.train.step import (make_train_step, train_state_init,  # noqa: E402
                                    train_state_shapes)

torch.set_num_threads(2)

ARCHS = ["yi-9b", "gemma2-27b", "mamba2-370m", "recurrentgemma-9b"]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _t(tree):
    return to_torch(tree, device="cpu")


def _close(mine, theirs, atol, rtol=0.0):
    flat_m, flat_t = jax.tree_util.tree_leaves_with_path(to_numpy(mine)), \
        jax.tree_util.tree_leaves_with_path(_np(theirs))
    assert [p for p, _ in flat_m] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_m, flat_t):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


# ---- optimizer: the four cases of tests/test_train.py, against JAX ----------


def test_adamw_matches_jax_and_numpy():
    p = {"w": np.array([1.0, -2.0], np.float32),
         "b": np.array([[0.5, 0.5], [1.0, 1.0]], np.float32)}
    g = {"w": np.array([0.1, 0.2], np.float32),
         "b": np.array([[1.0, -1.0], [0.0, 2.0]], np.float32)}
    kw = dict(lr=0.1, b1=0.9, b2=0.95, weight_decay=0.0)
    jp, jopt = joptim.adamw_update(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
                                   joptim.adamw_init(p), jnp.int32(0), **kw)
    tp, topt = optim.adamw_update(_t(p), _t(g), optim.adamw_init(_t(p)),
                                  torch.zeros((), dtype=torch.int32), **kw)
    _close(tp, jp, atol=1e-7)
    _close(topt, jopt, atol=1e-7)
    for k in p:
        m, v = 0.1 * g[k], 0.05 * g[k] ** 2
        want = p[k] - 0.1 * (m / 0.1) / (np.sqrt(v / 0.05) + 1e-8)
        np.testing.assert_allclose(tp[k].numpy(), want, atol=1e-6)
    assert torch.equal(_t(p)["w"], torch.tensor([1.0, -2.0]))     # inputs left as they were


def test_weight_decay_skips_vectors():
    p = {"w2d": np.ones((2, 2), np.float32), "w1d": np.ones((2,), np.float32)}
    g = {"w2d": np.zeros((2, 2), np.float32), "w1d": np.zeros((2,), np.float32)}
    tp, _ = optim.adamw_update(_t(p), _t(g), optim.adamw_init(_t(p)),
                               torch.zeros((), dtype=torch.int32), lr=0.1, weight_decay=0.5)
    jp, _ = joptim.adamw_update(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
                                joptim.adamw_init(p), jnp.int32(0), lr=0.1, weight_decay=0.5)
    assert float(tp["w2d"][0, 0]) < 1.0 and float(tp["w1d"][0]) == 1.0
    _close(tp, jp, atol=1e-7)


def test_clip_by_global_norm():
    g = {"a": np.full((3,), 4.0, np.float32), "b": {"c": np.ones((2, 2), np.float32)}}
    clipped, norm = optim.clip_by_global_norm(_t(g), 1.0)
    jclipped, jnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-7)
    assert float(norm) == pytest.approx(np.sqrt(52.0))
    _close(clipped, jclipped, atol=1e-7)
    small, n2 = optim.clip_by_global_norm(_t(g), 100.0)       # under the limit: unchanged
    _close(small, g, atol=0.0)


@pytest.mark.parametrize("step", [0, 5, 10, 40, 100, 150])
def test_cosine_schedule(step):
    kw = dict(base_lr=1.0, warmup=10, total=100)
    got = optim.cosine_lr(torch.tensor(step, dtype=torch.int32), **kw)
    want = joptim.cosine_lr(jnp.int32(step), **kw)
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    if step == 100:
        assert float(got) == pytest.approx(0.1, rel=1e-3)


# ---- loss and gradients ------------------------------------------------------


def _batch(cfg, seed=0, b=2, l=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, l)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, l)).astype(np.int32),
            "mask": (rng.random((b, l)) < 0.8).astype(np.float32)}


def _cfgs(arch, **kw):
    return configs.get_smoke(arch).replace(**kw), jconfigs.get_smoke(arch).replace(**kw)


def _port_grads(params_np, cfg, batch):
    params = jax.tree.map(lambda t: t.requires_grad_(), _t(params_np))
    loss, metrics = lm.loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss, metrics, jax.tree.map(lambda t: t.grad, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_fp32(arch):
    """loss_fn's value, metrics and every parameter's gradient against
    ``jax.value_and_grad(repro.models.lm.loss_fn)``, fp32 at 1e-4; the mask
    drops about a fifth of the tokens."""
    cfg, jcfg = _cfgs(arch, compute_dtype="float32", remat="none")
    params = jlm.init(jax.random.PRNGKey(1), jcfg)
    batch = _batch(cfg)
    (lj, mj), gj = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                           static_argnums=1)(params, jcfg, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = _port_grads(_np(params), cfg, batch)
    assert float(loss.detach()) == pytest.approx(float(lj), rel=1e-4, abs=1e-4)
    for k in ("ce", "aux", "tokens"):
        assert float(metrics[k].detach()) == pytest.approx(float(mj[k]), rel=1e-5, abs=1e-6), k
    assert float(metrics["tokens"]) == batch["mask"].sum()
    _close(grads, gj, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_eager_jax_bf16(arch):
    """In bf16 only the loss is held (3e-2, against JAX op by op): the
    reference's bf16 gradients below L = 2048 come from autodiff through
    its dense attention, which rounds p to bf16, and the port's from FA2
    with fp32 p."""
    cfg, jcfg = _cfgs(arch, compute_dtype="bfloat16", remat="none")
    params = jlm.init(jax.random.PRNGKey(2), jcfg)
    batch = _batch(cfg, seed=2)
    with jax.disable_jit():
        lj, _ = jlm.loss_fn(params, jcfg, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = _port_grads(_np(params), cfg, batch)
    assert abs(float(loss.detach()) - float(lj)) <= 3e-2
    assert all(bool(torch.isfinite(g).all()) for g in common.tree_leaves(grads))


def test_unit_mask_and_default_mask_agree():
    cfg = configs.get_smoke("yi-9b").replace(compute_dtype="float32")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        full, _ = lm.loss_fn(params, cfg, {**b, "mask": torch.ones_like(b["mask"])})
        none, m = lm.loss_fn(params, cfg, {k: v for k, v in b.items() if k != "mask"})
    assert float(full) == float(none) and float(m["tokens"]) == b["tokens"].numel()


@pytest.mark.parametrize("arch", ["yi-9b", "recurrentgemma-9b"])
def test_remat_policies_give_the_same_gradients(arch):
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    params = _np(jlm.init(jax.random.PRNGKey(3), jconfigs.get_smoke(arch)))
    batch = _batch(cfg, seed=3)
    out = {r: _port_grads(params, cfg.replace(remat=r), batch) for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert float(out[r][0]) == float(out["none"][0])
        for a, b in zip(common.tree_leaves(out[r][2]), common.tree_leaves(out["none"][2])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


def test_unknown_remat_raises():
    cfg = configs.get_smoke("yi-9b").replace(remat="some")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = jax.tree.map(lambda t: t.requires_grad_(), params)
    with pytest.raises(ValueError, match="remat"):
        lm.loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})


# ---- the train step ------------------------------------------------------------


def _states(cfg, jcfg, seed=0):
    jstate = jstep.train_state_init(jax.random.PRNGKey(seed), jcfg)
    return jstate, _t(_np(jstate))


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m", "recurrentgemma-9b"])
def test_three_train_steps_match_jax(arch):
    """fp32: losses at rtol 1e-4, every parameter and moment at atol 1e-4
    after each of 3 steps, on make_batch data: the dense path and both
    recurrent paths that the card now trains through the scans' backward
    kernels (here their plain versions)."""
    cfg, jcfg = _cfgs(arch, compute_dtype="float32", remat="dots")
    jstate, state = _states(cfg, jcfg)
    jfn = jax.jit(jstep.make_train_step(jcfg, lr=1e-3))
    fn = make_train_step(cfg, lr=1e-3)
    for s in range(3):
        batch = make_batch(cfg, 32, 2, step=s)
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = fn(state, batch_to(batch, "cpu"))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert int(state["step"]) == int(jstate["step"]) == s + 1
        _close(state["params"], jstate["params"], atol=1e-4)
        _close(state["opt"], jstate["opt"], atol=1e-4)


def test_microbatch_equivalence():
    """n microbatches of b/n ≡ one batch of b (same grads, fp32 accum)."""
    cfg = configs.get_smoke("yi-9b").replace(remat="none", compute_dtype="float32")
    state = train_state_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = batch_to(make_batch(cfg, 16, 4, step=0), "cpu")
    s1, m1 = make_train_step(cfg, lr=1e-3)(state, batch)
    s2, m2 = make_train_step(cfg, lr=1e-3, microbatches=2)(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(common.tree_leaves(s1["params"]), common.tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, microbatches=3)(state, batch)


def test_gather_dtype_casts_the_master_tree_as_the_reference():
    """With gather_dtype bf16 AdamW updates the cast tree: after one step
    the parameters are bf16 and m, v stay fp32, in both packages."""
    cfg, jcfg = _cfgs("yi-9b", gather_dtype="bfloat16", remat="none")
    jstate, state = _states(cfg, jcfg)
    batch = make_batch(cfg, 16, 2, step=0)
    jstate, _ = jax.jit(jstep.make_train_step(jcfg))(jstate, jax.tree.map(jnp.asarray, batch))
    state, m = make_train_step(cfg)(state, batch_to(batch, "cpu"))
    def kinds(tree):
        return {str(x.dtype).removeprefix("torch.") for x in jax.tree.leaves(tree)}
    assert kinds(state["params"]) == {"bfloat16"} == {str(x.dtype) for x in
                                                      jax.tree.leaves(jstate["params"])}
    assert kinds(state["opt"]) == {"float32"} == {str(x.dtype) for x in
                                                  jax.tree.leaves(jstate["opt"])}
    assert bool(torch.isfinite(m["loss"]))


def test_cast_tree_and_state_shapes_match_jax():
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros((), dtype=torch.int32)}}
    out = common.cast_tree(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16 and out["b"]["c"].dtype == torch.int32
    for arch in ("yi-9b", "recurrentgemma-9b"):
        mine = train_state_shapes(configs.get_smoke(arch))
        theirs = jstep.train_state_shapes(jconfigs.get_smoke(arch))
        assert all(t.device.type == "meta" for t in common.tree_leaves(mine))
        shapes = lambda tree: [(jax.tree_util.keystr(p), tuple(x.shape),  # noqa: E731
                                str(x.dtype).removeprefix("torch."))
                               for p, x in jax.tree_util.tree_leaves_with_path(tree)]
        assert shapes(mine) == shapes(theirs)


# ---- checkpoints -----------------------------------------------------------------


def test_checkpoint_written_by_torch_restores_in_jax_and_back(tmp_path):
    cfg, jcfg = _cfgs("recurrentgemma-9b")
    state = train_state_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    state["step"] = torch.tensor(7, dtype=torch.int32)
    path = ckpt.save(state, str(tmp_path / "t"), 7)
    assert path.endswith("ckpt_00000007.npz")
    with np.load(path) as data:
        assert "opt§m§blocks§s0§rec§w_x" in data.files and data["step"].dtype == np.int32
        assert list(data.files) == sorted(data.files, key=lambda k: k.split("§"))
    template = jax.eval_shape(lambda: jstep.train_state_init(jax.random.PRNGKey(0), jcfg))
    restored = jckpt.restore(template, str(tmp_path / "t"))
    _close(state, restored, atol=0.0)
    back = ckpt.restore(train_state_shapes(cfg), str(tmp_path / "t"), device="cpu")
    _close(back, restored, atol=0.0)


def test_checkpoint_written_by_jax_restores_in_torch(tmp_path):
    cfg, jcfg = _cfgs("yi-9b")
    jstate = jstep.train_state_init(jax.random.PRNGKey(5), jcfg)
    jckpt.save(jstate, str(tmp_path), 3)
    state = ckpt.restore(train_state_shapes(cfg), str(tmp_path), device="cpu")
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert state["params"]["embed"].device.type == "cpu"
    _close(state, jstate, atol=0.0)


def test_checkpoint_prune_keep_and_missing(tmp_path):
    cfg = configs.get_smoke("mamba2-370m")
    state = train_state_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for s in range(5):
        ckpt.save(state, str(tmp_path), s, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4] == jckpt.all_steps(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(train_state_shapes(cfg), str(tmp_path / "none"), device="cpu")


def test_convert_moves_the_train_state_both_ways():
    cfg, jcfg = _cfgs("yi-9b", param_dtype="bfloat16")
    jstate = jstep.train_state_init(jax.random.PRNGKey(6), jcfg)
    state = to_torch(jax.tree.map(np.asarray, jstate), device="cpu")
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["m"]["embed"].dtype == torch.float32
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    back = to_numpy(state)
    _close(state, jstate, atol=0.0)
    assert back["step"].dtype == np.int32


# ---- the committed trainer --------------------------------------------------------


def test_committed_trainer_failover_exactly_once(tmp_path):
    """Identical training trajectory with and without a mid-run controller
    failure (Jointλ §4.1 + §4.2), on the port's LocalRunner copy."""
    cfg = configs.get_smoke("yi-9b").replace(remat="none")
    t1 = CommittedTrainer(cfg, seq_len=16, global_batch=2, ckpt_dir=str(tmp_path / "a"),
                          steps_per_chunk=4, device="cpu")
    r1 = t1.train(12)
    t2 = CommittedTrainer(cfg, seq_len=16, global_batch=2, ckpt_dir=str(tmp_path / "b"),
                          steps_per_chunk=4, device="cpu")
    r2 = t2.train(12, fail_primary_at_chunk=2)
    assert r1.step == r2.step == 12
    assert r1.loss == pytest.approx(r2.loss, abs=1e-4)
    assert [m["step"] for m in t1.metrics] == [m["step"] for m in t2.metrics] == [4, 8, 12]
    assert ckpt.all_steps(str(tmp_path / "b")) == [4, 8, 12]


def test_committed_trainer_matches_jax_from_one_checkpoint(tmp_path):
    """Seeds cannot be matched across frameworks, so both trainers start
    from the step-0 checkpoint that JAX wrote: fp32, chunk losses at rtol
    1e-4."""
    cfg, jcfg = _cfgs("yi-9b", compute_dtype="float32", remat="none")
    jckpt.save(jstep.train_state_init(jax.random.PRNGKey(7), jcfg), str(tmp_path / "j"), 0)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    kw = dict(seq_len=16, global_batch=2, steps_per_chunk=3, lr=1e-3)
    rj = JCommittedTrainer(jcfg, ckpt_dir=str(tmp_path / "j"), **kw)
    rt = CommittedTrainer(cfg, ckpt_dir=str(tmp_path / "t"), device="cpu", **kw)
    resj, rest = rj.train(9), rt.train(9)
    assert rest.step == resj.step == 9
    for a, b in zip(rt.metrics, rj.metrics):
        assert a["step"] == b["step"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)


def test_launch_train_refuses_a_missing_card(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "yi-9b", "--smoke"])
    assert launch_train.main(["--arch", "yi-9b", "--smoke", "--device", "cpu", "--steps", "4",
                              "--chunk", "2", "--seq-len", "16", "--batch", "2",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "done: step 4" in out and ckpt.all_steps(str(tmp_path)) == [2, 4]


def test_launch_train_runs_a_recurrent_arch_on_cpu(tmp_path, capsys):
    assert launch_train.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                              "--steps", "2", "--chunk", "2", "--seq-len", "32", "--batch", "2",
                              "--ckpt-dir", str(tmp_path)]) == 0
    assert "done: step 2" in capsys.readouterr().out and ckpt.all_steps(str(tmp_path)) == [2]


# ---- a raw kernel launch refuses a gradient it would drop ---------------------------


def test_refuse_grad_raises_only_when_a_gradient_is_needed():
    """Only flash's raw wrapper refuses now (its gradient goes through
    models.flash); the message says what to do instead, and nothing is
    refused without a gradient to lose."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no autograd history: use models.flash"):
        ops.refuse_grad("flash_attention", torch.ones(3), x, instead="use models.flash")
    ops.refuse_grad("flash_attention", torch.ones(3), instead="use models.flash")
    with torch.no_grad():
        ops.refuse_grad("flash_attention", x, instead="use models.flash")
    with pytest.raises(TypeError):
        ops.refuse_grad("flash_attention", x)       # the advice is required


def test_cpu_scans_stay_differentiable():
    """On the CPU the wrappers run the plain versions, which autograd sees."""
    rng = np.random.default_rng(0)
    log_a = torch.from_numpy(-rng.random((1, 64, 8)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((1, 64, 8)).astype(np.float32)).requires_grad_()
    ops.rglru_scan(log_a, b, block_l=64, block_w=8).sum().backward()
    assert log_a.grad.abs().sum() > 0 and b.grad.abs().sum() > 0
    x = torch.from_numpy(rng.standard_normal((1, 32, 2, 16)).astype(np.float32)).requires_grad_()
    dt = torch.full((1, 32, 2), 0.1)
    a = torch.tensor([-1.0, -2.0])
    bc = torch.from_numpy(rng.standard_normal((1, 32, 16)).astype(np.float32))
    ops.ssd_scan(x, dt, a, bc, bc, chunk=16).sum().backward()
    assert x.grad.abs().sum() > 0


def test_profile_train_on_cpu_reports_the_split_and_host_ops():
    from repro_torch.launch import profile_train
    r = profile_train.run("yi-9b", smoke=True, layers=2, batch=2, seq_len=64, device="cpu")
    assert r["device"] == "cpu" and r["layers"] == 2
    for key in ("forward_ms", "forward_backward_ms", "step_ms", "flash_bwd_ms", "optimizer_ms"):
        assert r[key] > 0, key
    assert r["traced_step"]["kernel_launches"] == 0 and r["traced_step"]["top_host_ops_ms"]


@pytest.mark.parametrize("arch,layers,backwards", [
    ("mamba2-370m", 0, ("ssd_scan_bwd_ms",)),
    ("recurrentgemma-9b", 3, ("flash_bwd_ms", "rglru_scan_bwd_ms"))])
def test_profile_train_on_cpu_times_each_recurrent_backward(arch, layers, backwards):
    """A recurrent arch gets its scan's backward timed alone (its explicit
    plain formulas on the CPU), and no FA2 timing without attention."""
    from repro_torch.launch import profile_train
    r = profile_train.run(arch, smoke=True, layers=layers, batch=1, seq_len=32, device="cpu")
    for key in ("forward_ms", "forward_backward_ms", "step_ms", "optimizer_ms") + backwards:
        assert r[key] > 0, key
    assert {k for k in r if k.endswith("_bwd_ms")} == set(backwards)
