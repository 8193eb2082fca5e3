"""The dry run's traced rank: one rank of a multi-device mesh on fake tensors.

``dryrun.run_cell(..., mesh="2x2x2")`` places the state or parameters, the
inputs and a decode cache as DTensors of fake local blocks under the rule
table, on a fake process group of 8 ranks, and traces the same sharded
steps the ranks of a real mesh run.  Held here:

* every smoke arch × {train, prefill, decode} on (2, 2, 2) (B 8, L 32): the
  argument bytes equal the rule table's (``dryrun.local_bytes``), the
  kernel operator calls equal the one-card trace's, a training step runs
  collectives, and no default process group is left behind; a rank's
  FLOPs × 8 equal the one-card trace's for the dense attention families
  and the RG-LRU family, and differ by named products for the others;
* the argument, output and alias bytes a device against the reference's
  compiled ``memory_analysis()`` (its dry run's own ``out_shardings``, 8
  host devices in a subprocess), each difference named;
* ``seq_shard`` lowering a rank's temporaries, as the reference's
  ``test_seq_shard_reduces_saved_activations`` shows;
* each mesh knob reaching the record, and the CLI taking it;
* full configs at 16x16 and 2x16x16 in a subprocess, in little memory.
"""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch.mesh import make_ctx, traced_mesh  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.parallel.sharding import (cache_shardings, input_shardings,  # noqa: E402
                                           param_shardings)
from repro_torch.train.step import train_state_shapes  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESH, B, L = "2x2x2", 8, 32
KINDS = ("train", "prefill", "decode")
REF_ARCHS = ("gemma2-27b", "mamba2-370m", "deepseek-moe-16b")
#: the archs compiled on (2, 3) too: a model axis of 3 divides none of
#: yi-9b smoke's split dims, and only the shared experts' width of
#: deepseek-moe-16b smoke (its 8 experts: the global dispatch)
UNDIVIDED_ARCHS = ("yi-9b", "deepseek-moe-16b")

#: the reference's sharded steps compiled as its dry run compiles them, on
#: (2, 2, 2) ("pod", "data", "model"): per device the argument, output and
#: alias bytes and the number of output leaves
REFERENCE = textwrap.dedent("""
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro import configs
    from repro.configs.shapes import ShapeSpec
    from repro.launch.mesh import make_ctx, make_mesh
    from repro.models import lm
    from repro.parallel.mesh_ctx import mesh_context
    from repro.parallel.sharding import (cache_shardings, input_shardings, param_shardings,
                                         safe_spec)
    from repro.serve.engine import make_decode_step, make_prefill_step
    from repro.train.step import make_train_step, train_state_shapes

    def bf16(tree):          # the reference dry run's _serve_dtype
        return jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.bfloat16 if jnp.issubdtype(s.dtype, jnp.floating) else s.dtype), tree)

    import numpy as np
    from jax.sharding import Mesh

    cells = [(make_mesh((2, 2, 2), ("pod", "data", "model")), arch) for arch in ARCHS]
    # the (2, 3) mesh on 6 of the 8 devices: a model axis of 3
    cells += [(Mesh(np.array(jax.devices()[:6]).reshape(2, 3), ("data", "model")), arch)
              for arch in UNDIVIDED_ARCHS]
    for mesh, arch in cells:
        ctx = make_ctx(mesh)
        cfg = configs.get_smoke(arch)
        for kind in ("train", "prefill", "decode"):
            shape = ShapeSpec("smoke", L, B, kind)
            with mesh_context(ctx):
                inputs = configs.input_specs(cfg, shape)
                if kind == "train":
                    state = train_state_shapes(cfg)
                    st_sh = param_shardings(state, ctx)
                    fn = make_train_step(cfg)
                    outs = jax.eval_shape(fn, state, inputs)
                    c = jax.jit(fn, in_shardings=(st_sh, input_shardings(ctx, inputs)),
                                out_shardings=(st_sh, None), donate_argnums=0
                                ).lower(state, inputs).compile()
                else:
                    params = bf16(lm.init_shapes(cfg))
                    p_sh = param_shardings(params, ctx)
                    if kind == "prefill":
                        fn = make_prefill_step(cfg, max_len=L)
                        outs = jax.eval_shape(fn, params, inputs)
                        l_sh = NamedSharding(mesh, safe_spec(
                            outs[1].shape, [tuple(ctx.batch_axes), ctx.model_axis], mesh))
                        c = jax.jit(fn, in_shardings=(p_sh, input_shardings(ctx, inputs)),
                                    out_shardings=(cache_shardings(outs[0], ctx), l_sh)
                                    ).lower(params, inputs).compile()
                    else:
                        cache = bf16(inputs["cache"])
                        c_sh = cache_shardings(cache, ctx)
                        fn = make_decode_step(cfg)
                        outs = jax.eval_shape(fn, params, inputs["token"], cache)
                        l_sh = NamedSharding(mesh, safe_spec(
                            outs[0].shape, [tuple(ctx.batch_axes), ctx.model_axis], mesh))
                        c = jax.jit(fn, in_shardings=(p_sh, input_shardings(ctx, inputs["token"]),
                                                      c_sh),
                                    out_shardings=(l_sh, c_sh), donate_argnums=2
                                    ).lower(params, inputs["token"], cache).compile()
            m = c.memory_analysis()
            print("MEM", "x".join(map(str, mesh.devices.shape)), arch, kind,
                  m.argument_size_in_bytes, m.output_size_in_bytes, m.alias_size_in_bytes,
                  len(jax.tree.leaves(outs)), flush=True)
""")


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's compiles, started when the module's first test starts
    so that they run beside the port's traces; read by the test that needs
    them (near the file's end)."""
    code = (f"ARCHS, UNDIVIDED_ARCHS, B, L = {REF_ARCHS!r}, {UNDIVIDED_ARCHS!r}, {B}, {L}\n"
            + REFERENCE)
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                                     XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _spec(kind: str, l: int = L, b: int = B) -> ShapeSpec:
    return ShapeSpec("smoke", l, b, kind)


def _arguments(cfg, spec: ShapeSpec, mesh: str, **knobs):
    """The step's arguments as ``meta`` templates of their global shapes,
    each with its specs under the rule table: [(tree, specs)]."""
    ctx = make_ctx(dryrun.mesh_sizes(mesh), **knobs)
    inputs = configs.input_specs(cfg, spec, device="meta")
    if spec.kind == "train":
        state = train_state_shapes(cfg)
        return [(state, param_shardings(state, ctx)), (inputs, input_shardings(ctx, inputs))]
    params = dryrun.serve_dtype(lm.init_shapes(cfg))
    if spec.kind == "prefill":
        return [(params, param_shardings(params, ctx)), (inputs, input_shardings(ctx, inputs))]
    cache = dryrun.serve_dtype(inputs["cache"])
    return [(params, param_shardings(params, ctx)),
            (inputs["token"], input_shardings(ctx, inputs["token"])),
            (cache, cache_shardings(cache, ctx))]


def _local_bytes(cfg, spec: ShapeSpec, mesh: str, **knobs) -> int:
    sizes = dryrun.mesh_sizes(mesh)
    return sum(dryrun.local_bytes(t, s, sizes) for t, s in _arguments(cfg, spec, mesh, **knobs))


def _calls(rec) -> dict:
    return {k: v["calls"] for k, v in rec["kernels"].items()}


def _whole_on_every_model_rank(cfg, spec: ShapeSpec, model: int) -> int:
    """FLOPs × devices a rank counts beyond the one-card trace: the products
    that the rule table leaves whole on every model rank, each computed
    ``model`` times over.  Mamba2: the B/C projections (``wb``, ``wc``
    replicated over model) and the SSD scan's C·Bᵀ term (shared by the
    heads), forward twice (remat "dots") and backward once in training;
    the VLM's patch projection ``w_patch`` and the enc-dec's frame
    projection ``w_frame``, forward and weight gradient in training (their
    inputs take no gradient)."""
    b, l, kind = spec.global_batch, spec.seq_len, spec.kind
    d, extra = cfg.d_model, 0
    if cfg.ssm is not None:
        _, _, _, n = ssm.dims(cfg)
        layers = sum(cfg.pattern_of(i) == "ssm" for i in range(cfg.n_layers))
        bc = 2 * b * (1 if kind == "decode" else l) * d * n * 2 * layers
        q = min(cfg.ssm.chunk, l)
        cb = 2 * b * (l // q) * (q * (q + 1) // 2) * n * layers
        extra = {"decode": bc, "prefill": bc + cb, "train": 3 * (bc + cb)}[kind]
    prefix = cfg.n_patches if cfg.n_patches else (
        configs.input_specs(cfg, spec, device="meta")["frames"].shape[1]
        if cfg.frame_input and kind != "decode" else 0)
    if prefix and kind != "decode":
        extra += (2 if kind == "train" else 1) * 2 * b * prefix * 1024 * d
    return (model - 1) * extra


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_smoke_arch_traces_a_rank(arch, kind):
    """A rank of (2, 2, 2): the rule table's argument bytes, the one-card
    trace's kernel operator calls, collectives in a training step, FLOPs ×
    8 against the one-card trace's, and no process group left behind.  The
    MoE family counts fewer: a rank's expert capacity rounds to 8
    (``moe.apply_blocks``), the one-card layer's to 128 (``moe.apply_ref``),
    so the experts' products run on fewer padded slots (ROADMAP Queue 3 d)."""
    cfg = configs.get_smoke(arch)
    spec = _spec(kind)
    one = dryrun.run_cell(cfg, spec, verbose=False)
    rec = dryrun.run_cell(cfg, spec, mesh=MESH, verbose=False)
    assert not dist.is_initialized()
    assert rec["ok"] and rec["devices"] == 8 and rec["fits"]
    m = rec["memory"]
    assert m["argument_bytes"] == _local_bytes(cfg, spec, MESH) > 0
    assert m["peak_bytes"] == m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"] \
        - m["alias_bytes"] + m["workspace_bytes"]
    assert _calls(rec) == _calls(one)
    c = rec["cost"]
    if kind == "train":
        assert c["wire_bytes"] > 0 and c["gloo_calls"] > 0
        assert c["collective_ops"]["reduce-scatter"] > 0
    assert c["wire_bytes"] == rec["roofline"]["wire_bytes"]
    assert rec["roofline"]["collective_s"] == pytest.approx(c["wire_bytes"] / ha.NVLINK_BW)
    assert rec["model_flops_per_device"] == one["model_flops"] / 8
    extra = c["flops"] * 8 - one["cost"]["flops"]
    if cfg.moe is not None:
        assert extra < 0
    else:
        assert extra == _whole_on_every_model_rank(cfg, spec, 2)


def test_seq_shard_reduces_saved_activations():
    """The reference's cell (yi-9b smoke, remat "full", (2, 4) data × model,
    B 8, L 64): sequence-sharding the block boundaries lowers a rank's
    temporaries, and adds sequence gathers."""
    cfg = configs.get_smoke("yi-9b").replace(remat="full")
    spec = _spec("train", l=64)
    base = dryrun.run_cell(cfg, spec, mesh="2x4", verbose=False)
    seq = dryrun.run_cell(cfg, spec, mesh="2x4", overrides={"seq_shard": True}, verbose=False)
    assert seq["memory"]["temp_bytes"] < base["memory"]["temp_bytes"]
    assert seq["memory"]["argument_bytes"] == base["memory"]["argument_bytes"]
    assert seq["cost"]["collective_ops"]["all-gather"] > base["cost"]["collective_ops"]["all-gather"]
    assert seq["variant"] == "seq_shard=True"


@pytest.mark.parametrize("knob,kind,mesh", [("fsdp_over_pod", "train", "2x2x2"),
                                            ("seq_shard", "prefill", "2x4"),
                                            ("shard_kv_seq", "decode", "2x4")])
def test_every_mesh_knob_changes_the_record(knob, kind, mesh):
    """Each knob reaches the traced rank: ``fsdp_over_pod`` the parameters'
    blocks (the rule table's bytes under it), ``seq_shard`` the prefill's
    collectives, ``shard_kv_seq`` the decode cache's layout and the
    collectives reading it; the CLI takes each, and refuses it at one card."""
    cfg = configs.get_smoke("yi-9b")
    spec = _spec(kind)
    base = dryrun.run_cell(cfg, spec, mesh=mesh, verbose=False)
    var = dryrun.run_cell(cfg, spec, mesh=mesh, overrides={knob: True}, verbose=False)
    assert var["ok"] and var["variant"] == f"{knob}=True"
    assert var["cost"]["collective_ops"] != base["cost"]["collective_ops"]
    knobs = {"fsdp_over_pod": True} if knob == "fsdp_over_pod" else {}
    assert var["memory"]["argument_bytes"] == _local_bytes(cfg, spec, mesh, **knobs)
    if knob == "fsdp_over_pod":
        assert var["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]
    flag = "--" + knob.replace("_", "-")
    args = dryrun._parser().parse_args(["--arch", "yi-9b", "--shape", "train_4k",
                                        "--mesh", "16x16", flag])
    assert dryrun._overrides(args)[knob] is True
    assert flag in dryrun._cell_cmd(args, "yi-9b", "train_4k")
    with pytest.raises(ValueError, match="multi-device mesh"):
        dryrun.run_cell(cfg, spec, overrides={knob: True})


def test_refused_cell_is_a_failed_record():
    """``seq_shard`` on a sequence the model axis does not cut (L 32 over
    3): the record carries ``check_sharded``'s error, as the reference
    records a cell that fails to compile; the process group is gone."""
    rec = dryrun.run_cell(configs.get_smoke("yi-9b"), _spec("prefill"), mesh="2x3",
                          overrides={"seq_shard": True}, verbose=False)
    assert rec["ok"] is False and rec["devices"] == 6
    assert rec["error"].startswith("ValueError") and "model axis (3)" in rec["error"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", KINDS)
def test_undivided_mesh_traces_a_rank(kind):
    """yi-9b smoke on 2x3, whose model axis of 3 divides none of its split
    dims: the cell traces (the rule table's guard leaves the vocab, d_ff and
    the heads whole) with the rule table's argument bytes, every kernel
    operator called as on one card, and a rank's FLOPs × 6 three times the
    one-card trace's for every product over the model axis: a rank
    computes them whole, as each of its 3 model ranks does."""
    cfg = configs.get_smoke("yi-9b")
    spec = _spec(kind)
    one = dryrun.run_cell(cfg, spec, verbose=False)
    rec = dryrun.run_cell(cfg, spec, mesh="2x3", verbose=False)
    assert rec["ok"] and rec["devices"] == 6 and not dist.is_initialized()
    assert rec["memory"]["argument_bytes"] == _local_bytes(cfg, spec, "2x3") > 0
    assert _calls(rec) == _calls(one)
    assert rec["cost"]["flops"] * 6 == pytest.approx(3 * one["cost"]["flops"], rel=1e-6)


def test_cache_specs_allocate_nothing_in_a_trace():
    """The sharded prefill reads its cache's layout from a template of the
    global cache; in a trace that template is no allocation of the rank
    (yi-9b's prefill_32k on 16x16 counted its 103 GB rings as the rank's
    peak)."""
    cfg = configs.get_smoke("yi-9b")
    ctx = make_ctx(dryrun.mesh_sizes(MESH))
    with FakeTensorMode(), op_cost.OpCounter() as counter:
        specs = lm.cache_specs(cfg, B, 4096, ctx)
    assert (counter.peak, counter.ops) == (0, 0)
    assert specs == cache_shardings(lm.init_cache(cfg, B, 4096, device="meta"), ctx)


def test_traced_mesh_owns_its_group():
    """The fake group lives for the block, even one that raises, and a
    process with a group of its own is refused."""
    with pytest.raises(KeyError):
        with traced_mesh({"data": 16, "model": 16}) as mesh:
            assert dist.is_initialized() and dist.get_world_size() == 256
            assert mesh.get_group("model").size() == 16 and mesh.get_local_rank("data") == 0
            raise KeyError("inside")
    assert not dist.is_initialized()
    with traced_mesh({"data": 2}):
        with pytest.raises(RuntimeError, match="default process group"):
            with traced_mesh({"data": 2}):
                pass
    assert not dist.is_initialized()


def test_full_configs_trace_a_rank_in_little_memory():
    """Full configs in a fresh process: yi-9b's prefill_32k on 16x16 and
    gemma2-27b's decode_32k on 2x16x16 with FSDP over (pod, data) and the
    rings' slots over model (each traces in seconds here).  The trace holds
    no data, so max RSS rises by less than 1 GB; a rank holds 1/256 or
    1/512 of the model FLOPs."""
    code = textwrap.dedent("""
        import resource, torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.launch import dryrun
        r0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        a = dryrun.run_cell("yi-9b", "prefill_32k", mesh="16x16", verbose=False)
        b = dryrun.run_cell("gemma2-27b", "decode_32k", mesh="2x16x16", verbose=False,
                            overrides={"fsdp_over_pod": True, "shard_kv_seq": True})
        rise = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - r0
        for r in (a, b):
            assert r["ok"] and r["cost"]["wire_bytes"] > 0, r
            assert r["model_flops_per_device"] * r["devices"] == r["model_flops"]
        print("RISE_KB", rise, a["devices"], b["devices"], a["fits"], b["fits"],
              dist.is_initialized())
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=SRC), timeout=600)
    assert "RISE_KB" in r.stdout, r.stderr[-3000:]
    _, rise_kb, n_a, n_b, fits_a, fits_b, group = r.stdout.split()[-7:]
    assert int(rise_kb) < 1 << 20
    assert (n_a, n_b, group) == ("256", "512", "False")
    assert (fits_a, fits_b) == ("True", "True")


def test_rank_memory_matches_the_reference(reference):
    """At (2, 2, 2), B 8, L 32, gemma2-27b, mamba2-370m and deepseek-moe-16b
    smoke: a rank's argument, output and alias bytes against the
    reference's compiled ``memory_analysis()`` with its dry run's
    ``out_shardings``.  The differences, each named:

    * a decode cache's ``pos``: an int32 scalar there (4 bytes on every
      device, an argument, an output and aliased), a Python int here;
    * XLA's output is one tuple, whose index table counts 8 bytes a leaf;
    * the reference donates the training state (``donate_argnums=0``), so
      its output aliases it; the port's step writes a new state;
    * Mamba2's decode: the reference's returns the SSM state ``h`` in fp32,
      a new buffer beside the bf16 one the dry run's serving dtype gives it
      (twice its bytes, not aliased), where the port writes ``h`` into the
      bf16 cache in place."""
    out, err = _reference_rows(reference)
    rows = [r for r in out if r[0] == "2x2x2"]
    assert len(rows) == 3 * len(REF_ARCHS), err[-3000:]
    _hold_against_the_reference(rows)


def _reference_rows(reference):
    """The reference's MEM rows (mesh, arch, kind, argument, output, alias
    bytes, output leaves), read once, and its errors."""
    if not hasattr(reference, "rows"):
        out, err = reference.communicate(timeout=900)
        reference.rows = ([line.split()[1:] for line in out.splitlines()
                           if line.startswith("MEM ")], err)
    return reference.rows


def _hold_against_the_reference(rows):
    """Each row's cell traced on its mesh, its argument, output and alias
    bytes against the reference's with the differences named in
    :func:`test_rank_memory_matches_the_reference`."""
    for mesh, arch, kind, arg, output, alias, leaves in rows:
        cfg = configs.get_smoke(arch)
        spec = _spec(kind)
        rec = dryrun.run_cell(cfg, spec, mesh=mesh, verbose=False)
        m = rec["memory"]
        pos = 4 if kind == "decode" else 0
        state = m["argument_bytes"] - dryrun.local_bytes(
            *_arguments(cfg, spec, mesh)[1], dryrun.mesh_sizes(mesh)) if kind == "train" else 0
        h = 0
        if arch == "mamba2-370m" and kind == "decode":
            cache, specs = _arguments(cfg, spec, mesh)[2]
            h = dryrun.local_bytes(cache["blocks"]["s0"]["h"], specs["blocks"]["s0"]["h"],
                                   dryrun.mesh_sizes(mesh))
        assert (int(arg), int(output), int(alias)) == (
            m["argument_bytes"] + pos,
            m["output_bytes"] + 8 * int(leaves) + (4 if kind != "train" else 0) + h,
            m["alias_bytes"] + state + pos - h), (mesh, arch, kind)


def test_undivided_rank_memory_matches_the_reference(reference):
    """:func:`test_rank_memory_matches_the_reference` on 2x3 (6 of the
    reference's 8 host devices), yi-9b and deepseek-moe-16b smoke: the
    leaves the rule table's guard leaves whole count whole on each rank, on
    both sides."""
    out, err = _reference_rows(reference)
    rows = [r for r in out if r[0] == "2x3"]
    assert len(rows) == 3 * len(UNDIVIDED_ARCHS), err[-3000:]
    _hold_against_the_reference(rows)


def test_report_tables_the_records(tmp_path):
    """``--report`` prints one row a cell of the registry and a group of
    columns a mesh: a traced record's numbers, a refused or missing
    record's reason, and below the table the cells skipped at every mesh."""
    out = str(tmp_path / "d.json")
    rec = {"arch": "yi-9b", "shape": "train_4k", "mesh": "16x16", "variant": "baseline",
           "skip": None, "ok": True, "fits": True, "trace_s": 12.5,
           "memory": {"peak_bytes": 40e9},
           "roofline": {"flops": 3e15, "model_flops_per_device": 2e15, "wire_bytes": 5e9,
                        "dominant": "compute"}}
    dryrun.save_record(rec, out)
    dryrun.save_record({**rec, "mesh": "2x16x16", "fits": False}, out)
    dryrun.save_record({**rec, "shape": "prefill_32k", "ok": False,
                        "error": "NotImplementedError: x"}, out)
    for mesh in ("16x16", "2x16x16"):
        dryrun.save_record({"arch": "yi-9b", "shape": "long_500k", "mesh": mesh,
                            "variant": "baseline", "skip": "too long"}, out)
    table = dryrun.report(out, ["16x16", "2x16x16"]).splitlines()
    assert len(table) == 2 + len(list(configs.all_cells())) - 1 + 2
    assert ("| yi-9b | train_4k | 40.00 | True | 1.500 | 5.00 | compute | 12.5 | "
            "40.00 | False | 1.500 | 5.00 | compute | 12.5 |") in table
    assert ("| yi-9b | prefill_32k | refused: NotImplementedError: x | | | | | | "
            "not run | | | | | |") in table
    assert table[-1] == "Skipped at every mesh: yi-9b × long_500k."
    assert dryrun._parser().parse_args(["--report", "16x16", "2x16x16"]).report == \
        ["16x16", "2x16x16"]
