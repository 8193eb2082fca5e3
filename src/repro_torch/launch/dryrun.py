"""Dry run: trace every (architecture × shape) step on fake tensors.

The twin of :mod:`repro.launch.dryrun`.  A cell at ``--mesh 1`` (one card)
builds the state or parameters and the inputs as fake tensors of the card
(``FakeTensorMode``: no memory, nothing launched) and runs
``make_train_step``, ``make_prefill_step(max_len=seq_len)`` or
``make_decode_step`` once under :func:`repro_torch.launch.op_cost.count`:

    with FakeTensorMode():
        state = fake(train_state_shapes(cfg)); batch = input_specs(cfg, shape)
        out, cost = op_cost.count(make_train_step(cfg), state, batch)

The record holds the memory (arguments, outputs, temporaries, aliases,
the cuBLAS workspaces and the peak, ``peak = args + outputs + temps −
alias + workspaces``: the reference's sum and the one allocation the trace
cannot see, :func:`workspace_bytes`), the cost (FLOPs, bytes, ops dispatched, each kernel's share),
the trace's seconds, the roofline terms against ``model_flops`` and
whether the peak fits the card.  Serving weights are bf16, as in the
reference.  Records accumulate in a JSON keyed by (arch, shape, mesh,
variant); ``python benchmarks/roofline.py --path results/dryrun_torch.json
--mesh 1`` prints their table.

The fake device is ``cuda`` where torch is built with CUDA.  A torch built
without it has no CUDA device guard, so autograd on a fake CUDA tensor
cannot run; there the fake tensors live on the ``meta`` device, which the
kernel wrappers take as the card's (:func:`repro_torch.kernels.library.on_card`).

At a multi-device mesh (``16x16``, ``2x16x16`` or a reduced one such as
``2x2x2``) the cell traces one rank, rank 0, of that mesh.  The process
owns, for the length of the call, a fake process group of the mesh's world
size (:func:`repro_torch.launch.mesh.traced_mesh`: its collectives move
nothing).  The state or parameters, the inputs and a decode cache are
placed by the rule table (``param_shardings``, ``input_shardings``,
``cache_shardings``) as DTensors whose blocks are fake tensors of the
rank's local shapes, and the same steps run their sharded paths on them,
as on the ranks of a real mesh.  The record holds what a one-card record
holds, for one device, and each collective by its logical kind
(all-gather, reduce-scatter, all-reduce) with its wire bytes by the ring
model, the ``collective`` roofline term at ``NVLINK_BW``, the gloo
all-reduces that emulate the collectives on the port's ranks, and
``model_flops / devices``.  ``--fsdp-over-pod``, ``--seq-shard`` and
``--shard-kv-seq`` set the mesh context's knobs, as the reference's do.
A cell that :func:`repro_torch.models.lm.check_sharded` refuses (under
``--seq-shard``, a sequence the model axis does not cut) is a record with
``ok`` False and the ``error``; a model axis that does not divide a split
dim traces, its leaves whole as the rule table's guard leaves them.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-9b --shape prefill_32k --mesh 1
    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh 16x16 [--seq-shard]
    python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k --multi-pod \
        [--fsdp-over-pod] [--shard-kv-seq]
    python -m repro_torch.launch.dryrun --all [--mesh 1] [--out results/dryrun_torch.json]
    (variants: --remat full --gather-dtype bfloat16 --microbatches 4)
    python -m repro_torch.launch.dryrun --report 16x16 2x16x16 --out results/dryrun_torch.json
    (a markdown table of the records at those meshes: peak, fits, FLOPs
    against model_flops, wire bytes, the dominant term, trace seconds)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_ctx, traced_mesh
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig, tree_map
from repro_torch.parallel.mesh_ctx import MeshCtx, mesh_context
from repro_torch.parallel.sharding import (cache_shardings, empty_blocks, input_shardings,
                                           param_shardings)
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.step import make_train_step, train_state_shapes

DEFAULT_OUT = "results/dryrun_torch.json"

#: the knobs of the mesh context, which only a multi-device mesh reads
MESH_KNOBS = ("fsdp_over_pod", "seq_shard", "shard_kv_seq")


def fake_device() -> str:
    """The device the fake tensors stand on: ``cuda``, or ``meta`` where
    torch is built without CUDA."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def workspace_bytes(kind: str) -> int:
    """The cuBLAS workspaces a step of ``kind`` allocates on the card, which
    no op reports: one for each thread that runs products, the caller's and,
    in a training step, autograd's device thread, which runs the backward."""
    return (2 if kind == "train" else 1) * ha.CUBLAS_WORKSPACE_BYTES


def serve_dtype(tree, dtype=torch.bfloat16):
    """Serving weights are stored bf16 (standard practice): every floating
    leaf cast to ``dtype``; leaves that are not tensors pass."""
    return tree_map(lambda t: t.to(dtype) if isinstance(t, torch.Tensor) and t.is_floating_point()
                    else t, tree)


def materialize(tree, device):
    """Empty tensors of ``tree``'s shapes and dtypes on ``device`` (inside a
    ``FakeTensorMode``: fake ones); leaves that are not tensors pass."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
                    if isinstance(t, torch.Tensor) else t, tree)


def _apply_overrides(cfg: ModelConfig, ov: Dict[str, Any]) -> ModelConfig:
    fields = {k: v for k, v in ov.items() if v is not None and k in
              ("remat", "gather_dtype")}
    return cfg.replace(**fields) if fields else cfg


def variant_key(ov: Dict[str, Any]) -> str:
    parts = [f"{k}={v}" for k, v in sorted(ov.items())
             if v not in (None, False) and k != "out"]
    return ",".join(parts) or "baseline"


def mesh_sizes(mesh: str) -> Dict[str, int]:
    """``"16x16"`` → data × model, ``"2x16x16"`` → pod × data × model."""
    sizes = [int(n) for n in mesh.split("x")]
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(sizes))
    if axes is None:
        raise ValueError(f"mesh {mesh!r}: expected 1, AxB or AxBxC")
    return dict(zip(axes, sizes))


def local_bytes(tree, specs, sizes: Dict[str, int]) -> int:
    """One device's bytes of ``tree`` laid out by ``specs``: each leaf's
    local shape, every sharded dim divided by the product of its axes.  The
    rule table's count, which a traced rank's argument bytes equal."""
    if isinstance(tree, dict):
        return sum(local_bytes(v, specs[k], sizes) for k, v in tree.items())
    if not isinstance(tree, torch.Tensor):
        return 0                                # a cache's pos: a Python int
    n = tree.element_size()
    for dim, entry in zip(tree.shape, specs):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        div = 1
        for a in axes:
            div *= sizes[a]
        n *= dim // div
    return n


def _cell(arch_or_cfg, shape_or_spec):
    cfg = configs.get(arch_or_cfg) if isinstance(arch_or_cfg, str) else arch_or_cfg
    shape = SHAPES[shape_or_spec] if isinstance(shape_or_spec, str) else shape_or_spec
    skip = (configs.skip_reason(arch_or_cfg, shape.name)
            if isinstance(arch_or_cfg, str) and shape.name in SHAPES else None)
    return cfg, shape, skip


def _template(cfg: ModelConfig, shape: ShapeSpec):
    """The train state or the bf16 serving parameters on the ``meta``
    device (built outside a fake mode: the initializers draw from a CPU
    generator)."""
    if shape.kind == "train":
        return train_state_shapes(cfg)
    return serve_dtype(lm.init_shapes(cfg))


def _step(cfg: ModelConfig, shape: ShapeSpec, template, device, overrides: Dict[str, Any],
          ctx: Optional[MeshCtx] = None):
    """(the step function, its arguments) on ``device``, from the template:
    whole tensors, or under ``ctx`` the rank's blocks as DTensors placed by
    the rule table."""
    def place(tree, rule):
        if ctx is None:
            return materialize(tree, device)
        return empty_blocks(tree, rule(tree, ctx), ctx, device)

    def by_batch(tree, ctx):
        return input_shardings(ctx, tree)

    params = place(template, param_shardings)
    inputs = configs.input_specs(cfg, shape, device=device)
    if shape.kind == "train":
        step = make_train_step(cfg, microbatches=int(overrides.get("microbatches") or 1))
        return step, (params, place(inputs, by_batch))
    if shape.kind == "prefill":
        return make_prefill_step(cfg, max_len=shape.seq_len), (params, place(inputs, by_batch))
    cache = place(serve_dtype(inputs["cache"]), cache_shardings)
    return make_decode_step(cfg), (params, place(inputs["token"], by_batch), cache)


def trace(cfg: ModelConfig, shape: ShapeSpec, *, overrides: Optional[Dict[str, Any]] = None,
          device: Optional[str] = None, ctx: Optional[MeshCtx] = None) -> Dict[str, Any]:
    """One step of ``cfg`` at ``shape`` on fake tensors: the memory, cost
    and roofline parts of a record.  Under ``ctx`` (a context on a
    :func:`~repro_torch.launch.mesh.traced_mesh`), one rank's step on its
    blocks, per device."""
    overrides = overrides or {}
    device = device or fake_device()
    t0 = time.perf_counter()
    template = _template(cfg, shape)
    with FakeTensorMode():
        fn, args = _step(cfg, shape, template, device, overrides, ctx)
        ins = op_cost.storages(args)
        with mesh_context(ctx):
            out, cost = op_cost.count(fn, *args)
        outs = op_cost.storages(out)
        del out, args, fn
    arg_bytes, out_bytes = sum(ins.values()), sum(outs.values())
    alias = sum(n for key, n in outs.items() if key in ins)
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": cost.peak_bytes - (out_bytes - alias), "code_bytes": 0,
           "alias_bytes": alias, "workspace_bytes": workspace_bytes(shape.kind)}
    mem["peak_bytes"] = (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
                         - mem["alias_bytes"] + mem["workspace_bytes"])
    mf = ha.model_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
    n_dev = 1 if ctx is None else math.prod(ctx.shape.values())
    rl = ha.roofline_terms({"flops": cost.flops, "bytes accessed": cost.bytes_accessed},
                           wire_bytes=cost.wire_bytes, model_flops_per_device=mf / n_dev)
    kernels = {name: c for name, c in cost.by_op.items() if name.startswith("repro_torch.")}
    return {"device": device, "devices": n_dev, "memory": mem, "cost": cost.as_dict(),
            "ops": cost.ops, "ops_by_name": {name: c["calls"] for name, c in cost.by_op.items()},
            "kernels": kernels, "trace_s": time.perf_counter() - t0, "model_flops": mf,
            "model_flops_per_device": mf / n_dev, "roofline": rl.as_dict(),
            "fits": mem["peak_bytes"] <= ha.HBM_BYTES, "hbm_bytes": ha.HBM_BYTES}


def _check_sharded(cfg: ModelConfig, shape: ShapeSpec, ctx: MeshCtx) -> None:
    """``lm.check_sharded`` as the cell's step calls it."""
    if shape.kind == "decode":
        lm.check_sharded(cfg, ctx)
        return
    inputs = configs.input_specs(cfg, shape, device="meta")
    lm.check_sharded(cfg, ctx, seq_len=shape.seq_len, patches=inputs.get("patches"),
                     frames=inputs.get("frames"))


def run_cell(arch_or_cfg: Union[str, ModelConfig], shape_or_spec: Union[str, ShapeSpec], *,
             mesh: str = "1", overrides: Optional[Dict[str, Any]] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell's record.  ``arch_or_cfg`` is an arch of the registry or a
    ``ModelConfig``; ``shape_or_spec`` a shape name or a ``ShapeSpec``."""
    overrides = overrides or {}
    knobs = [k for k in MESH_KNOBS if overrides.get(k)]
    if knobs and mesh == "1":
        raise ValueError(f"{knobs} set a multi-device mesh's context: give a mesh other than 1")
    cfg, shape, skip = _cell(arch_or_cfg, shape_or_spec)
    cfg = _apply_overrides(cfg, overrides)
    rec: Dict[str, Any] = {
        "arch": cfg.name if isinstance(arch_or_cfg, ModelConfig) else arch_or_cfg,
        "shape": shape.name, "mesh": mesh, "kind": shape.kind,
        "variant": variant_key(overrides), "skip": skip}
    if skip:
        return rec
    if mesh == "1":
        rec.update(trace(cfg, shape, overrides=overrides))
    else:
        with traced_mesh(mesh_sizes(mesh)) as dmesh:
            ctx = make_ctx(dmesh, fsdp_over_pod=bool(overrides.get("fsdp_over_pod")),
                           seq_shard_activations=bool(overrides.get("seq_shard")),
                           shard_kv_seq=bool(overrides.get("shard_kv_seq")))
            try:
                _check_sharded(cfg, shape, ctx)
            except ValueError as e:
                rec.update(devices=dmesh.size(), ok=False, error=f"{type(e).__name__}: {e}")
                return rec
            rec.update(trace(cfg, shape, overrides=overrides, ctx=ctx))
    rec["ok"] = True
    if verbose:
        m, c = rec["memory"], rec["cost"]
        print(f"[dryrun] memory {m}; flops {c['flops']:.4e}, bytes {c['bytes_accessed']:.4e}, "
              f"wire {c['wire_bytes']:.4e} ({c['collective_ops']}), ops {c['ops']}; "
              f"trace {rec['trace_s']:.2f}s")
    return rec


# ==========================================================================
# Results store
# ==========================================================================


def record_key(rec: Dict[str, Any]) -> str:
    return f"{rec['arch']}|{rec['shape']}|{rec['mesh']}|{rec.get('variant','baseline')}"


def save_record(rec: Dict[str, Any], out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    data = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            data = json.load(f)
    data[record_key(rec)] = rec
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, out_path)


# ==========================================================================
# CLI
# ==========================================================================


def _parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=list(configs.ARCHS))
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--mesh", default="1",
                   help="1 (one card, traced), 16x16, 2x16x16 or a reduced AxB / AxBxC")
    p.add_argument("--multi-pod", action="store_true", help="the same as --mesh 2x16x16")
    p.add_argument("--all", action="store_true",
                   help="sweep every (arch × shape) as subprocesses")
    p.add_argument("--report", nargs="+", metavar="MESH",
                   help="print the records of --out at these meshes as a markdown table")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--timeout", type=int, default=3000)
    p.add_argument("--remat", choices=["none", "dots", "full"])
    p.add_argument("--gather-dtype", dest="gather_dtype", choices=["bfloat16"])
    p.add_argument("--microbatches", type=int)
    p.add_argument("--fsdp-over-pod", dest="fsdp_over_pod", action="store_true",
                   help="parameters FSDP-sharded over pod and data (a mesh with a pod axis)")
    p.add_argument("--seq-shard", dest="seq_shard", action="store_true",
                   help="sequence-shard block-boundary activations over model")
    p.add_argument("--shard-kv-seq", dest="shard_kv_seq", action="store_true",
                   help="flash-decoding: shard KV rings over model on S")
    return p


def _overrides(args) -> Dict[str, Any]:
    return {k: getattr(args, k) for k in
            ("remat", "gather_dtype", "microbatches", "fsdp_over_pod",
             "seq_shard", "shard_kv_seq")}


def _mesh(args) -> str:
    return "2x16x16" if args.multi_pod else args.mesh


def _cell_cmd(args, arch: str, shape: str) -> list:
    """The command that runs one cell of ``--all`` with the sweep's mesh,
    variants and knobs."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", args.out, "--mesh", _mesh(args)]
    for flag, val in (("--remat", args.remat),
                      ("--gather-dtype", args.gather_dtype),
                      ("--microbatches", args.microbatches)):
        if val:
            cmd += [flag, str(val)]
    return cmd + ["--" + k.replace("_", "-") for k in MESH_KNOBS if getattr(args, k)]


def report(path: str, meshes, variant: str = "baseline") -> str:
    """A markdown table of the records of ``path``, a row a cell and a group
    of columns a mesh of ``meshes``: the peak (GB a device), whether it
    fits, the FLOPs over ``model_flops`` a device, the wire bytes (GB), the
    dominant roofline term and the trace's seconds; a refused or missing
    record says so, and the cells skipped at every mesh are listed below."""
    with open(path) as f:
        data = json.load(f)
    cols = "peak GB | fits | FLOPs / model_flops | wire GB | dominant | trace s"
    rows = ["| arch | shape | " + " | ".join(f"{m}: {cols}" for m in meshes) + " |",
            "|---|---|" + "---|" * 6 * len(meshes)]
    skipped = []
    for arch, shape in configs.all_cells():
        recs = [data.get(f"{arch}|{shape}|{m}|{variant}") for m in meshes]
        if all(r is not None and r.get("skip") for r in recs):
            skipped.append(f"{arch} × {shape}")
            continue
        cells = []
        for r in recs:
            if r is None or r.get("skip") or not r.get("ok"):
                why = ("not run" if r is None else "skipped" if r.get("skip")
                       else f"refused: {r['error']}")
                cells.append(why + " |" * 5)
                continue
            rl = r["roofline"]
            cells.append(f"{r['memory']['peak_bytes'] / 1e9:.2f} | {r['fits']} | "
                         f"{rl['flops'] / rl['model_flops_per_device']:.3f} | "
                         f"{rl['wire_bytes'] / 1e9:.2f} | {rl['dominant']} | "
                         f"{r['trace_s']:.1f}")
        rows.append(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    if skipped:
        rows.append("")
        rows.append("Skipped at every mesh: " + ", ".join(skipped) + ".")
    return "\n".join(rows)


def sweep(args) -> int:
    failures = 0
    mesh = _mesh(args)
    for arch, shape in configs.all_cells():
        if configs.skip_reason(arch, shape):
            save_record({"arch": arch, "shape": shape, "mesh": mesh,
                         "kind": SHAPES[shape].kind, "variant": "baseline",
                         "skip": configs.skip_reason(arch, shape)}, args.out)
            print(f"[skip] {arch} × {shape}: {configs.skip_reason(arch, shape)}")
            continue
        t0 = time.time()
        r = subprocess.run(_cell_cmd(args, arch, shape), capture_output=True, text=True,
                           timeout=args.timeout)
        ok = r.returncode == 0
        failures += (not ok)
        print(f"[{'ok' if ok else 'FAIL'}] {arch} × {shape} ({time.time()-t0:.0f}s)")
        if not ok:
            print(r.stdout[-2000:])
            print(r.stderr[-4000:])
    return failures


def main() -> int:
    parser = _parser()
    args = parser.parse_args()
    knobs = [k for k in MESH_KNOBS if getattr(args, k)]
    if knobs and _mesh(args) == "1":
        parser.error(f"{', '.join('--' + k.replace('_', '-') for k in knobs)} set a "
                     f"multi-device mesh's context: give --mesh AxB or AxBxC, or --multi-pod")
    if args.report:
        print(report(args.out, args.report))
        return 0
    if args.all:
        return sweep(args)
    if not (args.arch and args.shape):
        parser.error("--arch and --shape required (or --all)")
    mesh = _mesh(args)
    try:
        rec = run_cell(args.arch, args.shape, mesh=mesh, overrides=_overrides(args))
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh,
               "kind": SHAPES[args.shape].kind, "variant": variant_key(_overrides(args)),
               "ok": False, "error": traceback.format_exc(limit=20)}
        save_record(rec, args.out)
        print(rec["error"])
        return 1
    save_record(rec, args.out)
    if rec.get("skip"):
        print(f"skipped: {rec['skip']}")
    elif not rec["ok"]:
        print(f"{args.arch} × {args.shape} on {mesh}: refused: {rec['error']}")
        return 1
    else:
        rl = rec["roofline"]
        where = ("one card" if mesh == "1" else
                 f"one rank of {mesh} ({rec['devices']} devices)")
        print(f"{args.arch} × {args.shape} on {where} [{rec['variant']}]: "
              f"compute {rl['compute_s']*1e3:.2f}ms | memory {rl['memory_s']*1e3:.2f}ms | "
              f"collective {rl['collective_s']*1e3:.2f}ms ({rl['wire_bytes']:.4e} wire bytes) "
              f"→ {rl['dominant']}-bound; peak {rec['memory']['peak_bytes']/2**30:.2f} GiB "
              f"(fits {rec['fits']}); {rec['ops']} ops; roofline fraction "
              f"{rl['roofline_fraction']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
