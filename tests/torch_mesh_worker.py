"""Rank worker of ``test_torch_mesh.py``: the distributed branches of the
port on a gloo process group of CPU processes.

    python tests/torch_mesh_worker.py <dir> <n_data> <n_model> <device> <tasks>

starts n_data·n_model ranks (``spawn``) on ``device`` (``cpu``, or
``cuda``: every rank on the card ``rank % device_count()``), which meet
through a file under ``<dir>``, form a gloo ``("data", "model")`` mesh and
run the comma-separated ``tasks``, each on the global inputs the test wrote
to ``<dir>/inputs.npz``:

* ``ep``: ``moe.apply`` under a mesh context (so ``apply_ep``) for every
  MoE case ``<dtype>-<kind>``; kind ``nodrop`` runs the configuration of
  ``parallel.ref.no_drop``;
* ``decode``: yi-9b smoke prefill and greedy decode, plain and with the
  cache placed by ``cache_shardings(shard_kv_seq=True)`` (so
  ``_decode_seqshard``), in bf16 and fp32;
* ``restore``: ``checkpoint.restore(shardings=...)`` of ``<dir>/ckpt``
  onto the mesh;
* ``grad``: deepseek-moe-16b smoke's ``lm.loss_fn`` under the mesh context
  with parameters that need a gradient, which ``apply_ep`` refuses.

``restore`` gathers DTensors (``full_tensor``, a redistribution), which
gloo does only for CPU tensors.  Each rank writes
``<dir>/rank<r>.npz``.  Imports no JAX.
"""

import os
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: greedy decode steps after the first; the prompt; the rings' slots
DECODE_STEPS = 6
PROMPT, MAX_LEN = 16, 32


def _ep(inputs, ctx, out, dev):
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.parallel.mesh_ctx import mesh_context
    from repro_torch.parallel.ref import no_drop

    params = {k[2:]: torch.from_numpy(v).to(dev) for k, v in inputs.items()
              if k.startswith("p/")}
    params["shared"] = {k[7:]: params.pop(k) for k in list(params) if k.startswith("shared/")}
    for case in str(inputs["cases"]).split(","):
        dtype = case.split("-")[0]
        cfg = configs.get_smoke("deepseek-moe-16b").replace(compute_dtype=dtype)
        if case.endswith("nodrop"):
            cfg = no_drop(cfg)
        x = torch.from_numpy(inputs[f"x/{case}"]).to(getattr(torch, dtype)).to(dev)
        with mesh_context(ctx):
            out[f"ep/{case}"] = moe.apply(params, cfg, x).float().cpu().numpy()


def _greedy(params, cfg, toks, ctx, seq):
    """Prefill and 1 + DECODE_STEPS greedy steps; the cache placed on the
    mesh with its slots over the model axis when ``seq``."""
    from repro_torch.models import lm
    from repro_torch.parallel import mesh_ctx as mc
    from repro_torch.parallel.sharding import cache_shardings, distribute_tree

    with mc.mesh_context(ctx if seq else None):
        cache, _ = lm.prefill(params, cfg, toks[:, :-1], max_len=MAX_LEN)
        if seq:
            cache = distribute_tree(cache, cache_shardings(cache, ctx), ctx)
        mc.reset_collective_stats()
        tok, logits = toks[:, -1:], []
        for _ in range(1 + DECODE_STEPS):
            lg, cache = lm.decode_step(params, cfg, tok, cache)
            logits.append(lg.float())
            tok = lg.argmax(-1)[:, None]
    return torch.stack(logits), cache, mc.collective_stats["calls"]


def _decode(inputs, ctx, out, dev):
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import local_slices, spec_of

    toks = torch.from_numpy(inputs["toks"]).to(dev)
    for dtype in ("bfloat16", "float32"):
        cfg = configs.get_smoke("yi-9b").replace(compute_dtype=dtype)
        params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        plain, pcache, pcalls = _greedy(params, cfg, toks, ctx, seq=False)
        seq, scache, scalls = _greedy(params, cfg, toks, ctx, seq=True)
        out[f"plain/{dtype}"], out[f"seq/{dtype}"] = plain.cpu().numpy(), seq.cpu().numpy()
        out[f"calls/{dtype}"] = np.array([pcalls, scalls])
        # this rank's blocks of the sharded rings against the plain rings,
        # by the global slots' writer: prefill, the decode steps, none
        err = np.zeros(3)
        for name in ("k", "v"):
            d = scache["blocks"]["s0"][name]
            sl = local_slices(tuple(d.shape), spec_of(d), ctx)
            diff = (d.to_local().float() - pcache["blocks"]["s0"][name][sl].float()).abs()
            slot = torch.arange(sl[2].start, sl[2].stop, device=dev)
            writer = (slot >= PROMPT).long() + (slot >= PROMPT + 1 + DECODE_STEPS).long()
            for w in range(3):
                if bool((writer == w).any()):
                    err[w] = max(err[w], float(diff[:, :, writer == w].max()))
        out[f"ring_err/{dtype}"] = err


def _restore(directory, ctx, out):
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.parallel.sharding import local_slices, param_shardings
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import train_state_shapes

    template = train_state_shapes(configs.get_smoke("yi-9b"))
    specs = param_shardings(template, ctx)
    state = ckpt.restore(template, os.path.join(directory, "ckpt"), device="cpu",
                         shardings=specs, ctx=ctx)
    leaf = state["params"]["blocks"]["s0"]["attn"]["wq"]
    spec = specs["params"]["blocks"]["s0"]["attn"]["wq"]
    sl = local_slices(tuple(leaf.shape), spec, ctx)
    out["wq/local"] = leaf.to_local().numpy()
    out["wq/slices"] = np.array([[s.start, s.stop] for s in sl])
    out["wq/full"] = leaf.full_tensor().numpy()
    out["restore/all_dtensors"] = np.array(all(
        isinstance(t, DTensor) for t in _leaves(state)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _grad(ctx, out, dev):
    """The loss under the context with parameters that need a gradient:
    ``apply_ep``'s all-reduce raises before any rank reduces, so no rank
    waits on another.  The message is kept for the test."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel.mesh_ctx import mesh_context

    cfg = configs.get_smoke("deepseek-moe-16b").replace(compute_dtype="float32")
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    for t in _leaves(params):
        t.requires_grad_(True)
    toks = torch.arange(16, device=dev).reshape(2, 8) % cfg.vocab
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((2, 8), device=dev)}
    try:
        with mesh_context(ctx):
            loss, _ = lm.loss_fn(params, cfg, batch)
        loss.backward()
        out["grad/refused"] = np.array("")
    except NotImplementedError as e:
        out["grad/refused"] = np.array(str(e))


def _rank(rank, world, directory, n_data, n_model, device, tasks):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.mesh import init_ranks, make_ctx, make_mesh

    init_ranks(rank, world, f"file://{directory}/rendezvous", device_type=device)
    mesh = make_mesh((n_data, n_model), ("data", "model"), device_type=device)
    ctx = make_ctx(mesh)
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else "cpu"
    inputs = dict(np.load(os.path.join(directory, "inputs.npz")))
    out = {"coord": np.array([ctx.coord("data"), ctx.coord("model")]),
           "backends": np.array([torch.distributed.get_backend(mesh.get_group(a))
                                 for a in ("data", "model")])}
    if "ep" in tasks:
        _ep(inputs, ctx, out, dev)
    if "decode" in tasks:
        _decode(inputs, make_ctx(mesh, shard_kv_seq=True), out, dev)
    if "restore" in tasks:
        _restore(directory, ctx, out)
    if "grad" in tasks:
        _grad(ctx, out, dev)
    np.savez(os.path.join(directory, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def main(argv):
    directory, n_data, n_model, device = argv[0], int(argv[1]), int(argv[2]), argv[3]
    world = n_data * n_model
    mp.spawn(_rank, args=(world, directory, n_data, n_model, device, argv[4].split(",")),
             nprocs=world, join=True)


if __name__ == "__main__":
    main(sys.argv[1:])
