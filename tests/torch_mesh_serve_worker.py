"""Rank worker of ``test_torch_mesh_serve.py``: the port's prefill and
decode steps on parameters placed as DTensors, on a gloo process group of
CPU processes.

    python tests/torch_mesh_serve_worker.py <dir> <world> <tasks> [<cases>]

starts ``world`` ranks (``spawn``), which meet through a file under
``<dir>`` and run the comma-separated ``tasks``:

* ``serve`` (world 8): every case of :data:`CASES` (or the comma-separated
  ``cases``, of :data:`CASES` or :data:`RECURRENT_CASES`, or on world 6 of
  :data:`UNDIVIDED_CASES`): the parameters
  of ``<dir>/inputs.npz`` placed by the rule table on the case's mesh,
  ``make_prefill_step`` on the case's prompt (and frames), then
  :data:`DECODE` greedy ``make_decode_step`` steps under the mesh context;
  the logits of every step joined (``greedy_token``'s argmax feeds the
  next), the greedy tokens, this rank's block of every cache leaf after the
  prefill and after the last step with its spec and its slices of the
  global array, the logits' spec, and the collectives of each decode step
  and of each call in it of :data:`COUNTED` (the attention on the ring's
  blocks, the SSM's decode step, the cross-attention's);
* ``card`` (world 4, a (2, 2) mesh on the NVIDIA card, ranks sharing it;
  world 3, the (1, 3) mesh, whose model axis divides few of the smoke
  configs' split dims): :data:`CARD_ARCHS`' smoke configs in fp32 from the
  seed, sharded against
  the same rank's plain prefill and decode on the global parameters, and
  each kernel's launches in the sharded prefill;
* ``card8`` (world 8, the (1, 8) mesh on the card): dbrx-132b smoke, whose
  4 experts the model axis does not divide (the global dispatch), in fp32:
  sharded prefill and decode, and :data:`CARD_STEPS` sharded train steps,
  against the same rank's plain ones.

Each rank writes ``<dir>/<task>-rank<r>.npz``.  Imports no JAX.
"""

import contextlib
import os
import sys
from unittest import mock

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_train_worker import configure  # noqa: E402

MESH_24 = ((2, 4), ("data", "model"))
MESH_222 = ((2, 2, 2), ("pod", "data", "model"))
MESH_18 = ((1, 8), ("data", "model"))
MESH_22 = ((2, 2), ("data", "model"))
MESH_23 = ((2, 3), ("data", "model"))
MESH_13 = ((1, 3), ("data", "model"))

#: case → (arch, mesh, config overrides, context knobs).  yi-9b smoke on (2,
#: 4): its 2 kv heads do not split over the model axis, its hd 8 does, so
#: the ring's head_dim is over it and the column split of wk/wv cuts each kv
#: head in two; with ``shard_kv_seq`` the ring's 40 slots are; with
#: ``seq_shard_activations`` the prefill's block boundary cuts the prompt.
#: gemma2-27b smoke on (2, 2, 2) with FSDP over ("pod", "data"): its 2 kv
#: heads over the model axis, local layers' rings of its window 16 (the
#: 32-token prompt rolls them), both softcaps, tied embeddings.
#: phi-3-vision-4.2b smoke on (2, 4): its 8 patches before the prompt (L 40
#: = MAX_LEN: the decode steps wrap the ring), MHA 4 heads, one a rank.
#: deepseek-moe-16b smoke on (2, 4): 2 of its 8 experts a rank (expert
#: parallel) at its capacity factor 1.25.  dbrx-132b smoke on (1, 8): its 4
#: experts do not split over the model axis of 8, so every rank runs the
#: global dispatch on the gathered tokens; its ring's hd 8 is over the
#: model axis, one element a rank.
CASES = {
    "yi": ("yi-9b", MESH_24, {}, {}),
    "yi-kvseq": ("yi-9b", MESH_24, {}, {"shard_kv_seq": True}),
    "yi-seq": ("yi-9b", MESH_24, {}, {"seq_shard_activations": True}),
    "gemma": ("gemma2-27b", MESH_222, {}, {"fsdp_over_pod": True}),
    "phi": ("phi-3-vision-4.2b", MESH_24, {}, {}),
    "ds": ("deepseek-moe-16b", MESH_24, {}, {}),
    "dbrx-global": ("dbrx-132b", MESH_18, {}, {}),
    "yi-bf16": ("yi-9b", MESH_24, {"compute_dtype": "bfloat16"}, {}),
}
#: the recurrent and enc-dec cases (``test_torch_mesh_serve_recurrent.py``),
#: as :data:`CASES`.  mamba2-370m smoke on (2, 4): 2 of its 8 SSM heads a
#: rank, its inner width 128 and its N 16 over the model axis (the B/C conv
#: tails the rank's 4 channels), with and without
#: ``seq_shard_activations``, and in bf16 compute.  recurrentgemma-9b smoke
#: on (2, 4): the RG-LRU width 64 over the model axis, one (rglru, rglru,
#: local) group and 2 remainder rglru layers, the local layer's ring of its
#: window 16 (the 32-token prompt rolls it) over its one kv head's head_dim,
#: or with ``shard_kv_seq`` over its slots.  seamless-m4t-medium smoke with
#: :data:`FRAMES` frames: on (2, 2, 2) with FSDP over ("pod", "data") (its 4
#: kv heads over the model axis, the memory's too), on (2, 4) with
#: ``shard_kv_seq`` (the memory's 4 rows over the model axis) and with
#: ``seq_shard_activations``.
RECURRENT_CASES = {
    "mamba2": ("mamba2-370m", MESH_24, {}, {}),
    "mamba2-seq": ("mamba2-370m", MESH_24, {}, {"seq_shard_activations": True}),
    "rg": ("recurrentgemma-9b", MESH_24, {}, {}),
    "rg-kvseq": ("recurrentgemma-9b", MESH_24, {}, {"shard_kv_seq": True}),
    "m4t": ("seamless-m4t-medium", MESH_222, {}, {"fsdp_over_pod": True}),
    "m4t-kvseq": ("seamless-m4t-medium", MESH_24, {}, {"shard_kv_seq": True}),
    "m4t-seq": ("seamless-m4t-medium", MESH_24, {}, {"seq_shard_activations": True}),
    "mamba2-bf16": ("mamba2-370m", MESH_24, {"compute_dtype": "bfloat16"}, {}),
}
#: the cases on the (2, 3) mesh (``test_torch_mesh_undivided.py``, world
#: 6), as :data:`CASES` (their configs as ``torch_mesh_train_worker``'s cases
#: of the same names): a model axis of 3, whose guard leaves whole every leaf
#: whose dim it does not divide.  yi-9b smoke: every split dim whole, its
#: ring whole.  deepseek-moe-16b smoke: the shared experts' 96 split, the 8
#: experts through the global dispatch.  mamba2-370m smoke at d_model 96 with
#: SSM heads of 48: its inner width 192 split (the conv tail of x the rank's
#: channels), its 4 heads and their state whole.  recurrentgemma-9b smoke
#: with an RG-LRU width of 96: the width and its state split, the local
#: attention and its ring whole.  phi-3-vision-4.2b smoke with d_ff 96 and
#: its 8 patches: the MLP split, the attention whole.  seamless-m4t-medium
#: smoke with d_ff 96: the MLPs split, the attentions and the projected
#: memory whole.
UNDIVIDED_CASES = {
    "yi3": ("yi-9b", MESH_23, {}, {}),
    "ds3": ("deepseek-moe-16b", MESH_23, {}, {}),
    "mamba3": ("mamba2-370m", MESH_23, {"d_model": 96, "ssm.head_dim": 48}, {}),
    "rg3": ("recurrentgemma-9b", MESH_23, {"rglru.lru_width": 96}, {}),
    "phi3": ("phi-3-vision-4.2b", MESH_23, {"d_ff": 96}, {}),
    "m4t3": ("seamless-m4t-medium", MESH_23, {"d_ff": 96}, {}),
}
ALL_CASES = {**CASES, **RECURRENT_CASES, **UNDIVIDED_CASES}
#: the cases in bf16 compute: held against the port's own single-process
#: steps, not the reference's
BF16_CASES = ("yi-bf16", "mamba2-bf16")
#: the batch, the prompt (patches not counted), the rings' length and the
#: decode steps after the prefill
BATCH, PROMPT, MAX_LEN, DECODE = 8, 32, 40, 3
#: an enc-dec case's frames: the reference's prefill input at the prompt's
#: length (``configs.input_specs``: L // 8)
FRAMES = PROMPT // 8
#: the functions whose collectives the ``serve`` task counts a call
COUNTED = (("ring", "attention", "_decode_ring_blocks"), ("ssm", "ssm", "decode_step"),
           ("cross", "attention", "decode_cross"))
#: every case but those of BF16_CASES runs fp32 compute
FP32_OVERRIDES = {"compute_dtype": "float32"}
#: the ``card`` task's smoke configs (fp32; an MoE config at
#: ``parallel.ref.no_drop``'s capacity, where the sharded and the plain
#: dispatch compute the same function)
CARD_ARCHS = ("yi-9b", "gemma2-27b", "phi-3-vision-4.2b", "deepseek-moe-16b", "mamba2-370m",
              "recurrentgemma-9b", "seamless-m4t-medium")
CARD_BATCH, CARD_PROMPT, CARD_MAX_LEN = 4, 24, 32
#: the ``card8`` task's train steps (batch CARD_BATCH × CARD_PROMPT)
CARD_STEPS = 2


def case_config(name):
    from repro_torch import configs

    arch, _, over, _ = ALL_CASES[name]
    return configure(configs.get_smoke(arch), {**FP32_OVERRIDES, **over})


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def inputs_np(inputs, name):
    """The prefill's inputs of case ``name``: ``tokens`` and, for a VLM,
    ``patches``, for an enc-dec config ``frames``."""
    return {k: inputs[f"inputs/{name}/{k}"] for k in ("tokens", "patches", "frames")
            if f"inputs/{name}/{k}" in inputs}


def spec_axes_list(spec, ndim):
    """A spec (ours or a ``PartitionSpec``) as one tuple of axis names a
    dim, padded to ``ndim`` dims."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(() if e is None else (tuple(e) if isinstance(e, (tuple, list)) else (e,)))
    return tuple(out)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy().copy()


def _cache_record(cache, ctx, out, key):
    """This rank's block of every ring of ``cache`` (DTensors), its spec
    and its slices of the global array, under ``key``."""
    from repro_torch.parallel.sharding import local_slices, spec_of

    for path, t in flatten({k: v for k, v in cache.items() if k != "pos"}).items():
        spec = spec_of(t)
        out[f"{key}/block/{path}"] = _np(t.to_local())
        out[f"{key}/spec/{path}"] = np.array(repr(spec_axes_list(spec, t.ndim)))
        out[f"{key}/slices/{path}"] = np.array(
            [[s.start, s.stop] for s in local_slices(tuple(t.shape), spec, ctx)])
    out[f"{key}/pos"] = np.array(cache["pos"])


def _serve(inputs, meshes, out, rank, names):
    import importlib

    from repro_torch.convert import to_torch
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import mesh_ctx as mc
    from repro_torch.parallel.sharding import (distribute_tree, gather_rows, param_shardings,
                                               spec_of)
    from repro_torch.serve.engine import greedy_token, make_decode_step, make_prefill_step

    seen = {key: [] for key, _, _ in COUNTED}

    def counted(key, core):
        def run(*a, **kw):
            """The function's own collectives, apart from the step's."""
            before = {k: mc.collective_stats[k] for k in ("calls", "bytes", "largest")}
            mc.reset_collective_stats()
            r = core(*a, **kw)
            now = {k: mc.collective_stats[k] for k in ("calls", "bytes", "largest")}
            seen[key].append([now["calls"], now["bytes"], now["largest"]])
            mc.collective_stats.update(calls=before["calls"] + now["calls"],
                                       bytes=before["bytes"] + now["bytes"],
                                       largest=max(before["largest"], now["largest"]))
            return r
        return run

    patches = []
    for key, module, fn in COUNTED:
        mod = importlib.import_module(f"repro_torch.models.{module}")
        patches.append(mock.patch.object(mod, fn, counted(key, getattr(mod, fn))))
    for name in names:
        _, mesh, _, knobs = ALL_CASES[name]
        ctx = make_ctx(meshes[mesh], **knobs)
        cfg = case_config(name)
        params = to_torch(unflatten(inputs, f"params/{name}"), device="cpu")
        params = distribute_tree(params, param_shardings(params, ctx), ctx)
        inp = {k: torch.from_numpy(v) for k, v in inputs_np(inputs, name).items()}
        prefill, decode = make_prefill_step(cfg, max_len=MAX_LEN), make_decode_step(cfg)
        logits_all, steps, calls = [], [], {key: [] for key in seen}
        with torch.inference_mode(), mc.mesh_context(ctx), contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            mc.reset_collective_stats()
            cache, logits = prefill(params, inp)
            out[f"{name}/prefill_collectives"] = np.array(mc.collective_stats["calls"])
            out[f"{name}/logits_spec"] = np.array(repr(spec_axes_list(spec_of(logits), 2)))
            _cache_record(cache, ctx, out, f"{name}/prefill")
            toks = [greedy_token(logits)]
            logits_all.append(logits)
            for _ in range(DECODE):
                mc.reset_collective_stats()
                for key in seen:
                    seen[key].clear()
                logits, cache = decode(params, toks[-1], cache)
                steps.append([mc.collective_stats["calls"], mc.collective_stats["bytes"],
                              mc.collective_stats["largest"]])
                for key in seen:
                    calls[key].append(list(seen[key]))
                logits_all.append(logits)
                toks.append(greedy_token(logits))
            out[f"{name}/logits"] = np.stack([_np(gather_rows(lg)) for lg in logits_all])
        out[f"{name}/tokens"] = _np(torch.cat(toks, dim=1))
        out[f"{name}/decode_collectives"] = np.array(steps)
        for key, per_step in calls.items():
            out[f"{name}/{key}_collectives"] = np.array(per_step).reshape(DECODE, -1, 3)
        _cache_record(cache, ctx, out, f"{name}/decode")
        out[f"{name}/cache_bytes"] = np.array(sum(
            t.to_local().numel() * t.to_local().element_size()
            for t in tree_leaves({k: v for k, v in cache.items() if k != "pos"})))


def _card(meshes, out, rank):
    """The ``card`` task: each arch's smoke config in fp32 from the seed on
    the mesh of ranks on the card ((2, 2), or (1, 3) on 3 ranks), sharded
    prefill and decode against
    the same rank's plain ones on the global parameters, and each forward
    kernel's launches in the sharded prefill."""
    from repro_torch import configs
    from repro_torch.convert import tree_to
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import lm
    from repro_torch.parallel.mesh_ctx import mesh_context
    from repro_torch.parallel.ref import no_drop
    from repro_torch.parallel.sharding import distribute_tree, gather_rows, param_shardings
    from repro_torch.serve.engine import greedy_token, make_decode_step, make_prefill_step

    ctx = make_ctx(next(iter(meshes.values())))
    for arch in CARD_ARCHS:
        cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
        if cfg.moe is not None:
            cfg = no_drop(cfg)
        g = torch.Generator(device="cpu").manual_seed(0)
        params = tree_to(lm.init(g, cfg, device="cpu"), "cuda")
        inp = {"tokens": torch.randint(0, cfg.vocab, (CARD_BATCH, CARD_PROMPT), generator=g)}
        if cfg.n_patches:
            inp["patches"] = torch.randn((CARD_BATCH, cfg.n_patches, 1024), generator=g)
        if cfg.enc_dec:
            inp["frames"] = torch.randn((CARD_BATCH, CARD_PROMPT // 8, 1024), generator=g)
        inp = tree_to(inp, "cuda")
        dparams = distribute_tree(params, param_shardings(params, ctx), ctx)
        got, want = [], []
        with torch.inference_mode():
            cache, logits = lm.prefill(params, cfg, inp["tokens"], max_len=CARD_MAX_LEN,
                                       patches=inp.get("patches"), frames=inp.get("frames"))
            want.append(logits)
            for _ in range(DECODE):
                logits, cache = lm.decode_step(params, cfg, greedy_token(logits), cache)
                want.append(logits)
            ops.reset_launches()
            with mesh_context(ctx):
                cache, logits = make_prefill_step(cfg, max_len=CARD_MAX_LEN)(dparams, inp)
                for kernel in ("flash_attention", "ssd_scan", "rglru_scan"):
                    out[f"{arch}/launches/{kernel}"] = np.array(ops.launches[kernel])
                got.append(gather_rows(logits))
                for _ in range(DECODE):
                    logits, cache = make_decode_step(cfg)(dparams, greedy_token(logits), cache)
                    got.append(gather_rows(logits))
        out[f"{arch}/max_abs_err"] = np.array(max(float((a - b).abs().max())
                                                  for a, b in zip(got, want)))
        out[f"{arch}/tokens_equal"] = np.array(all(
            torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(got, want)))


def _card_global(meshes, out, rank):
    """The ``card8`` task: dbrx-132b smoke in fp32 on the (1, 8) mesh of
    ranks on the card, its MoE layers the global dispatch on every rank:
    sharded prefill and decode, then CARD_STEPS sharded train steps, each
    against the same rank's plain run on the global parameters."""
    from repro_torch import configs
    from repro_torch.convert import tree_to
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import lm
    from repro_torch.parallel.mesh_ctx import mesh_context
    from repro_torch.parallel.sharding import distribute_tree, gather_rows, param_shardings
    from repro_torch.serve.engine import greedy_token, make_decode_step, make_prefill_step
    from repro_torch.train.commit import batch_to
    from repro_torch.train.step import make_train_step, train_state_init

    ctx = make_ctx(meshes[MESH_18])
    cfg = configs.get_smoke("dbrx-132b").replace(compute_dtype="float32")
    g = torch.Generator(device="cpu").manual_seed(1)
    state = tree_to(train_state_init(g, cfg, device="cpu"), "cuda")
    toks = torch.randint(0, cfg.vocab, (CARD_BATCH, CARD_PROMPT), generator=g).cuda()
    got, want = [], []
    dparams = distribute_tree(state["params"], param_shardings(state["params"], ctx), ctx)
    with torch.inference_mode():
        cache, logits = lm.prefill(state["params"], cfg, toks, max_len=CARD_MAX_LEN)
        want.append(logits)
        for _ in range(DECODE):
            logits, cache = lm.decode_step(state["params"], cfg, greedy_token(logits), cache)
            want.append(logits)
        with mesh_context(ctx):
            cache, logits = make_prefill_step(cfg, max_len=CARD_MAX_LEN)(dparams,
                                                                       {"tokens": toks})
            got.append(gather_rows(logits))
            for _ in range(DECODE):
                logits, cache = make_decode_step(cfg)(dparams, greedy_token(logits), cache)
                got.append(gather_rows(logits))
    out["serve/max_abs_err"] = np.array(max(float((a - b).abs().max())
                                            for a, b in zip(got, want)))
    out["serve/tokens_equal"] = np.array(all(
        torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(got, want)))
    batches = [batch_to(make_batch(cfg, CARD_PROMPT, CARD_BATCH, step=s), "cuda")
               for s in range(CARD_STEPS)]
    step = make_train_step(cfg)
    sharded = distribute_tree(state, param_shardings(state, ctx), ctx)
    losses = {"plain": [], "sharded": []}
    for b in batches:
        state, m = step(state, b)
        losses["plain"].append([float(m["loss"]), float(m["grad_norm"])])
        with mesh_context(ctx):
            sharded, m = step(sharded, b)
        losses["sharded"].append([float(m["loss"]), float(m["grad_norm"])])
    out["train/plain"], out["train/sharded"] = (np.array(losses[k]) for k in ("plain",
                                                                              "sharded"))


def _rank(rank, world, directory, tasks, names):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_ranks, make_mesh

    device = "cuda" if any(t.startswith("card") for t in tasks) else "cpu"
    init_ranks(rank, world, f"file://{directory}/rendezvous-{world}", device_type=device)
    shapes = {8: [MESH_24, MESH_222, MESH_18], 6: [MESH_23], 3: [MESH_13]}.get(world, [MESH_22])
    meshes = {s: make_mesh(*s, device_type=device) for s in shapes}
    inputs = dict(np.load(os.path.join(directory, "inputs.npz"))) if "serve" in tasks else {}
    for task in tasks:
        out = {}
        if task == "serve":
            _serve(inputs, meshes, out, rank, names)
        elif task == "card":
            _card(meshes, out, rank)
        elif task == "card8":
            _card_global(meshes, out, rank)
        else:
            raise ValueError(f"unknown task {task}")
        np.savez(os.path.join(directory, f"{task}-rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def main(argv):
    directory, world = argv[0], int(argv[1])
    names = argv[3].split(",") if len(argv) > 3 else list(CASES)
    mp.spawn(_rank, args=(world, directory, argv[2].split(","), names), nprocs=world,
             join=True)


if __name__ == "__main__":
    main(sys.argv[1:])
