"""Rank worker of ``test_torch_mesh_train.py``: the port's sharded train
step on a gloo process group of CPU processes.

    python tests/torch_mesh_train_worker.py <dir> <world> <tasks> [<cases>]

starts ``world`` ranks (``spawn``), which meet through a file under
``<dir>`` and run the comma-separated ``tasks``:

* ``train``: every case of :data:`CASES` (world 8; or the comma-separated
  ``cases``, of :data:`CASES` or, on world 6, of :data:`UNDIVIDED_CASES`):
  the initial parameters
  and the batches of ``<dir>/inputs.npz`` placed by the rule table on the
  case's mesh, :data:`STEPS` steps of ``make_train_step`` under the mesh
  context; each step's loss, MoE aux loss and grad norm, this rank's state
  bytes, and (rank 0) the gathered final state;
* ``saved``: yi-9b smoke, remat "full", on the (2, 4) mesh, with and
  without ``seq_shard_activations``: the bytes rank 0 keeps for the
  backward of one loss, counted by ``saved_tensors_hooks`` (the tensors
  autograd saves) plus the inputs each checkpointed group keeps for its
  recompute;
* ``thread``: the yi case's gradients with the backward run on another
  thread, which does not see the mesh context (autograd's device thread
  does so on the card), against the backward on the calling thread;
* ``ckpt``: a sharded ``checkpoint.save`` of the yi case's first state,
  the bytes it allocates at its peak, and ``restore(shardings=...)`` of it;
* ``refuse``: the sharded step under ``seq_shard_activations`` on (2, 4)
  on sequences the model axis does not divide (a VLM batch of 8 patches
  and 62 tokens, L 70; an enc-dec batch of 6 frames), and the production
  mesh on 8 ranks;
* ``adjoint`` (world 4, a (2, 2) mesh): each differentiable collective's
  backward against its adjoint, in fp64;
* ``card`` (world 4, a (2, 2) mesh on the NVIDIA card, ranks sharing it;
  world 3, the (1, 3) mesh, whose model axis divides few of the smoke
  configs' split dims): :data:`STEPS` fp32 sharded steps of each of
  :data:`CARD_ARCHS` from :func:`card_inputs`, through the scan kernels
  and flash; the losses, grad norms, launches and (rank 0) the gathered
  final state.

Each rank writes ``<dir>/<task>-rank<r>.npz``.  Imports no JAX.
"""

import os
import sys

import numpy as np
import torch
import torch.multiprocessing as mp
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
import torch.utils._pytree as pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

STEPS = 2
MESH_24 = ((2, 4), ("data", "model"))
MESH_222 = ((2, 2, 2), ("pod", "data", "model"))
MESH_18 = ((1, 8), ("data", "model"))
MESH_23 = ((2, 3), ("data", "model"))
MESH_13 = ((1, 3), ("data", "model"))

#: case → (arch, mesh, batch, seq, config overrides, context knobs).  The
#: yi-9b smoke config on (2, 4) splits each of its 2 kv heads over the model
#: axis (n_kv_heads·hd 16 over 4); at L 2048 the reference takes its flash
#: branch and its heads hint.  mamba2-370m smoke on (2, 4): 2 of its 8 SSM
#: heads a rank, L 64 in 4 chunks of 16.  recurrentgemma-9b smoke on (2, 2,
#: 2): L 64 against a window of 16, one (rglru, rglru, local) group and two
#: remainder rglru layers, its one kv head's hd 16 split over the model axis.
#: deepseek-moe-16b smoke on (2, 4): 2 of its 8 experts a rank, top-2, at
#: its own capacity factor 1.25 (80 rows an expert on a rank's 256 tokens);
#: "ds" sets the flag d_ff to 48, so that the shared experts' width (96)
#: differs from it, as at the full config (2816 against 1408).  dbrx-132b
#: smoke on (2, 2, 2): GQA 8/2, no shared experts, 2 of its 4 experts a
#: rank.  phi-3-vision-4.2b smoke on (2, 4): its 8 patches before 64 tokens
#: (L 72, which the model axis divides under ``seq_shard_activations``),
#: ``w_patch`` replicated, MHA 4 heads of 16, one a rank.  seamless-m4t-medium
#: smoke: 2 encoder and 2 decoder layers, FRAMES frames, on (2, 2, 2) with
#: FSDP over ("pod", "data") and on (2, 4) with ``seq_shard_activations``
#: (the model axis cuts the frames' 8 too).  dbrx-132b smoke on (1, 8): its
#: 4 experts do not split over the model axis of 8, so every rank runs the
#: reference's global dispatch on the gathered tokens (at the capacity of
#: all 512), with and without ``seq_shard_activations``.
CASES = {
    "yi": ("yi-9b", MESH_24, 8, 64, {}, {}),
    "yi-flash": ("yi-9b", MESH_24, 2, 2048, {}, {}),
    "qwen": ("qwen1.5-110b", MESH_24, 8, 64, {}, {}),
    "gemma": ("gemma2-27b", MESH_222, 8, 64, {}, {}),
    "gemma-pod": ("gemma2-27b", MESH_222, 8, 64, {}, {"fsdp_over_pod": True}),
    "yi-seq": ("yi-9b", MESH_24, 8, 64, {}, {"seq_shard_activations": True}),
    "yi-gather": ("yi-9b", MESH_24, 8, 64, {"gather_dtype": "bfloat16"}, {}),
    "yi-bf16": ("yi-9b", MESH_24, 8, 64, {"compute_dtype": "bfloat16"}, {}),
    "mamba2": ("mamba2-370m", MESH_24, 8, 64, {}, {}),
    "mamba2-seq": ("mamba2-370m", MESH_24, 8, 64, {}, {"seq_shard_activations": True}),
    "rg": ("recurrentgemma-9b", MESH_222, 8, 64, {}, {"fsdp_over_pod": True}),
    "rg-bf16": ("recurrentgemma-9b", MESH_222, 8, 64, {"compute_dtype": "bfloat16"},
                {"fsdp_over_pod": True}),
    "ds": ("deepseek-moe-16b", MESH_24, 8, 64, {"d_ff": 48}, {}),
    "ds-seq": ("deepseek-moe-16b", MESH_24, 8, 64, {}, {"seq_shard_activations": True}),
    "dbrx": ("dbrx-132b", MESH_222, 8, 64, {}, {"fsdp_over_pod": True}),
    "dbrx-global": ("dbrx-132b", MESH_18, 8, 64, {}, {}),
    "dbrx-global-seq": ("dbrx-132b", MESH_18, 8, 64, {}, {"seq_shard_activations": True}),
    "phi": ("phi-3-vision-4.2b", MESH_24, 8, 64, {}, {}),
    "phi-seq": ("phi-3-vision-4.2b", MESH_24, 8, 64, {}, {"seq_shard_activations": True}),
    "m4t": ("seamless-m4t-medium", MESH_222, 8, 64, {}, {"fsdp_over_pod": True}),
    "m4t-seq": ("seamless-m4t-medium", MESH_24, 8, 64, {}, {"seq_shard_activations": True}),
    "m4t-bf16": ("seamless-m4t-medium", MESH_222, 8, 64, {"compute_dtype": "bfloat16"},
                 {"fsdp_over_pod": True}),
}
#: the cases on the (2, 3) mesh (``test_torch_mesh_undivided.py``, world
#: 6), as :data:`CASES`: a model axis of 3, which the rule table's guard drops
#: from every leaf whose dim it does not divide, so a rank computes those
#: products whole.  yi-9b smoke: every split dim whole (the vocab 512, d_ff
#: 128, the 8 heads of 8), with and without ``seq_shard_activations`` (L 48).
#: deepseek-moe-16b smoke: the shared experts' 96 split, the 8 experts
#: through the global dispatch, the heads and the vocab whole.
#: mamba2-370m smoke at d_model 96 with SSM heads of 48: its inner width 192
#: split, its 4 heads whole (the rank's channels joined for the scan).
#: recurrentgemma-9b smoke with an RG-LRU width of 96: the width split,
#: d_ff 128, the heads and the vocab whole.  phi-3-vision-4.2b smoke with
#: d_ff 96 and its 8 patches: the MLP split, the attention whole.
#: seamless-m4t-medium smoke with d_ff 96 and 6 frames, under
#: ``seq_shard_activations``: the MLPs split, the encoder's, the decoder's
#: and the cross-attention whole, the frames and the tokens cut.  A dotted
#: override sets a field of a nested config (:func:`configure`).
UNDIVIDED_CASES = {
    "yi3": ("yi-9b", MESH_23, 4, 48, {}, {}),
    "yi3-seq": ("yi-9b", MESH_23, 4, 48, {}, {"seq_shard_activations": True}),
    "ds3": ("deepseek-moe-16b", MESH_23, 4, 48, {}, {}),
    "mamba3": ("mamba2-370m", MESH_23, 4, 48, {"d_model": 96, "ssm.head_dim": 48}, {}),
    "rg3": ("recurrentgemma-9b", MESH_23, 4, 48, {"rglru.lru_width": 96}, {}),
    "phi3": ("phi-3-vision-4.2b", MESH_23, 4, 48, {"d_ff": 96}, {}),
    "m4t3-seq": ("seamless-m4t-medium", MESH_23, 4, 48, {"d_ff": 96},
                 {"seq_shard_activations": True}),
}
ALL_CASES = {**CASES, **UNDIVIDED_CASES}
#: the frames of an enc-dec case: data/synthetic.make_batch's S = L / 8 at L 64
FRAMES = 8
#: a batch's keys: the text, and the modality stubs of a VLM or enc-dec case
BATCH_KEYS = ("tokens", "labels", "mask", "patches", "frames")
#: the expert-parallel MoE cases: their sharded step drops other
#: assignments than the single-process step (a rank's capacity is rounded to
#: 8 on its tokens, the plain one to 128 on all of them), so they are held
#: against the reference's sharded step only (the global dispatch of
#: "dbrx-global" computes the plain layer's function)
MOE_CASES = ("ds", "ds-seq", "dbrx")
#: the cases held against the reference's sharded step only: the MoE ones,
#: and "dbrx-global-seq", whose second step's first moments the port's
#: single-process step puts 1.3e-4 of their largest from the reference's
#: sharded step (the port's sharded step: 3.5e-5), past the 1e-4 both
#: sharded steps hold
REFERENCE_ONLY = MOE_CASES + ("dbrx-global-seq",)
#: the cases in bf16 compute (their losses are held at bf16's tolerance)
BF16_CASES = ("yi-bf16", "rg-bf16", "m4t-bf16")
#: the pieces of the ``ckpt`` task's save: the yi-9b smoke state's largest
#: dim-0 row (a layer of ``w_gate``, 64 × 128 fp32), a quarter of its largest
#: leaf
SAVE_PIECE_BYTES = 64 * 128 * 4
#: every case but those of BF16_CASES runs fp32 compute
FP32_OVERRIDES = {"compute_dtype": "float32"}
MESH_22 = ((2, 2), ("data", "model"))
#: the ``card`` task's configs (smoke, fp32; an MoE config at
#: ``parallel.ref.no_drop``'s capacity, where the sharded and the plain steps
#: compute the same function), their batch and length
CARD_ARCHS = ("mamba2-370m", "recurrentgemma-9b", "deepseek-moe-16b", "phi-3-vision-4.2b",
              "seamless-m4t-medium")
CARD_BATCH, CARD_SEQ = 4, 64


def configure(cfg, over):
    """``cfg`` (either package's ``ModelConfig``) with the overrides
    ``over``; a dotted key ``"ssm.head_dim"`` replaces a field of the
    nested config."""
    import dataclasses

    nested = {}
    for key, v in over.items():
        if "." in key:
            outer, inner = key.split(".")
            nested.setdefault(outer, {})[inner] = v
    cfg = cfg.replace(**{k: v for k, v in over.items() if "." not in k})
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in nested.items()})


def frames(name):
    """The frames of case ``name``'s batch: L / 8 (:data:`FRAMES` at L 64)."""
    return ALL_CASES[name][3] // 8


def case_config(name):
    from repro_torch import configs

    arch, _, _, _, over, _ = ALL_CASES[name]
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


def card_inputs(arch):
    """(config, state on the CPU, batches) of the ``card`` task's ``arch``:
    the smoke config in fp32, the port's initial state from seed 0, the
    synthetic batches of steps 0 … STEPS−1; an MoE config at
    ``no_drop``'s capacity."""
    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.parallel.ref import no_drop
    from repro_torch.train.commit import batch_to
    from repro_torch.train.step import train_state_init

    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    if cfg.moe is not None:
        cfg = no_drop(cfg)
    state = train_state_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, state, [batch_to(make_batch(cfg, CARD_SEQ, CARD_BATCH, step=s), "cpu")
                        for s in range(STEPS)]


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _state(params_np, ctx):
    from repro_torch.convert import to_torch
    from repro_torch.parallel.sharding import distribute_tree, param_shardings
    from repro_torch.train import optim

    params = to_torch(params_np, device="cpu")
    state = {"params": params, "opt": optim.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    return distribute_tree(state, param_shardings(state, ctx), ctx)


def batch_np(inputs, name, s):
    """Step ``s``'s batch of case ``name``: the arrays of BATCH_KEYS it has."""
    return {k: inputs[f"batch/{name}/{s}/{k}"] for k in BATCH_KEYS
            if f"batch/{name}/{s}/{k}" in inputs}


def _batch(inputs, name, s):
    return {k: torch.from_numpy(v) for k, v in batch_np(inputs, name, s).items()}


def _local_bytes(tree):
    from repro_torch.models.common import tree_leaves

    return sum(t.to_local().numel() * t.to_local().element_size() for t in tree_leaves(tree)
               if hasattr(t, "to_local"))


def _train(inputs, meshes, out, rank, names):
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.parallel import mesh_ctx as mc
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.train.step import make_train_step

    for name in names:
        _, mesh, _, _, _, knobs = ALL_CASES[name]
        ctx = make_ctx(meshes[mesh], **knobs)
        cfg = case_config(name)
        state = _state(unflatten(inputs, f"params/{name}"), ctx)
        step = make_train_step(cfg)
        losses, norms, aux = [], [], []
        mc.reset_collective_stats()
        with mc.mesh_context(ctx):
            for s in range(STEPS):
                state, m = step(state, _batch(inputs, name, s))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                aux.append(float(m["aux"]))
        out[f"{name}/loss"], out[f"{name}/grad_norm"] = np.array(losses), np.array(norms)
        out[f"{name}/aux"] = np.array(aux)
        out[f"{name}/collectives"] = np.array(mc.collective_stats["calls"])
        out[f"{name}/state_bytes"] = np.array(_local_bytes(state))
        full = gather_tree(state)
        if rank == 0:
            out.update({f"{name}/state/{k}": _np(v) for k, v in flatten(full).items()})
            out[f"{name}/dtypes"] = np.array(sorted(
                f"{k}:{str(v.dtype)[6:]}" for k, v in flatten(full).items()))


def _saved(inputs, meshes, out, rank):
    """Bytes kept for the backward of one loss on this rank: what autograd
    saves outside the checkpointed groups (``saved_tensors_hooks``; inside
    a group the checkpoint saves nothing and recomputes) and the inputs each
    group's checkpoint keeps for its recompute, counted once a storage."""
    import dataclasses
    from unittest import mock

    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.parallel import mesh_ctx as mc
    from repro_torch.parallel.sharding import local_batch

    cfg = case_config("yi").replace(remat="full")
    batch = _batch(inputs, "yi", 0)
    for seq in (False, True):
        ctx = dataclasses.replace(make_ctx(meshes[MESH_24], seq_shard_activations=seq),
                                  local_blocks=True)
        state = _state(unflatten(inputs, "params/yi"), ctx)
        params = tree_map(lambda t: t.to_local().requires_grad_(), state["params"])
        seen = {"saved": {}, "groups": {}}

        def pack(t):
            seen["saved"][t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        def kept(fn, *args, **kw):
            for t in args:
                if isinstance(t, torch.Tensor):
                    seen["groups"][t.untyped_storage().data_ptr()] = \
                        t.untyped_storage().nbytes()
            return checkpoint(fn, *args, **kw)

        checkpoint = lm.checkpoint
        with mc.mesh_context(ctx), mock.patch.object(lm, "checkpoint", kept), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = lm.loss_fn(params, cfg, local_batch(batch, ctx))
        with mc.mesh_context(ctx):
            torch.autograd.grad(loss, tree_leaves(params))
        key = "seq" if seq else "plain"
        out[f"saved/{key}"] = np.array([sum(seen["saved"].values()),
                                        sum(seen["groups"].values())])


def _thread(inputs, meshes, out, rank):
    """The remat recompute runs where the backward runs: on the card that is
    autograd's own thread, without the caller's context variables."""
    import dataclasses
    import threading

    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.parallel import mesh_ctx as mc
    from repro_torch.parallel.sharding import local_batch

    cfg = case_config("yi")
    ctx = dataclasses.replace(make_ctx(meshes[MESH_24]), local_blocks=True)
    state = _state(unflatten(inputs, "params/yi"), ctx)
    params = tree_map(lambda t: t.to_local().requires_grad_(), state["params"])
    batch = local_batch(_batch(inputs, "yi", 0), ctx)
    grads = {}

    def run(where):
        with mc.mesh_context(ctx):
            loss, _ = lm.loss_fn(params, cfg, batch)
        if where == "here":
            with mc.mesh_context(ctx):
                grads[where] = torch.autograd.grad(loss, tree_leaves(params))
            return
        worker = threading.Thread(target=lambda: grads.__setitem__(
            where, torch.autograd.grad(loss, tree_leaves(params))))
        worker.start()
        worker.join()

    run("here")
    run("thread")
    assert cfg.remat != "none" and "thread" in grads
    out["thread/max_diff"] = np.array(max(float((a - b).abs().max())
                                          for a, b in zip(grads["here"], grads["thread"])))


class _PeakBytes(TorchDispatchMode):
    """The most bytes of tensor storage that ops under the mode allocated
    and that were alive at once; storages in ``known`` (the state's blocks)
    are not counted.  A storage counts from the op that returned it until
    it is freed, which every op checks (a weak reference to the storage
    itself) before it counts its own: no Python finalizer of a tensor
    decides the count, so it does not depend on when another thread (gloo's
    worker, which drops its reference to an all-reduced tensor after the
    wait returns) lets a tensor go."""

    def __init__(self, known):
        super().__init__()
        self.known, self.live, self.peak = set(known), {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.live = {k: v for k, v in self.live.items() if not v[0].expired()}
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st.data_ptr() in self.known:
                continue
            ref = StorageWeakRef(st)
            self.live.setdefault(ref.cdata, (ref, st.nbytes()))
        self.peak = max(self.peak, sum(n for _, n in self.live.values()))
        return out


def _ckpt(inputs, meshes, out, rank, directory):
    """A sharded save of the yi case's first state with the pieces cut to
    :data:`SAVE_PIECE_BYTES` (the state's largest dim-0 row): the peak bytes
    the save allocates on this rank's device, the largest leaf's global
    bytes, and ``restore(shardings=...)`` of the file against the state."""
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import param_shardings
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import train_state_shapes

    ctx = make_ctx(meshes[MESH_24])
    state = _state(unflatten(inputs, "params/yi"), ctx)
    ckpt.SAVE_PIECE_BYTES = SAVE_PIECE_BYTES
    leaves = tree_leaves(state)
    with _PeakBytes(t.to_local().untyped_storage().data_ptr() for t in leaves) as peak:
        path = ckpt.save(state, os.path.join(directory, "ckpt"), 5)
    out["ckpt/peak_bytes"] = np.array(peak.peak)
    out["ckpt/leaf_bytes"] = np.array(max(t.numel() * t.element_size() for t in leaves))
    out["ckpt/exists"] = np.array(os.path.exists(path))
    template = train_state_shapes(case_config("yi"))
    back = ckpt.restore(template, os.path.join(directory, "ckpt"), device="cpu",
                        shardings=param_shardings(template, ctx), ctx=ctx)
    out["ckpt/equal"] = np.array(all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(flatten(state).values(), flatten(back).values())))


def _refuse(inputs, meshes, out, rank):
    """What the sharded train step does not run: under
    ``seq_shard_activations``, the VLM's whole sequence (patches and
    tokens) and the enc-dec frames where the model axis does not divide
    them.  Each raises before any collective, on every rank alike.  And
    the production mesh on fewer ranks than its 256."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_ctx, make_production_mesh
    from repro_torch.parallel.mesh_ctx import mesh_context
    from repro_torch.parallel.sharding import distribute_tree, param_shardings
    from repro_torch.train.step import make_train_step, train_state_init

    for key, arch, mesh, lt, frames, knobs in (
            ("seq/phi", "phi-3-vision-4.2b", MESH_24, 62, 0, {"seq_shard_activations": True}),
            ("seq/m4t", "seamless-m4t-medium", MESH_24, 64, 6,
             {"seq_shard_activations": True})):
        ctx = make_ctx(meshes[mesh], **knobs)
        cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
        state = train_state_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        state = distribute_tree(state, param_shardings(state, ctx), ctx)
        toks = torch.zeros((8, lt), dtype=torch.int64)
        batch = {"tokens": toks, "labels": toks, "mask": torch.ones((8, lt))}
        if cfg.n_patches:
            batch["patches"] = torch.zeros((8, cfg.n_patches, 1024))
        if cfg.enc_dec:
            batch["frames"] = torch.zeros((8, frames, 1024))
        try:
            with mesh_context(ctx):
                make_train_step(cfg)(state, batch)
            out[f"refuse/{key}"] = np.array("")
        except (NotImplementedError, ValueError) as e:
            out[f"refuse/{key}"] = np.array(f"{type(e).__name__}: {e}")
    try:
        make_production_mesh(device_type="cpu")
        out["refuse/production"] = np.array("")
    except ValueError as e:
        out["refuse/production"] = np.array(str(e))


def _card(meshes, out, rank):
    """The ``card`` task: each arch's state placed by the rule table on the
    mesh of ranks on the card ((2, 2), or (1, 3) on 3 ranks), STEPS sharded
    steps."""
    from repro_torch.convert import tree_to
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.parallel.mesh_ctx import mesh_context
    from repro_torch.parallel.sharding import distribute_tree, gather_tree, param_shardings
    from repro_torch.train.commit import batch_to
    from repro_torch.train.step import make_train_step

    ctx = make_ctx(next(iter(meshes.values())))
    for arch in CARD_ARCHS:
        cfg, state, batches = card_inputs(arch)
        state = tree_to(state, "cuda")
        state = distribute_tree(state, param_shardings(state, ctx), ctx)
        step = make_train_step(cfg)
        losses, norms = [], []
        ops.reset_launches()
        with mesh_context(ctx):
            for batch in batches:
                state, m = step(state, batch_to(batch, "cuda"))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[f"{arch}/loss"], out[f"{arch}/grad_norm"] = np.array(losses), np.array(norms)
        out[f"{arch}/launches"] = np.array([ops.launches[k] for k in sorted(ops.launches)])
        out["launch_names"] = np.array(sorted(ops.launches))
        full = gather_tree(state)
        if rank == 0:
            out.update({f"{arch}/state/{k}": _np(v.cpu()) for k, v in flatten(full).items()})


def _adjoint(meshes, out, rank):
    """For each collective f (a linear map of the ranks' stacked inputs):
    Σ_ranks <f(x), y> against Σ_ranks <x, backward(y)>.  gather's backward
    is its exact adjoint (a reduce-scatter).  The others follow Megatron's
    convention, whose adjoints hold when the gradient of a value every rank
    holds alike counts once, not once a rank: scatter's backward (a gather)
    against slicing's adjoint followed by that count, reduce's (identity)
    and replicate's (all-reduce) likewise."""
    import dataclasses

    from repro_torch.launch.mesh import make_ctx
    from repro_torch.parallel import mesh_ctx as mc
    from repro_torch.parallel.sharding import use_param_block

    ctx = make_ctx(meshes[MESH_22])
    g = torch.Generator().manual_seed(100 + rank)
    n = ctx.model_size
    m = ctx.model_axis

    def pair(f, shape_in, shape_out):
        x = torch.randn(shape_in, generator=g, dtype=torch.float64, requires_grad=True)
        y = torch.randn(shape_out, generator=g, dtype=torch.float64)
        fx = f(x)
        (gx,) = torch.autograd.grad(fx, x, y)
        return x.detach(), fx.detach(), y, gx

    def total(v):
        v = v.detach().clone()
        for a in ctx.all_axes:
            mc.all_reduce(v, ctx.group(a))
        return v

    out_vals = {}
    with mc.mesh_context(ctx):
        # gather over the model axis: <gather(x), y> summed over the ranks
        x, fx, y, gx = pair(lambda t: mc.gather(t, 1, m, ctx), (3, 2, 5), (3, 2 * n, 5))
        out_vals["gather"] = (total((fx * y).sum()), total((x * gx).sum()))
        # gather over two axes at once (a dim split over data and model)
        x, fx, y, gx = pair(lambda t: mc.gather(t, 0, ("data", "model"), ctx), (2, 3),
                            (2 * ctx.axis_size("data") * n, 3))
        out_vals["gather2"] = (total((fx * y).sum()), total((x * gx).sum()))
        # scatter: input held alike on the model axis; its gradient there counts once
        base = torch.randn((3, 4 * n), generator=torch.Generator().manual_seed(7),
                           dtype=torch.float64)
        x = base.clone().requires_grad_()
        y = torch.randn((3, 4), generator=g, dtype=torch.float64)
        fx = mc.scatter(x, 1, m, ctx)
        (gx,) = torch.autograd.grad(fx, x, y)
        out_vals["scatter"] = (total((fx * y).sum()), total((base * gx).sum()) / n)
        # reduce: output held alike on the model axis; y alike there too
        x = torch.randn((4, 3), generator=g, dtype=torch.float64, requires_grad=True)
        y = torch.randn((4, 3), generator=torch.Generator().manual_seed(8 + ctx.coord("data")),
                        dtype=torch.float64)
        fx = mc.reduce(x, m, ctx)
        (gx,) = torch.autograd.grad(fx, x, y)
        out_vals["reduce"] = (total((fx * y).sum()) / n, total((x.detach() * gx).sum()))
        # replicate: input held alike on the model axis, output's gradient partial
        x0 = torch.randn((5,), generator=torch.Generator().manual_seed(9 + ctx.coord("data")),
                         dtype=torch.float64)
        x = x0.clone().requires_grad_()
        y = torch.randn((5,), generator=g, dtype=torch.float64)
        fx = mc.replicate(x, m, ctx)
        (gx,) = torch.autograd.grad(fx, x, y)
        out_vals["replicate"] = (total((fx.detach() * y).sum()), total((x0 * gx).sum()) / n)
    # use_param_block: a parameter held alike on every rank (replicated by the
    # rule table) cut to the rank's model block; its gradient counts once
    blocks = dataclasses.replace(ctx, local_blocks=True)
    with mc.mesh_context(blocks):
        x0 = torch.randn((4 * n,), generator=torch.Generator().manual_seed(10),
                         dtype=torch.float64)
        x = x0.clone().requires_grad_()
        y = torch.randn((4,), generator=g, dtype=torch.float64)
        fx = use_param_block(x, "D", (4 * n,), 0)
        (gx,) = torch.autograd.grad(fx, x, y)
        world = n * ctx.axis_size("data")
        out_vals["param_block"] = (total((fx.detach() * y).sum()),
                                   total((x0 * gx).sum()) / world)
    for k, (a, b) in out_vals.items():
        out[f"adjoint/{k}"] = np.array([float(a), float(b)])


def _rank(rank, world, directory, tasks, names):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_ranks, make_mesh

    device = "cuda" if "card" in tasks else "cpu"
    init_ranks(rank, world, f"file://{directory}/rendezvous-{world}", device_type=device)
    shapes = {8: [MESH_24, MESH_222, MESH_18], 6: [MESH_23], 3: [MESH_13]}.get(world, [MESH_22])
    meshes = {s: make_mesh(*s, device_type=device) for s in shapes}
    path = os.path.join(directory, "inputs.npz")
    inputs = dict(np.load(path)) if os.path.exists(path) else {}
    for task in tasks:
        out = {}
        if task == "train":
            _train(inputs, meshes, out, rank, names)
        elif task == "saved":
            _saved(inputs, meshes, out, rank)
        elif task == "thread":
            _thread(inputs, meshes, out, rank)
        elif task == "ckpt":
            _ckpt(inputs, meshes, out, rank, directory)
        elif task == "refuse":
            _refuse(inputs, meshes, out, rank)
        elif task == "adjoint":
            _adjoint(meshes, out, rank)
        elif task == "card":
            _card(meshes, out, rank)
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
