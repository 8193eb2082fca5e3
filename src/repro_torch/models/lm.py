"""LM assembly: one module serving all 10 architectures of the JAX package —
the decoder patterns "attn", "local", "ssm" and "rglru", dense or
Mixture-of-Experts, the VLM patch prefix and the enc-dec encoder.

The port of :mod:`repro.models.lm`.
The parameter tree is the JAX package's: ``cfg.layer_pattern`` is cycled across
``n_layers``; each pattern slot owns one tree stacked over the ``[G]`` full
repetitions (``blocks/s{i}``), the remainder layers are unstacked
(``rem/r{i}``).  The JAX ``lax.scan`` over groups is a Python loop here.

Entry points
  * :func:`init` / :func:`init_shapes` — parameters on ``device`` from a
    ``torch.Generator`` / on the ``meta`` device (no memory, no numbers).
  * :func:`forward` — tokens (+ modality stubs) → (logits, MoE aux loss).
  * :func:`loss_fn` — next-token cross-entropy (+ MoE aux), the training
    objective.
  * :func:`prefill` — forward that also seeds a decode cache.
  * :func:`decode_step` — one token against the cache.
  * enc-dec (seamless-m4t): :func:`encode` feeds cross-attention.

Attention layers keep KV rings in the decode cache; "ssm" (Mamba2) and
"rglru" (RecurrentGemma) layers keep their recurrent state dicts, stacked
over ``[G]`` like the parameters.  In MoE configs (``cfg.moe``) the
attention layers' FFN is :mod:`repro_torch.models.moe` (``p["moe"]`` in
place of ``p["mlp"]``), whose load-balance loss every block returns as its
aux.  A VLM config (``cfg.n_patches``) projects stub patch embeddings
``[B, n_patches, 1024]`` by ``w_patch`` and puts them before the tokens; an
enc-dec config (``cfg.enc_dec``) encodes stub frame embeddings ``[B, S,
1024]`` (``w_frame``, then non-causal self-attention blocks) into the
memory that a cross-attention in every decoder block reads, and the decode
cache keeps its projected ``mk``/``mv``.

Sharded training and serving (``MeshCtx.local_blocks``, set by the
sharded train step and by the engine's sharded prefill and decode for
every family, :func:`check_sharded`): every function runs on this rank's
blocks,
the stacked groups, the remainder layers and the encoder's blocks alike;
attention (causal, the encoder's non-causal and the cross-attention) and
the MLPs are tensor-parallel over the heads and ``d_ff``, the "ssm" and
"rglru" layers over the heads and the lru width
(:mod:`repro_torch.models.ssm`, :mod:`repro_torch.models.rglru`), the MoE
layers expert-parallel over the model axis with a load-balance loss over
every token (:mod:`repro_torch.models.moe`).  The
embedding is vocab-parallel (``embed`` is
(model, fsdp) by the rule table: the rank's rows looked up, the rest
masked, the sum over the model axis); the patch prefix (``w_patch``) and
the frames' projection (``w_frame``) are replicated.  The embedding's
output (with its patch prefix) and the frames' projection are placed in
the block boundary's layout (batch-sharded, and sequence-sharded with
``seq_shard_activations``) by ``constrain_batch``.  The residual stream
stays in that layout: each row-parallel product leaves through
``tp_output``, so the reference's ``_cb`` at the other block boundaries
has nothing to move and is not called.  The logits leave ``_logits``
split on the vocab over the model axis, and :func:`loss_fn` reduces the
max, the sum of exps and the label's logit over it without gathering the
logits.  In serving, every leaf of the decode cache is the rank's block as
``cache_shardings`` places it (:func:`cache_specs`), and each decode step
reads and writes the blocks where they lie.  Where the model axis does not
divide a dim that these paths split (the padded vocab, ``d_ff``, the
heads, the SSM's heads or inner width, the RG-LRU width), the rule table's
guard leaves its leaves whole, and every model rank computes that product
whole: the lookup plain, the logits over the whole vocab, an MLP, an
attention or a recurrent layer on every head or channel.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.models import attention, mlp, moe, rglru, ssm
from repro_torch.models.common import (ModelConfig, dense_init, embed_init,
                                       rms_norm, softcap, tree_leaves, tree_map)
from repro_torch.parallel.mesh_ctx import (all_reduce, blocks_ctx, constrain_batch,
                                           current_ctx, mesh_context, reduce, relayout,
                                           tp_input)
from repro_torch.parallel.sharding import cache_shardings, model_split, spec_of, use_param


# ==========================================================================
# Init
# ==========================================================================


def groups_of(cfg: ModelConfig, n_layers: int | None = None) -> Tuple[int, int]:
    """(full pattern repetitions, remainder layers)."""
    n = cfg.n_layers if n_layers is None else n_layers
    p = len(cfg.layer_pattern)
    return n // p, n % p


def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, *, device,
                lead: Tuple[int, ...] = (), cross: bool = False) -> Dict[str, Any]:
    d, pd = cfg.d_model, cfg.pdtype

    def norm():
        return torch.zeros(tuple(lead) + (d,), dtype=pd, device=device)

    p: Dict[str, Any] = {"ln1": norm()}
    if kind in ("attn", "local"):
        p["attn"] = attention.init(gen, cfg, device=device, lead=lead)
        if cfg.d_ff:
            p["ln2"] = norm()
            if cfg.moe is not None:
                p["moe"] = moe.init(gen, cfg, device=device, lead=lead)
            else:
                p["mlp"] = mlp.init(gen, cfg, device=device, lead=lead)
        if cfg.post_norms:
            p["ln1b"] = norm()
            if cfg.d_ff:
                p["ln2b"] = norm()
        if cross:
            p["lnx"] = norm()
            p["xattn"] = attention.init(gen, cfg, device=device, lead=lead)
    elif kind == "ssm":
        p["ssm"] = ssm.init(gen, cfg, device=device, lead=lead)
    elif kind == "rglru":
        p["rec"] = rglru.init(gen, cfg, device=device, lead=lead)
        if cfg.d_ff:
            p["ln2"] = norm()
            p["mlp"] = mlp.init(gen, cfg, device=device, lead=lead)
    else:
        raise ValueError(f"unknown block kind {kind}")
    return p


def init(gen: torch.Generator, cfg: ModelConfig, *, device="cuda") -> Dict[str, Any]:
    """Random parameters with the JAX package's tree layout.

    ``gen`` must live on ``device`` (``torch.Generator(device=...)``).  The
    numbers differ from ``repro.models.lm.init``'s; parity goes through
    converted weights (:mod:`repro_torch.convert`).
    """
    dev = resolve_device(device)
    g, rem = groups_of(cfg)
    cross = cfg.enc_dec
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype, device=dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=dev),
        "blocks": {f"s{i}": _block_init(gen, cfg, kind, device=dev, lead=(g,), cross=cross)
                   for i, kind in enumerate(cfg.layer_pattern)},
    }
    if rem:
        params["rem"] = {
            f"r{i}": _block_init(gen, cfg, cfg.pattern_of(g * len(cfg.layer_pattern) + i),
                                 device=dev, cross=cross)
            for i in range(rem)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       cfg.pdtype, device=dev)
    if cfg.enc_dec:
        params["encoder"] = {
            "blocks": _block_init(gen, cfg, "attn", device=dev, lead=(cfg.n_enc_layers,)),
            "norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=dev),
        }
    if cfg.n_patches:          # vlm: patch-embedding projection (frontend stub)
        params["w_patch"] = dense_init(gen, 1024, cfg.d_model, cfg.pdtype, device=dev)
    if cfg.frame_input:        # audio: frame-embedding projection (frontend stub)
        params["w_frame"] = dense_init(gen, 1024, cfg.d_model, cfg.pdtype, device=dev)
    return params


def init_shapes(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """The parameter tree on the ``meta`` device: :func:`init`'s keys,
    shapes and dtypes with no allocation (the rule table's input at full
    width).  ``seed`` is the reference's signature; meta tensors hold no
    numbers."""
    return init(torch.Generator().manual_seed(seed), cfg, device="meta")


def _index(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ==========================================================================
# Block application (prefill / forward)
# ==========================================================================


def _scale(p: Dict[str, Any], name: str, cfg: ModelConfig) -> torch.Tensor:
    """A norm's scale as its use sees it: on local blocks it is replicated,
    its gradient summed over the axes that split the data it meets (the
    model axis too when the sequence is split over it)."""
    ctx = blocks_ctx()
    return use_param(p[name], name, (cfg.d_model,),
                     model_partial=ctx is not None and ctx.seq_shard_activations)


def _block_apply(cfg: ModelConfig, kind: str, p: Dict[str, Any], x: torch.Tensor,
                 positions: torch.Tensor, memory: Optional[torch.Tensor], collect_kv: bool):
    """Returns (x, aux, cache contribution or None): aux is the MoE
    load-balance loss of the block (the float 0.0 without MoE, so that a
    dense block launches nothing for it), the cache contribution k/v of
    attention layers (with the cross-attention's projected memory ``mk``,
    ``mv`` in enc-dec blocks), the state dict of recurrent ones."""
    kv = None
    aux = 0.0
    h = rms_norm(x, _scale(p, "ln1", cfg), cfg.rms_eps)
    if kind == "ssm":
        if collect_kv:
            y, kv = ssm.apply_with_state(p["ssm"], cfg, h)
        else:
            y = ssm.apply(p["ssm"], cfg, h)
        return x + y, aux, kv
    if kind == "rglru":
        if collect_kv:
            y, kv = rglru.apply_with_state(p["rec"], cfg, h)
        else:
            y = rglru.apply(p["rec"], cfg, h)
        x = x + y
        if cfg.d_ff:
            x = x + mlp.apply(p["mlp"], cfg, rms_norm(x, _scale(p, "ln2", cfg), cfg.rms_eps))
        return x, aux, kv
    window = cfg.window if kind == "local" else 0
    if collect_kv:
        a, (k_new, v_new) = attention.apply_with_kv(p["attn"], cfg, h, positions,
                                                    window=window)
        kv = {"k": k_new, "v": v_new}
    else:
        a = attention.apply(p["attn"], cfg, h, positions, window=window)
    if cfg.post_norms:
        a = rms_norm(a, _scale(p, "ln1b", cfg), cfg.rms_eps)
    x = x + a
    if "xattn" in p:
        h = rms_norm(x, _scale(p, "lnx", cfg), cfg.rms_eps)
        mk, mv = attention.project_kv(p["xattn"], cfg, memory)
        x = x + attention.apply(p["xattn"], cfg, h, positions, kv_override=(mk, mv))
        if collect_kv:
            kv["mk"], kv["mv"] = mk, mv
    if cfg.d_ff:
        h = rms_norm(x, _scale(p, "ln2", cfg), cfg.rms_eps)
        if cfg.moe is not None:
            f = moe.apply(p["moe"], cfg, h)
            if not collect_kv:               # a prefill has no use for the aux loss
                aux = moe.aux_loss(p["moe"], cfg, h)
        else:
            f = mlp.apply(p["mlp"], cfg, h)
        if cfg.post_norms:
            f = rms_norm(f, _scale(p, "ln2b", cfg), cfg.rms_eps)
        x = x + f
    return x, aux, kv


#: ``remat="dots"``: the matrix products without batch dims are saved and
#: everything else is recomputed, the counterpart of JAX's
#: ``checkpoint_dots_with_no_batch_dims``.  ``bmm`` (the MoE experts'
#: batched products) has a batch dim and stays out, as in JAX.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the config's activation checkpointing, as the reference's
    ``_maybe_remat``: ``none`` saves every activation, ``full`` recomputes
    the group in the backward, ``dots`` saves only the matrix products.
    The recompute runs the group's kernels again (the flash launches of a
    training step are doubled).  It runs under the mesh context of the
    forward: on the card autograd runs the backward, and so the recompute,
    on a thread of its own, which does not see the caller's context."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}; known: none, dots, full")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)

    def run(*args):
        ctx = current_ctx()

        def body(*a):
            with mesh_context(ctx):
                return fn(*a)

        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run


def _needs_grad(x: torch.Tensor, tree: Dict[str, Any]) -> bool:
    """Whether autograd records through ``x`` or a tensor of ``tree``:
    checkpointing runs only then, serving runs the plain blocks."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in tree_leaves(tree)))


def _run_blocks(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, memory: Optional[torch.Tensor], collect_kv: bool):
    """The stacked pattern groups in order, then the remainder layers.

    Returns (x, aux, caches): aux is the MoE load-balance loss summed over
    every layer (0.0 without MoE); caches[f"s{i}"] holds each slot's cache
    contribution (k/v or recurrent state) stacked over groups and
    caches[f"r{i}"] the remainder layers', when ``collect_kv``.  Each group
    runs under :func:`_remat` unless ``collect_kv``; the remainder layers,
    as in the reference, never do.
    """
    pattern = cfg.layer_pattern
    g, _ = groups_of(cfg)
    per_slot: Dict[str, list] = {f"s{i}": [] for i in range(len(pattern))}
    aux = 0.0

    def group(x, gp, memory):
        aux = 0.0
        for i, kind in enumerate(pattern):
            x, a, _ = _block_apply(cfg, kind, gp[f"s{i}"], x, positions, memory, False)
            aux = aux + a
        return x, aux

    body = _remat(cfg, group) if _needs_grad(x, params["blocks"]) else group
    for gi in range(g):
        gp = _index(params["blocks"], gi)
        if not collect_kv:
            x, a = body(x, gp, memory)
            aux = aux + a
            continue
        for i, kind in enumerate(pattern):
            x, a, kv = _block_apply(cfg, kind, gp[f"s{i}"], x, positions, memory,
                                    collect_kv)
            aux = aux + a
            per_slot[f"s{i}"].append(kv)
    caches: Dict[str, Any] = {}
    if collect_kv:
        caches = {name: {key: torch.stack([kv[key] for kv in kvs]) for key in kvs[0]}
                  for name, kvs in per_slot.items()}
    for i, (name, rp) in enumerate(sorted(params.get("rem", {}).items())):
        kind = cfg.pattern_of(g * len(pattern) + i)
        x, a, kv = _block_apply(cfg, kind, rp, x, positions, memory, collect_kv)
        aux = aux + a
        if collect_kv:
            caches[name] = kv
    return x, aux, caches


# ==========================================================================
# Embedding / head
# ==========================================================================


def _vocab_split(cfg: ModelConfig) -> bool:
    """Whether the rule table splits the padded vocab over the model axis on
    local blocks (``embed`` (model, fsdp), ``lm_head`` (fsdp, model), both
    by its guard)."""
    return model_split("embed", (cfg.padded_vocab, cfg.d_model), 0)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings [B, Lt, D]; in a VLM config with ``patches`` [B, P,
    1024] the projected patches come first, [B, P + Lt, D].  On local blocks
    the lookup is vocab-parallel: this rank's rows of ``embed``, the tokens
    outside them masked to zero, summed over the model axis (where the model
    axis does not divide the vocab, ``embed`` is whole and the lookup
    plain); ``w_patch`` is
    replicated and meets the rank's whole batch block (its gradient is
    summed over the batch axes only: the sequence is cut after the
    concatenation, and the cut's backward joins the blocks' gradients).
    The result is placed in the block boundary's layout, the whole P + Lt
    sequence cut under ``seq_shard_activations``."""
    ct = cfg.cdtype
    ctx = blocks_ctx()
    if ctx is None:
        x = params["embed"][tokens.long()].to(ct)
    elif not _vocab_split(cfg):
        x = use_param(params["embed"], "embed", (cfg.padded_vocab, cfg.d_model)
                      )[tokens.long()].to(ct)
    else:
        e = use_param(params["embed"], "embed", (cfg.padded_vocab, cfg.d_model))
        rows = e.shape[0]
        idx = tokens.long() - ctx.coord(ctx.model_axis) * rows
        inside = (idx >= 0) & (idx < rows)
        x = reduce(torch.where(inside[..., None], e[idx.clamp(0, rows - 1)], 0).to(ct),
                   ctx.model_axis, ctx)
    if cfg.embed_scale:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=ct, device=x.device)
    if cfg.n_patches and patches is not None:
        w = use_param(params["w_patch"], "w_patch", (1024, cfg.d_model))
        x = torch.cat([patches.to(ct) @ w.to(ct), x], dim=1)
    return x if ctx is None else constrain_batch(x, src=(tuple(ctx.batch_axes),))


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the final norm; on local blocks the head is a
    column-parallel product, so the logits are in the layout of the
    reference's hint with no move: the batch over the batch axes (the
    rank's batch block), the vocab over the model axis (its head's
    columns), or the whole vocab where the model axis does not divide it
    (the head whole, every model rank the same logits); the whole sequence
    under ``seq_shard_activations``."""
    ct = cfg.cdtype
    split = _vocab_split(cfg)
    x = tp_input(rms_norm(x, _scale(params, "final_norm", cfg), cfg.rms_eps), split)
    vd = (cfg.padded_vocab, cfg.d_model)
    if cfg.tie_embeddings:
        head = use_param(params["embed"], "embed", vd, model_partial=split).T
    else:
        head = use_param(params["lm_head"], "lm_head", vd[::-1], model_partial=split)
    return softcap((x @ head.to(ct)).float(), cfg.logit_softcap)


def check_sharded(cfg: ModelConfig, ctx, *, seq_len: Optional[int] = None,
                  patches: Optional[torch.Tensor] = None,
                  frames: Optional[torch.Tensor] = None) -> None:
    """Raise unless the sharded train step and the sharded prefill and
    decode run ``cfg`` on ``ctx``'s mesh.  They run every family on a
    rank's blocks on any mesh the reference runs: the dense attention
    families ("attn" and "local" layers, a dense MLP, q/k/v biases, tied
    embeddings, both softcaps), the VLM with its patch prefix, the enc-dec
    encoder and cross-attention, the recurrent families ("ssm" and "rglru"
    layers, and in serving their decode states on the rank's heads,
    channels and width), and the MoE family (expert parallel,
    :func:`repro_torch.models.moe.apply_blocks`, or where the model axis
    does not divide the experts the reference's global dispatch on the
    gathered tokens, :func:`repro_torch.models.moe.apply_gathered`).  Where
    the model axis does not divide a dim the rule table splits over it (the
    padded vocab, ``d_ff``, the shared experts' width, ``n_heads·head_dim``,
    the SSM's heads or inner width, the RG-LRU width), the table's guard
    leaves the leaves on it whole, and every model rank computes that
    product whole on the same input, as GSPMD runs the reference there.
    Refused (``ValueError``): under ``seq_shard_activations`` a sequence
    cut at a block boundary that the model axis does not divide, the
    decoder's whole ``seq_len`` tokens plus the ``patches``' prefix, or the
    ``frames``' length."""
    nm = ctx.model_size
    if not ctx.seq_shard_activations:
        return
    seqs = []
    if seq_len is not None:
        prefix = patches.shape[1] if cfg.n_patches and patches is not None else 0
        seqs.append(("the sequence" + (f" of {prefix} patches and {seq_len} tokens"
                                       if prefix else ""), seq_len + prefix))
    if cfg.enc_dec and frames is not None:
        seqs.append(("the frames", frames.shape[1]))
    for name, n in seqs:
        if n % nm:
            raise ValueError(f"seq_shard_activations: the model axis ({nm}) does not divide "
                             f"{name} ({n})")


def _positions(b: int, l: int, device) -> torch.Tensor:
    return torch.arange(l, device=device)[None].expand(b, l)


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Encoder of enc-dec configs: ``frames`` [B, S, 1024] (frontend-stub
    embeddings) → memory [B, S, D]: ``w_frame``, then the ``n_enc_layers``
    blocks of non-causal self-attention and MLP (under the config's remat
    when a gradient is needed), then the final norm.  On local blocks the
    projection (``w_frame`` replicated, as ``w_patch`` in :func:`_embed`)
    is placed in the block boundary's layout, the blocks are
    tensor-parallel and the memory leaves in that layout (S cut over the
    model axis under ``seq_shard_activations``)."""
    ct = cfg.cdtype
    x = frames.to(ct) @ use_param(params["w_frame"], "w_frame", (1024, cfg.d_model)).to(ct)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    ctx = blocks_ctx()
    if ctx is not None:
        x = constrain_batch(x, src=(tuple(ctx.batch_axes),))
    enc = params["encoder"]

    def block(x, gp):
        h = rms_norm(x, _scale(gp, "ln1", cfg), cfg.rms_eps)
        x = x + attention.apply(gp["attn"], cfg, h, positions, causal=False)
        h = rms_norm(x, _scale(gp, "ln2", cfg), cfg.rms_eps)
        return x + mlp.apply(gp["mlp"], cfg, h)

    body = _remat(cfg, block) if _needs_grad(x, enc) else block
    for i in range(cfg.n_enc_layers):
        x = body(x, _index(enc["blocks"], i))
    return rms_norm(x, _scale(enc, "norm", cfg), cfg.rms_eps)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, Lt] → (logits [B, L, Vp] fp32, aux), L = Lt + n_patches
    when ``patches`` are given; aux is the MoE load-balance loss summed over
    the layers, 0 for dense configs.  Enc-dec configs need ``frames``."""
    memory = encode(params, cfg, frames) if cfg.enc_dec else None
    x = _embed(params, cfg, tokens, patches)
    b = x.shape[0]
    # the whole sequence: x may hold this rank's block of it
    l = tokens.shape[1] + (patches.shape[1] if cfg.n_patches and patches is not None else 0)
    x, aux, _ = _run_blocks(params, cfg, x, _positions(b, l, x.device), memory,
                            collect_kv=False)
    if not torch.is_tensor(aux):          # a dense config's 0.0
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux.float()


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over ``batch["tokens"]/["labels"]/["mask"]``.

    The twin of ``repro.models.lm.loss_fn``: fp32 logits, a stable
    logsumexp, CE masked by ``mask`` over ``max(Σ mask, 1)`` tokens, and the
    metrics ``ce``, ``aux``, ``tokens``.  The batch's ``patches`` and
    ``frames`` go to :func:`forward`; a VLM config scores only the text
    tail, the logits after the ``n_patches`` prefix.  The reference picks
    the label's logit by a one-hot contraction over the vocab, which selects
    exactly one fp32 value; ``torch.gather`` picks the same value bit for
    bit without the [B, L, V] one-hot temporaries.
    """
    logits, aux = forward(params, cfg, batch["tokens"], patches=batch.get("patches"),
                          frames=batch.get("frames"))
    if cfg.n_patches:
        logits = logits[:, cfg.n_patches:, :]
    lse, label_logit = _lse_and_label(logits, batch["labels"].long(), _vocab_split(cfg))
    ll = label_logit - lse
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(ll)
    num, den = (ll * mask).sum(), mask.sum()
    ctx = blocks_ctx()
    if ctx is not None:               # the sums over the batch's blocks
        num, den = reduce(num, ctx.batch_axes, ctx), reduce(den, ctx.batch_axes, ctx)
    denom = torch.clamp(den, min=1.0)
    ce = -num / denom
    loss = ce + cfg.aux_loss_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": denom.float()}


def _lse_and_label(logits: torch.Tensor, labels: torch.Tensor, split: bool):
    """(logsumexp over the vocab, the label's logit), each [B, L].  On local
    blocks with the vocab ``split`` the logits are this rank's vocab block:
    the max, the sum of exps and the label's logit (zero on the ranks that
    do not hold it) are each reduced over the model axis, and the logits
    stay where they are; whole, they are the plain ones."""
    ctx = blocks_ctx()
    if ctx is None or not split:
        m = logits.amax(dim=-1, keepdim=True)
        lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
        return lse, torch.gather(logits, -1, labels[..., None])[..., 0]
    group = ctx.group(ctx.model_axis)
    m = all_reduce(logits.detach().amax(dim=-1, keepdim=True), group, "max")
    lse = m[..., 0] + torch.log(reduce(torch.exp(logits - m).sum(dim=-1), ctx.model_axis, ctx))
    cols = logits.shape[-1]
    idx = labels - ctx.coord(ctx.model_axis) * cols
    inside = (idx >= 0) & (idx < cols)
    picked = torch.gather(logits, -1, idx.clamp(0, cols - 1)[..., None])[..., 0]
    return lse, reduce(torch.where(inside, picked, 0.0), ctx.model_axis, ctx)


# ==========================================================================
# Serving: prefill → cache, decode_step
# ==========================================================================


def _attn_slots(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """Local layers only allocate a window-sized ring."""
    return min(cfg.window, max_len) if (kind == "local" and cfg.window) else max_len


def _ring_from_prefill(k: torch.Tensor, slots: int) -> torch.Tensor:
    """[..., L, Hkv, hd] → ring cache [..., slots, Hkv, hd].

    Ring invariant: position ``p`` lives in slot ``p % slots``.  For L > slots
    the kept window starts at p0 = L−slots, so the kept rows are rolled by
    ``p0 % slots`` to land in their slots.
    """
    l = k.shape[-3]
    if l <= slots:
        return F.pad(k, (0, 0, 0, 0, 0, slots - l))
    p0 = l - slots
    return torch.roll(k[..., -slots:, :, :], p0 % slots, dims=-3)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None):
    """Run the full prompt, seed the decode cache.

    Returns (cache, last_logits [B, Vp]).  ``max_len`` sizes the KV rings of
    full-attention layers (prompt + decode budget); recurrent layers pass
    their state dicts through.  The patch prefix counts in the cache's
    ``pos``; enc-dec blocks keep their projected memory ``mk``/``mv``, sized
    by the frames' own length.

    On local blocks (sharded serving) the tokens and frames are this rank's
    batch block, and every leaf of the cache is this rank's block of it as
    :func:`cache_specs` lays it out: each ring (:func:`_ring_block`), the
    projected memory moved from the heads hint's layout, and the recurrent
    states as their modules compute them (the rank's SSM heads and
    channels, its RG-LRU width).  The logits are the rank's vocab block of
    its batch block's last position (under ``seq_shard_activations`` the
    last rank's sequence block holds it).
    """
    memory = encode(params, cfg, frames) if cfg.enc_dec else None
    x = _embed(params, cfg, tokens, patches)
    b = x.shape[0]
    # the whole sequence: x may hold this rank's block of it
    l = tokens.shape[1] + (patches.shape[1] if cfg.n_patches and patches is not None else 0)
    x, _, raw = _run_blocks(params, cfg, x, _positions(b, l, x.device), memory,
                            collect_kv=True)
    pattern = cfg.layer_pattern
    g, _ = groups_of(cfg)
    ctx = blocks_ctx()
    specs = None if ctx is None else cache_specs(
        cfg, b * ctx.batch_size, max_len, ctx,
        memory=frames.shape[1] if cfg.enc_dec else None)
    cache: Dict[str, Any] = {"blocks": {}, "rem": {}}
    for name, kv in raw.items():
        if name[0] == "s":
            kind, group = pattern[int(name[1:])], "blocks"
        else:
            kind, group = cfg.pattern_of(g * len(pattern) + int(name[1:])), "rem"
        if kind in ("ssm", "rglru"):
            cache[group][name] = kv
            continue
        slots = _attn_slots(cfg, kind, max_len)
        if ctx is None:
            ring = functools.partial(_ring_from_prefill, slots=slots)
        else:
            ring = functools.partial(_ring_block, cfg=cfg, slots=slots,
                                     spec=specs[group][name]["k"], ctx=ctx)
        cache[group][name] = {"k": ring(kv["k"]), "v": ring(kv["v"])}
        for key in ("mk", "mv") if "mk" in kv else ():
            cache[group][name][key] = kv[key] if ctx is None else relayout(
                kv[key], _hint_layout(kv[key], cfg, ctx), specs[group][name][key], ctx)
    if not cache["rem"]:
        del cache["rem"]
    cache["pos"] = l
    # the last position is the last row of the last sequence block: _logits
    # gathers the rows of every block under seq_shard_activations
    logits = _logits(params, cfg, x[:, -1:, :])[:, -1, :]
    return cache, logits


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, ctx, *,
                memory: Optional[int] = None) -> Dict[str, Any]:
    """``cache_shardings``' specs of the decode cache of a global ``batch``
    and ``max_len`` (:func:`init_cache`'s tree, on the ``meta`` device),
    with an enc-dec config's ``memory`` rows (the frames' length; the
    reference lays out the cache its prefill returns): the layout of every
    rank's block of a sharded prefill's cache.  The template only carries
    shapes, so it is built outside any dispatch mode: under a dry run's
    ``FakeTensorMode`` and op walker the global cache would count as an
    allocation of the rank."""
    with _disable_current_modes():
        template = init_cache(cfg, batch, max_len, device="meta", memory=memory)
    return cache_shardings(template, ctx)


def _hint_layout(kv: torch.Tensor, cfg: ModelConfig, ctx) -> list:
    """The layout of a prefill's k, v, mk or mv on local blocks, [(G,)
    B_loc, L, ·, hd]: the batch over the batch axes and, where the heads
    hint splits them, the kv heads over the model axis."""
    lead = kv.ndim - 4
    src = [None] * kv.ndim
    src[lead] = tuple(ctx.batch_axes)
    src[lead + 2] = ctx.model_axis if kv.shape[-2] < cfg.n_kv_heads else None
    return src


def _ring_block(kv: torch.Tensor, *, cfg: ModelConfig, slots: int, spec, ctx) -> torch.Tensor:
    """A prefill's k or v on local blocks, [(G,) B_loc, L, ·, hd] in the
    heads hint's layout (this rank's kv heads where the model axis divides
    ``n_kv_heads``, else all of them), → this rank's block of its ring
    [(G,) B_loc, ·, ·, ·] laid out by ``spec``: moved to the ring's layout
    but for the slots (the kv heads gathered where the ring does not split
    them, the head_dim block taken where it splits that: the column split
    of ``wk``/``wv`` can cut a kv head, so this is a relayout of whole
    heads, not a cut of the projection's columns), the ring built, then
    the slot block taken where it splits the slots."""
    mid = list(spec)
    mid[kv.ndim - 3] = None
    ring = _ring_from_prefill(relayout(kv, _hint_layout(kv, cfg, ctx), mid, ctx), slots)
    return relayout(ring, mid, spec, ctx)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", memory: Optional[int] = None) -> Dict[str, Any]:
    """Empty decode cache (zeros; ``pos`` at the last slot, as in JAX).  An
    enc-dec config's ``mk``/``mv`` hold ``memory`` rows, by default
    ``max(1, max_len // 8)`` as the reference's."""
    dev = resolve_device(device)
    g, rem = groups_of(cfg)
    ct = cfg.cdtype

    def one(kind: str, lead: Tuple[int, ...]):
        if kind == "ssm":
            return ssm.init_state(cfg, batch, device=dev, lead=lead)
        if kind == "rglru":
            return rglru.init_state(cfg, batch, device=dev, lead=lead)
        shape = tuple(lead) + (batch, _attn_slots(cfg, kind, max_len),
                               cfg.n_kv_heads, cfg.hd)
        c = {"k": torch.zeros(shape, dtype=ct, device=dev),
             "v": torch.zeros(shape, dtype=ct, device=dev)}
        if cfg.enc_dec:
            rows = max(1, max_len // 8) if memory is None else memory
            mem = tuple(lead) + (batch, rows, cfg.n_kv_heads, cfg.hd)
            c["mk"] = torch.zeros(mem, dtype=ct, device=dev)
            c["mv"] = torch.zeros(mem, dtype=ct, device=dev)
        return c

    cache: Dict[str, Any] = {"blocks": {
        f"s{i}": one(kind, (g,)) for i, kind in enumerate(cfg.layer_pattern)}}
    if rem:
        cache["rem"] = {f"r{i}": one(cfg.pattern_of(g * len(cfg.layer_pattern) + i), ())
                        for i in range(rem)}
    cache["pos"] = max_len - 1
    return cache


def _write_back(gc: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
    """Copy a recurrent layer's new state into its cache tensors (views of
    the stacked ``[G]`` tensors), after it was computed from the old one."""
    for key, t in new.items():
        gc[key].copy_(t)


def _block_decode(cfg: ModelConfig, kind: str, p, x, gc, pos: int, layout=None):
    """One block, one token. x: [B,1,D] → x (gc updated in place: k/v rings
    of attention layers, the state of recurrent ones).  On local blocks
    ``gc`` holds this rank's blocks and ``layout`` the spec of each of them
    (the rings', the projected memory's; a recurrent state lies as its
    module's docstring says)."""
    h = rms_norm(x, _scale(p, "ln1", cfg), cfg.rms_eps)
    if kind == "ssm":
        y, st = ssm.decode_step(p["ssm"], cfg, h, gc)
        _write_back(gc, st)
        return x + y
    if kind == "rglru":
        y, st = rglru.decode_step(p["rec"], cfg, h, gc)
        _write_back(gc, st)
        x = x + y
        if cfg.d_ff:
            x = x + mlp.apply(p["mlp"], cfg, rms_norm(x, _scale(p, "ln2", cfg), cfg.rms_eps))
        return x
    window = cfg.window if kind == "local" else 0
    a, _ = attention.decode_step(p["attn"], cfg, h, gc, pos, window=window,
                                 ring_spec=layout and layout["k"])
    if cfg.post_norms:
        a = rms_norm(a, _scale(p, "ln1b", cfg), cfg.rms_eps)
    x = x + a
    if "xattn" in p:
        h = rms_norm(x, _scale(p, "lnx", cfg), cfg.rms_eps)
        x = x + attention.decode_cross(p["xattn"], cfg, h, gc["mk"], gc["mv"],
                                       layout and layout["mk"])
    if cfg.d_ff:
        h = rms_norm(x, _scale(p, "ln2", cfg), cfg.rms_eps)
        f = moe.apply(p["moe"], cfg, h) if cfg.moe is not None else mlp.apply(p["mlp"], cfg, h)
        if cfg.post_norms:
            f = rms_norm(f, _scale(p, "ln2b", cfg), cfg.rms_eps)
        x = x + f
    return x


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole batch.  token: [B,1] → logits [B, Vp].

    The KV rings and recurrent states are updated in place; the returned
    cache shares them with the one passed in and carries ``pos + 1``.  On
    local blocks (sharded serving) the rings are DTensors placed by
    :func:`cache_specs`: each layer decodes on this rank's block of its
    ring in the ring's layout, the token is the rank's batch block and the
    logits its vocab block.
    """
    pos = cache["pos"]
    rings = {grp: cache.get(grp, {}) for grp in ("blocks", "rem")}
    on_blocks = blocks_ctx() is not None

    def layout(grp: str, name: str):
        """The layout of each leaf of a layer's cache (its lead [G] dim
        dropped) on local blocks, else None."""
        if not on_blocks:
            return None
        return {key: spec_of(t)[1:] if grp == "blocks" else spec_of(t)
                for key, t in cache[grp][name].items()}

    if on_blocks:
        rings = tree_map(lambda t: t.to_local(), rings)
    x = _embed(params, cfg, token)
    pattern = cfg.layer_pattern
    g, _ = groups_of(cfg)
    for gi in range(g):
        gp = _index(params["blocks"], gi)
        for i, kind in enumerate(pattern):
            gc = _index(rings["blocks"][f"s{i}"], gi)
            x = _block_decode(cfg, kind, gp[f"s{i}"], x, gc, pos, layout("blocks", f"s{i}"))
    for i, (name, rp) in enumerate(sorted(params.get("rem", {}).items())):
        kind = cfg.pattern_of(g * len(pattern) + i)
        x = _block_decode(cfg, kind, rp, x, rings["rem"][name], pos, layout("rem", name))
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    logits = _logits(params, cfg, x)[:, 0, :]
    return logits, new_cache
