"""Prefill/decode serving engine (the port of :mod:`repro.serve.engine`).

Under a mesh context on a ``DeviceMesh``, parameters that are DTensors
(placed by :func:`repro_torch.parallel.sharding.param_shardings` through
``distribute_tree``) take the sharded steps, the counterpart of the
reference's ``jax.jit(make_prefill_step(cfg, max_len), in_shardings=(
param_shardings, input_shardings), out_shardings=(cache_shardings, logits
over (batch axes, model)))`` and of its jitted decode step with the cache in
and out by ``cache_shardings``: each rank runs :mod:`repro_torch.models.lm`
on its blocks of the parameters and its batch block of the inputs
(``MeshCtx.local_blocks``), and the cache and the logits come back as
DTensors, the rings in ``cache_shardings``' layout (their slots under
``shard_kv_seq``, else their kv heads, else their head_dim over the model
axis), the recurrent states over the SSM's heads and channels and the
RG-LRU's width, the enc-dec memory's ``mk``/``mv`` as the rings (its rows
under ``shard_kv_seq``), the logits over (the batch axes, the model
axis; the whole vocab where the model axis does not divide it).  Every
family on any mesh (:func:`repro_torch.models.lm.check_sharded`): where the
model axis does not divide a dim the blocks split, the rule table's guard
leaves that leaf whole, and each rank computes its product whole, the
cache leaves on it whole too.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig, tree_leaves, tree_map
from repro_torch.parallel.mesh_ctx import current_ctx, is_distributed, mesh_context
from repro_torch.parallel.sharding import (from_block, gather_rows, local_batch, local_block,
                                           safe_spec)


def _sharded_ctx(params):
    """The mesh context the steps run ``params`` on their blocks under, or
    None: a context of ranks and parameters placed as DTensors."""
    ctx = current_ctx()
    if ctx is not None and ctx.on_ranks and any(is_distributed(t) for t in tree_leaves(params)):
        return ctx
    return None


def _place_logits(logits: torch.Tensor, cfg: ModelConfig, ctx) -> torch.Tensor:
    """This rank's block [B_loc, ·] of the logits [B, Vp] as the DTensor over
    (the batch axes, the model axis), the reference's out_shardings with its
    divisibility guard: the rank's vocab block, or the whole vocab where the
    model axis does not divide it."""
    shape = (logits.shape[0] * ctx.batch_size, cfg.padded_vocab)
    return from_block(logits, safe_spec(shape, [tuple(ctx.batch_axes), ctx.model_axis],
                                        ctx.mesh), ctx)


def make_prefill_step(cfg: ModelConfig, *, max_len: int):
    """``inputs``: ``tokens`` and, as the config needs, the frontend stubs
    ``patches`` (VLM) and ``frames`` (enc-dec).  Returns (cache, logits [B,
    Vp] of the last position); on DTensor parameters under a mesh context
    both are DTensors (the module's docstring)."""
    def prefill_step(params, inputs: Dict[str, torch.Tensor]):
        ctx = _sharded_ctx(params)
        if ctx is None:
            return lm.prefill(params, cfg, inputs["tokens"], max_len=max_len,
                              patches=inputs.get("patches"), frames=inputs.get("frames"))
        frames = inputs.get("frames")
        lm.check_sharded(cfg, ctx, seq_len=inputs["tokens"].shape[1],
                         patches=inputs.get("patches"), frames=frames)
        blocks = dataclasses.replace(ctx, local_blocks=True)
        inp = local_batch(inputs, blocks)
        with mesh_context(blocks):
            cache, logits = lm.prefill(tree_map(local_block, params), cfg, inp["tokens"],
                                       max_len=max_len, patches=inp.get("patches"),
                                       frames=inp.get("frames"))
        specs = lm.cache_specs(cfg, inputs["tokens"].shape[0], max_len, ctx,
                               memory=None if frames is None else frames.shape[1])
        for grp in ("blocks", "rem"):
            if grp in cache:
                cache[grp] = tree_map(lambda t, spec: from_block(t, spec, ctx), cache[grp],
                                      {k: specs[grp][k] for k in cache[grp]})
        return cache, _place_logits(logits, cfg, ctx)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, token [B, 1], cache) → (logits [B, Vp], cache).  On DTensor
    parameters under a mesh context the cache is a sharded prefill's
    (DTensors, written in place on each rank's blocks), the token global or
    a DTensor, and the logits a DTensor (the module's docstring).  One
    token does not split over the model axis, so the step runs without
    ``seq_shard_activations`` (the reference's guard drops it)."""
    def decode_step(params, token: torch.Tensor, cache):
        ctx = _sharded_ctx(params)
        if ctx is None:
            return lm.decode_step(params, cfg, token, cache)
        lm.check_sharded(cfg, ctx)
        blocks = dataclasses.replace(ctx, local_blocks=True, seq_shard_activations=False)
        tok = local_batch({"token": token}, blocks)["token"]
        with mesh_context(blocks):
            logits, cache = lm.decode_step(tree_map(local_block, params), cfg, tok, cache)
        return _place_logits(logits, cfg, ctx), cache
    return decode_step


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """The greedy next token [B, 1] of logits [B, Vp]: the argmax over the
    whole padded vocab, ties to the lower index (``torch.argmax``).  Logits
    placed as a DTensor are joined first, on every rank (a collective)."""
    if is_distributed(logits):
        logits = gather_rows(logits)
    return torch.argmax(logits, dim=-1)[:, None]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor, steps: int, *,
                    max_len: Optional[int] = None,
                    stats: Optional[Dict[str, Any]] = None,
                    patches: Optional[torch.Tensor] = None,
                    frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy decoding: prompt [B, L] → generated tokens [B, steps], through
    :func:`make_prefill_step` and :func:`make_decode_step` (so on DTensor
    parameters under a mesh context each rank serves its blocks and every
    rank returns every token).

    A VLM config may take ``patches`` (the prefix, counted in ``max_len``'s
    default); an enc-dec config needs ``frames`` (its encoder's input).  If
    ``stats`` is given it receives ``prefill_s`` and ``decode_s``, host
    clock around work that ends in a device synchronise.
    """
    b, l = prompt.shape
    if patches is not None:
        l += patches.shape[1]
    max_len = max_len or (l + steps)
    inputs = {"tokens": prompt, **{k: v for k, v in (("patches", patches), ("frames", frames))
                                   if v is not None}}
    decode = make_decode_step(cfg)
    if stats is not None:
        _sync(prompt.device)
    t0 = time.perf_counter()
    cache, logits = make_prefill_step(cfg, max_len=max_len)(params, inputs)
    toks = [greedy_token(logits)]
    if stats is not None:
        _sync(prompt.device)
        t1 = time.perf_counter()
    for _ in range(steps - 1):
        logits, cache = decode(params, toks[-1], cache)
        toks.append(greedy_token(logits))
    out = torch.cat(toks, dim=1)
    if stats is not None:
        _sync(prompt.device)
        t2 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = t2 - t1
    return out
