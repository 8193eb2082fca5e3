"""The train step: loss and gradients of :func:`repro_torch.models.lm.loss_fn`,
global-norm clip, AdamW, with microbatching and the ``gather_dtype`` cast.

The port of :mod:`repro.train.step`.  The state is a plain dict of the
reference's layout, ``{"params", "opt": {"m", "v"}, "step"}``, so a
checkpoint of either side restores on the other.

Under a mesh context on a ``DeviceMesh``, a state whose parameters are
DTensors (placed by :func:`repro_torch.parallel.sharding.param_shardings`
through ``distribute_tree``: FSDP over ``ctx.fsdp_axes``, TP over the model
axis) takes the sharded step, the counterpart of the reference's
``jax.jit(make_train_step(cfg), in_shardings=(param_shardings(state, ctx),
input_shardings(ctx, batch)))``: each rank computes on its own blocks
(``MeshCtx.local_blocks``) and its block of the batch, the layout changes
are the differentiable collectives of :mod:`repro_torch.parallel.mesh_ctx`,
the gradients come back as the rank's blocks through the gathers'
backwards, the global norm sums over the ranks, and AdamW updates each
block where it lies.  The dense attention families, the VLM with its
patch prefix, the enc-dec encoder and cross-attention, the MoE family
(expert parallel, or, where the model axis does not divide the experts,
the reference's global dispatch on the gathered tokens:
:func:`repro_torch.models.moe.apply_gathered`) and the recurrent ones
(Mamba2's "ssm", RecurrentGemma's "rglru" with its local attention), on
any mesh (:func:`repro_torch.models.lm.check_sharded`).  Where the model
axis does not divide a dim the blocks split, the rule table's guard leaves
that leaf whole: each rank computes its product whole, its gradient and
moments are whole on every model rank, and the global norm counts it once
(its spec names no model axis).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import (ModelConfig, cast_tree, torch_dtype, tree_leaves,
                                       tree_map)
from repro_torch.parallel.mesh_ctx import current_ctx, is_distributed, mesh_context
from repro_torch.parallel.sharding import from_block, local_batch, local_block, spec_of
from repro_torch.train import optim

TrainState = Dict[str, Any]     # {"params", "opt": {"m","v"}, "step"}


def train_state_init(gen: torch.Generator, cfg: ModelConfig, *, device="cuda") -> TrainState:
    """Fresh state: parameters from ``gen`` (which lives on ``device``), zero
    moments, step 0 (a 0-d int32)."""
    dev = resolve_device(device)
    params = lm.init(gen, cfg, device=dev)
    return {"params": params, "opt": optim.adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_state_shapes(cfg: ModelConfig) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device (no memory, no
    numbers): the template a checkpoint restores into."""
    return train_state_init(torch.Generator(), cfg, device="meta")


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by microbatches {n}")
    return [{k: x[i * (b // n):(i + 1) * (b // n)] for k, x in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, max_grad_norm: float = 1.0,
                    microbatches: int = 1, weight_decay: float = 0.1, lr_schedule=None):
    """Build the train step: (state, batch) -> (new state, metrics).

    ``batch`` holds tensors on the state's device.  With ``cfg.gather_dtype``
    the master tree is cast before the gradient and AdamW updates the cast
    tree, as the reference does (``repro/train/step.py:55-59,81``): after one
    step the parameters are in ``gather_dtype`` and m, v stay fp32.  In the
    sharded step the cast is of each rank's blocks, before any gather, so
    every gather moves ``gather_dtype`` bytes.  Microbatch gradients are
    summed in fp32 and divided by their count.

    Under a mesh context, a state of DTensors takes the sharded step (the
    module's docstring); its batch is global tensors, of which each rank
    takes its block, or DTensors, and the new state is DTensors placed as
    the old one.
    """

    def grads_of(params, mb):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(params, cfg, mb)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(it), params))

    def update(params, opt, step, batch, specs=None, ctx=None):
        if cfg.gather_dtype:
            params = cast_tree(params, torch_dtype(cfg.gather_dtype))
        params = tree_map(lambda p: p.detach().requires_grad_(), params)

        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                         device=p.device), params)
            loss, mets = 0.0, []
            for mb in _microbatches(batch, microbatches):
                l_mb, met, g = grads_of(params, mb)
                grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss = loss + l_mb
                mets.append(met)
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {k: torch.stack([m[k] for m in mets]).mean(dim=0) for k in mets[0]}

        grads, gnorm = optim.clip_by_global_norm(grads, max_grad_norm, specs, ctx)
        step_lr = lr_schedule(step) if lr_schedule is not None else lr
        params = tree_map(lambda p: p.detach(), params)
        new_params, new_opt = optim.adamw_update(
            params, grads, opt, step, lr=step_lr, weight_decay=weight_decay)
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm,
                       lr=torch.as_tensor(step_lr, dtype=torch.float32))
        return new_params, new_opt, metrics

    def sharded_step(state: TrainState, batch: Dict[str, torch.Tensor], ctx):
        lm.check_sharded(cfg, ctx, seq_len=batch["tokens"].shape[1],
                         patches=batch.get("patches"), frames=batch.get("frames"))
        specs = tree_map(spec_of, state["params"])
        blocks = dataclasses.replace(ctx, local_blocks=True)
        with mesh_context(blocks):
            params, opt, metrics = update(
                tree_map(local_block, state["params"]), tree_map(local_block, state["opt"]),
                local_block(state["step"]), local_batch(batch, blocks), specs, blocks)

        def place(t, spec):
            return from_block(t, spec, ctx)

        step = state["step"]
        step = place(local_block(step) + 1, ()) if is_distributed(step) else step + 1
        return {"params": tree_map(place, params, specs),
                "opt": {k: tree_map(place, opt[k], specs) for k in ("m", "v")},
                "step": step}, metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        ctx = current_ctx()
        if ctx is not None and ctx.on_ranks and any(
                is_distributed(t) for t in tree_leaves(state["params"])):
            return sharded_step(state, batch, ctx)
        params, opt, metrics = update(state["params"], state["opt"], state["step"], batch)
        return {"params": params, "opt": opt, "step": state["step"] + 1}, metrics

    return train_step
