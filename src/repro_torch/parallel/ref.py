"""Plain versions of the distributed branches, in one process.

Each loops over the mesh coordinates that the distributed branch spreads
over ranks and combines the blocks in coordinate order where the ranks
all-reduce.  They play the part that the kernels' plain versions play: the
tests and ``chip_smoke.py`` hold the ranks' results against them.  The
emulation of ``apply_ep`` runs the ranks' own ``moe.ep_partial``, so it
checks the split into blocks and the all-reduces; :func:`no_drop` gives the
configuration under which ``moe.apply_ref`` (one block over every expert,
with its own buffer, products and combine; only the router and the sort
are shared) is an oracle for ``apply_ep`` too.  Nothing
on the model path calls them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.models import mlp, moe
from repro_torch.models.attention import NEG_INF
from repro_torch.models.common import ModelConfig, softcap


def _blocks(n: int, sizes: Mapping[str, int], axes: Tuple[str, ...]):
    """Row ranges of a dim of ``n`` split over ``axes``, block order."""
    k = 1
    for a in axes:
        k *= sizes[a]
    if n % k:
        raise ValueError(f"{n} does not split over {axes}")
    return [slice(i * (n // k), (i + 1) * (n // k)) for i in range(k)]


def apply_ep_emulated(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                      mesh_sizes: Mapping[str, int], *, batch_axes=("data",),
                      model_axis: str = "model") -> torch.Tensor:
    """``moe.apply_ep`` on a mesh of ``mesh_sizes``: for each batch block,
    the model ranks' partial outputs (each rank's own experts, capacity on
    the block's token count) summed in the compute dtype in rank order,
    then the shared experts on the whole batch."""
    m = cfg.moe
    b, l, d = x.shape
    t, ct = b * l, cfg.cdtype
    n_model = mesh_sizes[model_axis]
    e_loc = m.num_experts // n_model
    x2d = x.reshape(t, d)
    y = torch.zeros((t, d), dtype=ct, device=x.device)
    for rows in _blocks(t, mesh_sizes, tuple(batch_axes)):
        part = moe.ep_partial(moe.expert_block(params, 0, e_loc), cfg, x2d[rows], 0).to(ct)
        for r in range(1, n_model):
            lo = r * e_loc
            part = part + moe.ep_partial(moe.expert_block(params, lo, e_loc), cfg, x2d[rows],
                                         lo).to(ct)
        y[rows] = part
    if m.num_shared:
        y = y + mlp.apply(params["shared"], cfg, x2d.to(ct), d_ff=moe.shared_width(cfg))
    return y.reshape(b, l, d)


def no_drop(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with the capacity factor E/k: an expert takes at most one
    assignment a token, so every expert's capacity covers every token on
    either path (``moe.capacity``, ``moe.ep_capacity``) and nothing drops.
    There, and only there, ``apply_ep`` and ``apply_ref`` compute the same
    function."""
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k))


def dropped(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
            mesh_sizes: Optional[Mapping[str, int]] = None, *,
            batch_axes=("data",)) -> int:
    """Assignments that ``moe.apply_ref`` (``mesh_sizes`` None: one block of
    every token, ``moe.capacity``) or ``moe.apply_ep`` on a mesh of
    ``mesh_sizes`` (a block a batch coordinate, ``moe.ep_capacity``) drops
    past an expert's capacity on ``x``."""
    t = x.shape[0] * x.shape[1]
    x2d = x.reshape(t, -1)
    if mesh_sizes is None:
        blocks, cap = [slice(0, t)], moe.capacity(t, cfg)
    else:
        blocks = _blocks(t, mesh_sizes, tuple(batch_axes))
        cap = moe.ep_capacity(t // len(blocks), cfg)
    n = 0
    for rows in blocks:
        ids, _ = moe.route(params, cfg, x2d[rows])
        n += int((~moe.dispatch(ids, cfg.moe.num_experts, cap)["kept"]).sum())
    return n


def decode_seqshard_emulated(cfg: ModelConfig, q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor, pos: int, window: int,
                             n_model: int) -> torch.Tensor:
    """The two-phase softmax of ``attention._decode_seqshard`` over
    ``n_model`` slot blocks of plain global tensors: the new row written
    into ``cache_k``/``cache_v`` in place, each block's masked fp32 logits,
    the max over the blocks' maxima, then the denominators and the
    numerators summed in block order.  Returns out [B, 1, H, hd]."""
    b, l, h, hd = q.shape
    hkv = cfg.n_kv_heads
    g = h // hkv
    slots = cache_k.shape[1]
    gslot = pos % slots
    cache_k[:, gslot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, gslot] = v_new[:, 0].to(cache_v.dtype)
    qg = q.reshape(b, l, hkv, g, hd).float()
    logits, maxima = [], []
    for cols in _blocks(slots, {"model": n_model}, ("model",)):
        idx = torch.arange(cols.start, cols.stop, device=q.device)
        kpos = pos - (gslot - idx) % slots
        valid = (kpos >= 0) & (kpos <= pos)
        if window:
            valid &= kpos > pos - window
        lg = torch.einsum("blkgd,bskd->bkgls", qg, cache_k[:, cols].to(q.dtype).float())
        lg = softcap(lg / torch.tensor(math.sqrt(hd), dtype=torch.float32),
                     cfg.attn_softcap)
        logits.append((cols, torch.where(valid, lg, torch.tensor(NEG_INF))))
        maxima.append(logits[-1][1].amax(dim=-1))
    m = torch.stack(maxima).amax(dim=0)
    den = num = 0.0
    for cols, lg in logits:
        p = torch.exp(lg - m[..., None])
        den = den + p.sum(dim=-1)
        num = num + torch.einsum("bkgls,bskd->bkgld", p.to(cache_v.dtype).float(),
                                 cache_v[:, cols].float())
    out = (num / den[..., None]).to(q.dtype)
    return torch.movedim(out, 3, 1).reshape(b, l, h, hd)
