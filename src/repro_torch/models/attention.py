"""Grouped-query attention: full/sliding-window, softcap, RoPE, KV-cache decode.

The port of :mod:`repro.models.attention`:
  * GQA with any kv-head count, computed grouped (no KV replication);
  * optional QKV bias, logit softcap and sliding window;
  * causal self-attention (prefill/forward) goes through the flash-attention
    wrapper :func:`repro_torch.kernels.ops.flash_attention` — the hand-written
    CUDA kernel on the card, its plain version on the CPU — and, when a
    gradient is needed, through :func:`repro_torch.models.flash.flash_attention`,
    the same forward with the reference's FA2 backward;
  * non-causal self-attention (the enc-dec encoder) and cross-attention
    against projected encoder memory (:func:`project_kv`, ``kv_override``)
    run the dense ``_sdpa`` with no mask, as the reference's do at every
    length: the flash path pads L to a multiple of 64, which is exact only
    under the causal mask;
  * decode of one token against a ring-buffer KV cache keeps the masked
    dense ``_sdpa`` (the JAX package has no kernel for decode);
  * under a mesh context with ``shard_kv_seq``, a cache placed as DTensors
    with its slots over the model axis decodes through the flash-decoding
    :func:`_decode_seqshard`, a two-phase softmax over the ranks' slot
    blocks;
  * on local blocks (the sharded train step, sharded serving), every
    attention (:func:`_tp_attend`: causal, non-causal and cross) is
    Megatron's tensor-parallel attention: q/k/v column-parallel, the
    reference's heads hint before the attention, ``wo`` row-parallel; a
    decode step attends the rank's block of the KV ring in whichever
    layout ``cache_shardings`` gave it (:func:`_decode_ring_blocks`), and
    the rank's block of the projected memory likewise
    (:func:`decode_cross`).  Where the model axis does not divide
    ``n_heads·head_dim``, the rule table's guard leaves q, k, v and ``wo``
    whole over it and every model rank computes the whole attention
    (:func:`_split`).  Off local blocks the parameter reads and the
    tensor-parallel entry and exit are identities.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import flash
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       rope_angles, softcap)
from repro_torch.parallel.mesh_ctx import (all_reduce, blocks_ctx, constrain,
                                           current_ctx, gather_block, gather_dim0,
                                           is_distributed, spec_axes, tp_input, tp_output)
from repro_torch.parallel.sharding import local_slices, model_split, spec_of, use_param

NEG_INF = -2.3819763e38   # keep finite (matches the flash kernel's masking)
FLASH_BLOCK = 64          # prefill pads L up to a multiple of this


# ==========================================================================
# Params
# ==========================================================================


def init(gen: torch.Generator, cfg: ModelConfig, *, device,
         lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    pd = cfg.pdtype
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, pd, device=device, lead=lead),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, pd, device=device, lead=lead),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, pd, device=device, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, d, pd, device=device, lead=lead),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(tuple(lead) + (n * hd,), dtype=pd, device=device)
    return p


# ==========================================================================
# Dense scaled-dot-product (the flash kernel's plain version; decode path)
# ==========================================================================


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], cap: float) -> torch.Tensor:
    """q: [B,L,H,hd]  k,v: [B,S,Hkv,hd]  mask: broadcastable to [B,L,S].

    Logits in fp32 (the JAX ``preferred_element_type``), probabilities cast to
    ``v.dtype`` before the PV product, as in the JAX package.
    """
    b, l, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.reshape(b, l, hkv, group, hd)
    logits = torch.einsum("blkgd,bskd->bkgls", qg.float(), k.float())
    logits = logits / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    logits = softcap(logits, cap)
    if mask is not None:
        m = torch.broadcast_to(mask, (b, l, s))[:, None, None, :, :]
        logits = torch.where(m, logits, torch.full((), NEG_INF, dtype=torch.float32,
                                                  device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgls,bskd->blkgd", probs, v)
    return out.reshape(b, l, h, hd)


def make_causal_mask(l: int, s: int, *, window: int = 0, offset: int = 0,
                     device=None) -> torch.Tensor:
    """[l, s] boolean mask. ``offset`` = absolute position of query row 0
    minus key column 0. window=0 ⇒ full causal."""
    qpos = torch.arange(l, device=device)[:, None] + offset
    kpos = torch.arange(s, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def make_window_mask(l: int, s: int, *, window: int, device=None) -> torch.Tensor:
    """[l, s] boolean mask of a sliding window without causal masking: query
    row i sees key j iff j > i − window, later keys included (the flash
    kernels' non-causal window)."""
    qpos = torch.arange(l, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    return kpos > qpos - window


def _flash_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, cap: float) -> torch.Tensor:
    """Causal self-attention through the flash wrapper.

    L is padded up to a multiple of :data:`FLASH_BLOCK` and the padding is
    sliced off.  Padding is exact under causal masking: every padded key
    comes after every real query, so no real row attends to one, and the
    padded rows get no gradient.  When a gradient is needed the call goes
    through :func:`repro_torch.models.flash.flash_attention` (the same
    forward, with the FA2 backward), on the reference's 512-row tiles where
    they tile the padded L and on :data:`FLASH_BLOCK` rows otherwise.
    """
    l = q.shape[1]
    pad = -l % FLASH_BLOCK
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        lp = l + pad
        block = 512 if lp % min(512, lp) == 0 else FLASH_BLOCK
        out = flash.flash_attention(q, k, v, causal=True, window=window, softcap=cap,
                                    block_q=block, block_k=block)
    else:
        out = ops.flash_attention(q, k, v, causal=True, window=window, softcap=cap,
                                  block_q=FLASH_BLOCK, block_k=FLASH_BLOCK)
    return out[:, :l] if pad else out


def _split(cfg: ModelConfig) -> bool:
    """Whether the attention is a tensor-parallel region split over the
    model axis on local blocks: the rule table splits ``wq`` and ``wo`` on
    ``n_heads·head_dim`` (:func:`~repro_torch.parallel.sharding.model_split`).
    Whole, every model rank computes every head, and ``wk``/``wv`` are whole
    too (``n_kv_heads·head_dim`` divides ``n_heads·head_dim``)."""
    return model_split("wq", (cfg.d_model, cfg.n_heads * cfg.hd))


def _project(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor, name: str,
             heads: int, *, bias: bool = True) -> torch.Tensor:
    """x @ w{name} (+ b{name} when ``bias``) → [B, L, heads, hd].  On local
    blocks the product is column-parallel (``w{name}`` and ``b{name}`` are
    (fsdp, model) and (model,) by the rule table) and the heads hint
    follows: the heads returned are this rank's (:func:`_heads_constraint`).
    A leaf the guard leaves whole is read whole; in a split attention its
    gradient is the rank's partial all the same (it meets only the rank's q
    heads: k and v where the model axis splits q heads and not kv heads)."""
    b, l, _ = x.shape
    ct, n = cfg.cdtype, heads * cfg.hd
    split = _split(cfg)
    y = x @ use_param(params["w" + name], "w" + name, (cfg.d_model, n),
                      model_partial=split).to(ct)
    if bias and "b" + name in params:
        y = y + use_param(params["b" + name], "b" + name, (n,), model_partial=split).to(ct)
    if blocks_ctx() is not None:
        return _heads_constraint(y, name, heads, cfg)
    return y.reshape(b, l, heads, cfg.hd)


def _project_qkv(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor):
    return (_project(params, cfg, x, "q", cfg.n_heads),
            _project(params, cfg, x, "k", cfg.n_kv_heads),
            _project(params, cfg, x, "v", cfg.n_kv_heads))


# ==========================================================================
# Forward (prefill)
# ==========================================================================


def apply(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
          positions: Optional[torch.Tensor], *, window: int = 0,
          kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          causal: bool = True) -> torch.Tensor:
    """x: [B,L,D] -> [B,L,D].  ``kv_override`` supplies cross-attention
    memory, (k, v) [B,S,Hkv,hd] already projected (:func:`project_kv`).

    Causal self-attention goes through the flash path.  Without ``causal``,
    and always under ``kv_override``, the dense ``_sdpa`` runs with no mask,
    as in the reference: under ``kv_override`` q gets no RoPE and
    ``causal`` is not read (``positions`` may be None).  On local blocks
    both are tensor-parallel as :func:`apply_with_kv` is (:func:`_tp_attend`).
    """
    if kv_override is None and causal:
        return apply_with_kv(params, cfg, x, positions, window=window)[0]
    dense = functools.partial(_sdpa, mask=None, cap=cfg.attn_softcap)
    return _tp_attend(params, cfg, x, positions, kv_override, dense)[0]


def apply_with_kv(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention that also returns the post-RoPE (k, v), so the
    caller can seed a decode cache: flash on :func:`_tp_attend`'s heads."""
    flash_causal = functools.partial(_flash_causal, window=window, cap=cfg.attn_softcap)
    return _tp_attend(params, cfg, x, positions, None, flash_causal)


def _tp_attend(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
               positions: Optional[torch.Tensor],
               kv: Optional[Tuple[torch.Tensor, torch.Tensor]], attend
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention of ``x`` by ``attend(q, k, v)`` → [B, L, heads, hd], with
    q, k, v projected from ``x`` and roped at ``positions`` (self-attention)
    or q projected with no RoPE against ``kv``, the memory's projected (k,
    v) (cross-attention).  Returns (out [B, L, D], the (k, v) attended).

    On local blocks ``x`` is this rank's block at the block boundary and
    ``positions`` [B/batch, L] the whole sequence's: the input enters the
    column-parallel projections through ``tp_input`` (whole, where the
    attention is not split: :func:`_split`), then the heads hint
    (:func:`_project`; :func:`project_kv` gives ``kv`` in the same layout).
    Where the hint leaves the kv heads unsharded (the model axis splits a
    kv head, or does not divide ``n_kv_heads·hd`` at all), k/v are whole on
    every rank and each rank takes the kv heads its q heads read.  RoPE
    follows the hint, on whole heads.  ``wo`` is (model, fsdp): the
    row-parallel product's partial sum leaves through ``tp_output``
    (:func:`_out_proj`).  The (k, v) returned are in the heads hint's
    layout: this rank's kv heads where the hint splits them, else all of
    them (a prefill cuts its cache block from them)."""
    hd, ct = cfg.hd, cfg.cdtype
    x = tp_input(x, _split(cfg))
    b, l, _ = x.shape
    if kv is None:
        q, k, v = _project_qkv(params, cfg, x)
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        q = _project(params, cfg, x, "q", cfg.n_heads)
        k, v = kv
    ctx, hl = blocks_ctx(), q.shape[2]
    kv = (k, v)
    if hl < cfg.n_heads and k.shape[2] == cfg.n_kv_heads:    # this rank's q heads only
        h0 = ctx.coord(ctx.model_axis) * hl
        k, v = _local_kv(k, cfg, h0, hl), _local_kv(v, cfg, h0, hl)
    return _out_proj(params, cfg, attend(q, k, v).reshape(b, l, hl * hd)), kv


def _out_proj(params: Dict[str, Any], cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """The attention output [B, L, heads·hd] through ``wo`` → [B, L, D].  On
    local blocks ``wo`` is (model, fsdp), row-parallel: a rank that holds
    every head (its q heads were gathered) keeps its block of the columns,
    the rows of its ``wo`` block, and the partial sum leaves through
    ``tp_output``.  Where the guard leaves ``wo`` whole, the product is
    whole and nothing is summed."""
    ctx, n, split = blocks_ctx(), cfg.n_heads * cfg.hd, _split(cfg)
    if ctx is not None and split and out.shape[-1] == n and ctx.model_size > 1:
        c = n // ctx.model_size                 # every head: the rank's columns
        out = out.narrow(-1, ctx.coord(ctx.model_axis) * c, c)
    wo = use_param(params["wo"], "wo", (n, cfg.d_model), model_partial=split)
    return tp_output(out @ wo.to(cfg.cdtype), split)


def _heads_constraint(y: torch.Tensor, name: str, n: int, cfg: ModelConfig
                      ) -> torch.Tensor:
    """The reference's heads hint, ``[B,L,H,hd]`` over (batch, None, model,
    None) with its divisibility guard, on the column-parallel product ``y``
    [B, L, n·hd] of ``w{name}``, whose last dim is this rank's block where
    the rule table splits ``w{name}`` over the model axis: heads the model
    axis divides stay split (the block is whole heads), others are gathered
    over the model axis, as GSPMD does when the guard leaves H unsharded (a
    rank's block may hold part of a head).  Returns [B, L, heads, hd], this
    rank's heads."""
    ctx = blocks_ctx()
    m, bx = ctx.model_axis, tuple(ctx.batch_axes)
    split = model_split("w" + name, (cfg.d_model, n * cfg.hd))
    heads = n % ctx.model_size == 0
    y = constrain(y, bx, None, m if heads else None, src=(bx, None, m if split else None))
    return y.reshape(y.shape[0], y.shape[1], -1, cfg.hd)


def _local_kv(t: torch.Tensor, cfg: ModelConfig, h0: int, hl: int) -> torch.Tensor:
    """The kv heads [B, L, ·, hd] that q heads ``h0 … h0+hl-1`` read, from
    all ``n_kv_heads`` of ``t``, as a GQA layout the flash kernel takes
    (its kv head of q head j is ``j // (hl / kv heads)``), contiguous as
    the kernel needs it."""
    g = cfg.n_heads // cfg.n_kv_heads
    if hl % g == 0:
        return t[:, :, h0 // g:(h0 + hl) // g].contiguous()
    if g % hl == 0:
        return t[:, :, h0 // g:h0 // g + 1].contiguous()
    idx = torch.arange(h0, h0 + hl, device=t.device) // g
    return t.index_select(2, idx)


def project_kv(params: Dict[str, Any], cfg: ModelConfig, mem: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder memory [B,S,D] → cross-attention (k, v) [B,S,Hkv,hd], projected
    once and reused by every decode step.  No ``bk``/``bv`` bias and no
    RoPE, as in the reference.  On local blocks ``mem`` is in the block
    boundary's layout and enters through ``tp_input`` (the frames' sequence
    gathered over the model axis under ``seq_shard_activations``): the
    products are column-parallel and the kv heads returned follow the heads
    hint, as :func:`_project`'s."""
    mem = tp_input(mem, _split(cfg))
    return (_project(params, cfg, mem, "k", cfg.n_kv_heads, bias=False),
            _project(params, cfg, mem, "v", cfg.n_kv_heads, bias=False))


# ==========================================================================
# Decode (one token against a KV cache)
# ==========================================================================


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, window: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Ring-buffer cache in the compute dtype. Local layers allocate only
    ``window`` slots."""
    slots = min(window, max_len) if window else max_len
    shape = (batch, slots, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def decode_step(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: int, *, window: int = 0,
                ring_spec=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,1,D]; pos: absolute position. Returns (out [B,1,D], cache).

    The new k/v row is written into the ring in place (JAX returns a fresh
    cache), so the cache passed in is the cache returned.  On local blocks
    (sharded serving) ``cache`` holds this rank's blocks of the ring, laid
    out by ``ring_spec`` (``cache_shardings``' spec of [B, S, Hkv, hd]), and
    :func:`_decode_ring_blocks` attends them.  Under a mesh context with
    ``shard_kv_seq``, a cache of DTensors whose slots the model axis divides
    takes :func:`_decode_seqshard` (global values); a plain-tensor cache
    takes the plain path.
    """
    b, l, _ = x.shape
    hd, ct = cfg.hd, cfg.cdtype
    q, k, v = _project_qkv(params, cfg, tp_input(x, _split(cfg)))
    cos, sin = rope_angles(torch.full((1,), pos, device=x.device), hd, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])

    blocks = blocks_ctx()
    if blocks is not None:
        out, ck, cv = _decode_ring_blocks(cfg, q, k, v, cache["k"], cache["v"], pos, window,
                                          ring_spec, blocks)
        return _out_proj(params, cfg, out.reshape(b, l, -1)), {"k": ck, "v": cv}

    ctx = current_ctx()
    if (ctx is not None and ctx.shard_kv_seq and is_distributed(cache["k"])
            and cache["k"].shape[1] % ctx.model_size == 0):
        out, ck, cv = _decode_seqshard(cfg, q, k, v, cache["k"], cache["v"], pos, window,
                                       ctx)
        return _out_proj(params, cfg, out.reshape(b, l, cfg.n_heads * hd)), {"k": ck, "v": cv}

    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    slot = pos % slots
    ck[:, slot:slot + 1] = k.to(ck.dtype)
    cv[:, slot:slot + 1] = v.to(cv.dtype)

    # a slot is attendable iff it holds a position in [pos-window, pos]
    # (window=0 ⇒ [0, pos]; unwritten slots have age > pos and mask out)
    idx = torch.arange(slots, device=x.device)
    age = pos - _slot_position(idx, slot, slots, pos)
    valid = (age >= 0) & (age <= pos)
    if window:
        valid &= age < window
    mask = torch.broadcast_to(valid[None, None, :], (b, 1, slots))
    out = _sdpa(q, ck.to(ct), cv.to(ct), mask, cfg.attn_softcap)
    return _out_proj(params, cfg, out.reshape(b, l, cfg.n_heads * hd)), {"k": ck, "v": cv}


def _slot_position(idx: torch.Tensor, cur_slot: int, slots: int,
                   pos: int) -> torch.Tensor:
    """Absolute position stored in each ring slot right after writing ``pos``."""
    delta = (cur_slot - idx) % slots
    return pos - delta


# ==========================================================================
# Flash-decoding: the KV ring sharded over the model axis on the SEQUENCE dim
# with a two-phase softmax.  Per decode step the only traffic between ranks
# is the [B,H] max, the [B,H] denominator and the [B,H,hd] numerator.
# ==========================================================================


def _decode_seqshard(cfg: ModelConfig, q, k_new, v_new, cache_k, cache_v, pos: int,
                     window: int, ctx):
    """One token against a KV ring of DTensors [B, S, Hkv, hd] whose slot
    dim is sharded over the model axis (and batch over the batch axes, or
    not at all).  q, k_new, v_new: [B, 1, ·, hd], the global batch.

    The rank owning the ring row of ``pos`` writes the new k/v into its
    local block in place; the others leave theirs untouched.  Each rank's
    logits over its slots (masked by the global slot index) give a local
    max, all-reduced by MAX over the model axis, then the denominator and
    the numerator [B,Hkv,G,1,hd] are all-reduced by SUM.  Returns (out
    [B, 1, H, hd] global on every rank, cache_k, cache_v).
    """
    b, slots = q.shape[0], cache_k.shape[1]
    spec = spec_of(cache_k)
    if spec[1] != ctx.model_axis or spec_of(cache_v) != spec:
        raise ValueError(f"the KV ring's layout {spec} does not shard its slots over "
                         f"the model axis {ctx.model_axis!r} alone")
    rows, cols = local_slices(tuple(cache_k.shape), spec, ctx)[:2]
    ck, cv = cache_k.to_local(), cache_v.to_local()
    gslot = pos % slots
    if cols.start <= gslot < cols.stop:                  # the owner writes the row
        ck[:, gslot - cols.start] = k_new[rows, 0].to(ck.dtype)
        cv[:, gslot - cols.start] = v_new[rows, 0].to(cv.dtype)
    valid = _ring_valid(cols.start + torch.arange(ck.shape[1], device=q.device), pos, slots,
                        window)
    out = _seqshard_attend(cfg, q[rows], ck, cv, valid, ctx.group(ctx.model_axis))
    return gather_dim0(out, b, ctx, spec[0]), cache_k, cache_v


def _ring_valid(idx: torch.Tensor, pos: int, slots: int, window: int) -> torch.Tensor:
    """Whether the ring slots ``idx`` (global indices) hold a position in
    [pos − window + 1, pos] (window 0: [0, pos]) right after ``pos`` was
    written: position p lives in slot p % slots, unwritten slots mask out."""
    kpos = pos - (pos % slots - idx) % slots
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid &= kpos > pos - window
    return valid


def _seqshard_attend(cfg: ModelConfig, q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     valid: Optional[torch.Tensor], group) -> torch.Tensor:
    """q [b, l, H, hd] (every head) against a rank's block of rows ck, cv
    [b, S_loc, Hkv, hd] (a ring's slots, or the projected memory's rows) of
    which ``valid`` [S_loc] marks those attended (None: all): the two-phase
    softmax over the ranks of ``group``, whose blocks make the rows.  The
    local max is all-reduced by MAX, then the denominator [b,Hkv,G,1] and
    the numerator [b,Hkv,G,1,hd] by SUM.  Returns out [b, l, H, hd] in q's
    dtype, the same on every rank."""
    b, l, h, hd = q.shape
    hkv = cfg.n_kv_heads
    qg = q.reshape(b, l, hkv, h // hkv, hd)
    logits = torch.einsum("blkgd,bskd->bkgls", qg.float(), ck.to(q.dtype).float())
    logits = logits / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    logits = softcap(logits, cfg.attn_softcap)
    if valid is not None:
        logits = torch.where(valid, logits, torch.full((), NEG_INF, dtype=torch.float32,
                                                      device=logits.device))
    m = all_reduce(logits.amax(dim=-1), group, "max")            # [B,Hkv,G,1]
    p = torch.exp(logits - m[..., None])
    den = all_reduce(p.sum(dim=-1), group)                       # [B,Hkv,G,1]
    num = all_reduce(torch.einsum("bkgls,bskd->bkgld", p.to(cv.dtype).float(),
                                  cv.float()), group)            # [B,Hkv,G,1,hd]
    out = (num / den[..., None]).to(q.dtype)
    return torch.movedim(out, 3, 1).reshape(b, l, h, hd)


def _model_dim(spec, ctx) -> Optional[int]:
    """The dim of [B, S, Hkv, hd] that ``spec`` splits over the model axis
    (1 the slots or rows, 2 the kv heads, 3 the head_dim), or None."""
    return next((d for d, e in enumerate(spec) if ctx.model_axis in spec_axes(e)), None)


def _decode_ring_blocks(cfg: ModelConfig, q, k_new, v_new, ck, cv, pos: int, window: int,
                        spec, ctx):
    """One token on local blocks: q, k_new, v_new [B_loc, 1, ·, hd] in the
    heads hint's layout against this rank's block ck, cv of a KV ring laid
    out by ``spec`` ([B, S, Hkv, hd]: the batch over the batch axes, the
    model axis over the slots, the kv heads, the head_dim or none of them).
    The new row is written into the rank's block in place.  Returns (out
    [B_loc, 1, ·, hd], ck, cv): the rank's q heads where the ring's kv heads
    are split, every head otherwise.  No ring moves between ranks:
      * kv heads: the rank's q heads read exactly its kv heads;
      * slots: the two-phase softmax of :func:`_seqshard_attend` on every
        head, q and the new row gathered (a token's worth), the row written
        by the rank that owns its slot;
      * head_dim: every head's partial scores [B_loc, H, 1, S] summed over
        the model axis (:func:`_head_dim_attend`);
      * none (the ring whole on every model rank): the plain attention of
        every head."""
    m, ct = ctx.model_axis, cfg.cdtype
    where = _model_dim(spec, ctx)
    if where == 2:
        slots = ck.shape[1]
        ck[:, pos % slots] = k_new[:, 0].to(ck.dtype)
        cv[:, pos % slots] = v_new[:, 0].to(cv.dtype)
        valid = _ring_valid(torch.arange(slots, device=q.device), pos, slots, window)
        return _sdpa(q, ck.to(ct), cv.to(ct), valid[None, None, :], cfg.attn_softcap), ck, cv
    q, k_new, v_new = (t if t.shape[2] == n else gather_block(t, 2, ctx, m)
                       for t, n in ((q, cfg.n_heads), (k_new, cfg.n_kv_heads),
                                    (v_new, cfg.n_kv_heads)))
    group, i = ctx.group(m), ctx.coord(m)
    if where == 1:
        s_loc = ck.shape[1]
        slots, s0 = s_loc * ctx.model_size, i * s_loc
        if s0 <= pos % slots < s0 + s_loc:                   # the owner writes the row
            ck[:, pos % slots - s0] = k_new[:, 0].to(ck.dtype)
            cv[:, pos % slots - s0] = v_new[:, 0].to(cv.dtype)
        valid = _ring_valid(s0 + torch.arange(s_loc, device=q.device), pos, slots, window)
        return _seqshard_attend(cfg, q, ck, cv, valid, group), ck, cv
    slots = ck.shape[1]
    valid = _ring_valid(torch.arange(slots, device=q.device), pos, slots, window)
    if where is None:
        ck[:, pos % slots] = k_new[:, 0].to(ck.dtype)
        cv[:, pos % slots] = v_new[:, 0].to(cv.dtype)
        return _sdpa(q, ck.to(ct), cv.to(ct), valid[None, None, :], cfg.attn_softcap), ck, cv
    hdl = ck.shape[3]
    d = slice(i * hdl, (i + 1) * hdl)
    ck[:, pos % slots] = k_new[:, 0, :, d].to(ck.dtype)
    cv[:, pos % slots] = v_new[:, 0, :, d].to(cv.dtype)
    return _head_dim_attend(cfg, q, ck, cv, valid, ctx), ck, cv


def _head_dim_attend(cfg: ModelConfig, q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     valid: Optional[torch.Tensor], ctx) -> torch.Tensor:
    """q [b, l, H, hd] (every head) against this rank's head_dim block ck,
    cv [b, S, Hkv, hd/model] of rows of which ``valid`` [S] marks those
    attended (None: all): every head's partial scores over the rank's hd
    block, summed over the model axis, then softcap, mask and softmax in
    full, P·V on the rank's hd block of v, and the output's hd blocks
    gathered.  Returns out [b, l, H, hd] in the compute dtype, the same on
    every rank of the model axis."""
    m, ct = ctx.model_axis, cfg.cdtype
    b, l, h, hd = q.shape
    hkv, hdl = cfg.n_kv_heads, ck.shape[3]
    i = ctx.coord(m)
    qg = q[..., i * hdl:(i + 1) * hdl].reshape(b, l, hkv, h // hkv, hdl)
    logits = torch.einsum("blkgd,bskd->bkgls", qg.float(), ck.to(ct).float())
    logits = all_reduce(logits, ctx.group(m))            # the scores over the whole hd
    logits = softcap(logits / torch.tensor(math.sqrt(hd), dtype=torch.float32),
                     cfg.attn_softcap)
    if valid is not None:
        logits = torch.where(valid, logits, torch.full((), NEG_INF, dtype=torch.float32,
                                                      device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(ct)
    out = torch.einsum("bkgls,bskd->blkgd", probs, cv.to(ct)).reshape(b, l, h, hdl)
    return gather_block(out, 3, ctx, m)


def decode_cross(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                 mk: torch.Tensor, mv: torch.Tensor, spec=None) -> torch.Tensor:
    """One token's cross-attention, x [B, 1, D] against the decode cache's
    projected memory (mk, mv) [B, S, Hkv, hd] → [B, 1, D]: :func:`apply`'s
    dense cross-attention.  On local blocks (sharded serving) mk, mv are
    this rank's block of the memory laid out by ``spec`` (``cache_shardings``'
    spec of [B, S, Hkv, hd]), and no memory moves between ranks: where it
    splits the kv heads (or none of them) :func:`_tp_attend` attends as in
    the prefill; where it splits the memory's rows (``shard_kv_seq``), q's
    heads are gathered and :func:`_seqshard_attend`'s two-phase softmax
    runs over the ranks' rows; where it splits the head_dim,
    :func:`_head_dim_attend` sums the partial scores.  The output of every
    head leaves through ``wo``'s rows of the rank (:func:`_out_proj`)."""
    ctx = blocks_ctx()
    where = None if ctx is None else _model_dim(spec, ctx)
    if where not in (1, 3):
        return apply(params, cfg, x, None, kv_override=(mk, mv), causal=False)
    b, l, _ = x.shape
    q = _project(params, cfg, tp_input(x, _split(cfg)), "q", cfg.n_heads)
    if q.shape[2] != cfg.n_heads:
        q = gather_block(q, 2, ctx, ctx.model_axis)
    if where == 1:
        out = _seqshard_attend(cfg, q, mk, mv, None, ctx.group(ctx.model_axis))
    else:
        out = _head_dim_attend(cfg, q, mk, mv, None, ctx)
    return _out_proj(params, cfg, out.reshape(b, l, -1))
