"""Grouped-query attention: full/sliding-window, softcap, RoPE, KV-cache decode.

The port of :mod:`repro.models.attention`:
  * GQA with any kv-head count, computed grouped (no KV replication);
  * optional QKV bias, logit softcap and sliding window;
  * causal self-attention (prefill/forward) goes through the flash-attention
    wrapper :func:`repro_torch.kernels.ops.flash_attention` — the hand-written
    CUDA kernel on the card, its plain version on the CPU;
  * decode of one token against a ring-buffer KV cache keeps the masked
    dense ``_sdpa`` (the JAX package has no kernel for decode).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       rope_angles, softcap)

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
        logits = torch.where(m, logits, torch.tensor(NEG_INF, dtype=torch.float32,
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


def _flash_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, cap: float) -> torch.Tensor:
    """Causal self-attention through the flash wrapper.

    L is padded up to a multiple of :data:`FLASH_BLOCK` and the padding is
    sliced off.  Padding is exact under causal masking: every padded key
    comes after every real query, so no real row attends to one.
    """
    l = q.shape[1]
    pad = -l % FLASH_BLOCK
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=True, window=window, softcap=cap,
                              block_q=FLASH_BLOCK, block_k=FLASH_BLOCK)
    return out[:, :l] if pad else out


def _project_qkv(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor):
    b, l, _ = x.shape
    ct = cfg.cdtype
    q = x @ params["wq"].to(ct)
    k = x @ params["wk"].to(ct)
    v = x @ params["wv"].to(ct)
    if "bq" in params:
        q = q + params["bq"].to(ct)
        k = k + params["bk"].to(ct)
        v = v + params["bv"].to(ct)
    return (q.reshape(b, l, cfg.n_heads, cfg.hd),
            k.reshape(b, l, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, l, cfg.n_kv_heads, cfg.hd))


# ==========================================================================
# Forward (prefill)
# ==========================================================================


def apply(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
          positions: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Causal self-attention, x: [B,L,D] -> [B,L,D].  Non-causal and
    cross-attention (the JAX ``causal``/``kv_override``) come with enc-dec."""
    return apply_with_kv(params, cfg, x, positions, window=window)[0]


def apply_with_kv(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention that also returns the post-RoPE (k, v), so the
    caller can seed a decode cache."""
    b, l, _ = x.shape
    hd, ct = cfg.hd, cfg.cdtype
    q, k, v = _project_qkv(params, cfg, x)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _flash_causal(q, k, v, window=window, cap=cfg.attn_softcap)
    out = out.reshape(b, l, cfg.n_heads * hd) @ params["wo"].to(ct)
    return out, (k, v)


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
                cache: Dict[str, torch.Tensor], pos: int, *, window: int = 0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,1,D]; pos: absolute position. Returns (out [B,1,D], cache).

    The new k/v row is written into the ring in place (JAX returns a fresh
    cache), so the cache passed in is the cache returned.
    """
    b, l, _ = x.shape
    hd, ct = cfg.hd, cfg.cdtype
    q, k, v = _project_qkv(params, cfg, x)
    cos, sin = rope_angles(torch.tensor([pos], device=x.device), hd, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])

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
    out = out.reshape(b, l, cfg.n_heads * hd) @ params["wo"].to(ct)
    return out, {"k": ck, "v": cv}


def _slot_position(idx: torch.Tensor, cur_slot: int, slots: int,
                   pos: int) -> torch.Tensor:
    """Absolute position stored in each ring slot right after writing ``pos``."""
    delta = (cur_slot - idx) % slots
    return pos - delta
