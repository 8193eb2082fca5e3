"""Blockwise (flash) attention with the FlashAttention-2 backward.

The port of :mod:`repro.models.flash`.  :func:`flash_attention` is a
``torch.autograd.Function``, the counterpart of the reference's
``custom_vjp``:

  * forward: :func:`repro_torch.kernels.ops.flash_attention` with
    ``return_lse`` — the hand-written CUDA kernel on the card, its plain
    version on the CPU — saving q, k, v, out and the fp32 log-sum-exp;
  * backward: :func:`repro_torch.kernels.ops.flash_attention_bwd` — the
    hand-written CUDA backward on the card (``flash_attention_bwd``), and on
    the CPU :func:`_flash_bwd_impl`, the reference's blockwise FA2 backward
    in plain PyTorch.  The JAX package has no Pallas backward; its gradient
    is that jnp code, so the plain version is its counterpart and the
    kernel's yardstick.  It recomputes each ``[bq, bk]`` tile in two sweeps
    (dq per q block, then dk/dv per kv block), visits every tile as the
    reference does (no causal skipping), masks with the finite ``NEG_INF``
    and takes the softcap's derivative.  Every product is fp32: q, k, v and
    do are upcast first, as the reference's ``preferred_element_type`` and
    ``astype(f32)`` make them.

:func:`_flash_fwd_impl` is the reference's blockwise forward in plain
PyTorch, the yardstick of the forward's log-sum-exp.

Layout inside: GQA-grouped, ``q: [B, Hkv, G, L, hd]``, ``k/v: [B, Hkv, S, hd]``;
the public function takes and returns the model's ``[B, L, H, hd]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops

NEG_INF = -2.3819763e38
_F32 = torch.float32


def _tile_logits(qb: torch.Tensor, kb: torch.Tensor, scale: float, softcap: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile logits in fp32 from upcast q and k: (capped, before the cap)."""
    s = torch.einsum("bkgqd,bksd->bkgqs", qb.to(_F32), kb.to(_F32)) * scale
    if softcap:
        return softcap * torch.tanh(s / softcap), s
    return s, s


def _tile_mask(i: int, j: int, bq: int, bk: int, causal: bool, window: int,
               device) -> torch.Tensor:
    qpos = i * bq + torch.arange(bq, device=device)[:, None]
    kpos = j * bk + torch.arange(bk, device=device)[None, :]
    m = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def _neg_inf(device) -> torch.Tensor:
    return torch.full((), NEG_INF, dtype=_F32, device=device)


# ==========================================================================
# Forward
# ==========================================================================


def _flash_fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    window: int, softcap: float, bq: int, bk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B,Hkv,G,L,hd], lse [B,Hkv,G,L])."""
    b, hkv, g, l, hd = q.shape
    s_len = k.shape[2]
    scale = 1.0 / (hd ** 0.5)
    neg = _neg_inf(q.device)
    outs, lses = [], []
    for i in range(l // bq):
        qb = q[:, :, :, i * bq:(i + 1) * bq]
        m = torch.full((b, hkv, g, bq), NEG_INF, dtype=_F32, device=q.device)
        lsum = torch.zeros((b, hkv, g, bq), dtype=_F32, device=q.device)
        o = torch.zeros((b, hkv, g, bq, hd), dtype=_F32, device=q.device)
        for j in range(s_len // bk):
            kb, vb = k[:, :, j * bk:(j + 1) * bk], v[:, :, j * bk:(j + 1) * bk]
            s_cap, _ = _tile_logits(qb, kb, scale, softcap)
            mask = _tile_mask(i, j, bq, bk, causal, window, q.device)
            s_cap = torch.where(mask, s_cap, neg)
            m_new = torch.maximum(m, s_cap.amax(dim=-1))
            p = torch.exp(s_cap - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p.to(vb.dtype).to(_F32), vb.to(_F32))
            m = m_new
        lsum = torch.clamp(lsum, min=1e-37)
        outs.append((o / lsum[..., None]).to(q.dtype))
        lses.append(m + torch.log(lsum))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=3)


# ==========================================================================
# Backward (FlashAttention-2: recompute tiles; two sweeps)
# ==========================================================================


def _flash_bwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    lse: torch.Tensor, do: torch.Tensor, *, causal: bool, window: int,
                    softcap: float, bq: int, bk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grouped layout in and out: (dq, dk, dv) in q's, k's and v's dtypes."""
    b, hkv, g, l, hd = q.shape
    s_len = k.shape[2]
    nq, nk = l // bq, s_len // bk
    scale = 1.0 / (hd ** 0.5)
    delta = (do.to(_F32) * out.to(_F32)).sum(dim=-1)               # [B,Hkv,G,L]
    zero = torch.zeros((), dtype=_F32, device=q.device)
    neg = _neg_inf(q.device)

    def qblk(x, i):
        return x[:, :, :, i * bq:(i + 1) * bq]

    def kblk(x, j):
        return x[:, :, j * bk:(j + 1) * bk]

    def tile_ds(i, j):
        """Recompute p for tile (i, j) and return (p, ds) in fp32."""
        s_cap, s_pre = _tile_logits(qblk(q, i), kblk(k, j), scale, softcap)
        mask = _tile_mask(i, j, bq, bk, causal, window, q.device)
        s_cap = torch.where(mask, s_cap, neg)
        p = torch.exp(s_cap - qblk(lse, i)[..., None])
        dp = torch.einsum("bkgqd,bksd->bkgqs", qblk(do, i).to(_F32), kblk(v, j).to(_F32))
        ds = p * (dp - qblk(delta, i)[..., None])
        if softcap:
            ds = ds * (1.0 - torch.square(torch.tanh(s_pre / softcap)))
        return p, torch.where(mask, ds, zero)

    # ---- dq sweep: per q block, accumulate over kv blocks --------------------
    dq = []
    for i in range(nq):
        acc = torch.zeros((b, hkv, g, bq, hd), dtype=_F32, device=q.device)
        for j in range(nk):
            _, ds = tile_ds(i, j)
            acc = acc + torch.einsum("bkgqs,bksd->bkgqd", ds, kblk(k, j).to(_F32)) * scale
        dq.append(acc.to(q.dtype))

    # ---- dk/dv sweep: per kv block, accumulate over q blocks ------------------
    dk, dv = [], []
    for j in range(nk):
        dk_a = torch.zeros((b, hkv, bk, hd), dtype=_F32, device=q.device)
        dv_a = torch.zeros_like(dk_a)
        for i in range(nq):
            p, ds = tile_ds(i, j)
            dv_a = dv_a + torch.einsum("bkgqs,bkgqd->bksd", p, qblk(do, i).to(_F32))
            dk_a = dk_a + torch.einsum("bkgqs,bkgqd->bksd", ds, qblk(q, i).to(_F32)) * scale
        dk.append(dk_a.to(k.dtype))
        dv.append(dv_a.to(v.dtype))
    return torch.cat(dq, dim=3), torch.cat(dk, dim=2), torch.cat(dv, dim=2)


# ==========================================================================
# autograd.Function assembly
# ==========================================================================


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    lse: torch.Tensor, do: torch.Tensor, *, causal: bool, window: int,
                    softcap: float, bq: int, bk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_flash_bwd_impl` in the model's layout: q, out, do [B,L,H,hd],
    k, v [B,S,Hkv,hd], lse [B,H,L] → (dq, dk, dv) in the same layouts."""
    b, l, h, hd = q.shape
    hkv = k.shape[2]
    dq, dk, dv = _flash_bwd_impl(
        _grouped_q(q, hkv), k.transpose(1, 2), v.transpose(1, 2), _grouped_q(out, hkv),
        lse.reshape(b, hkv, h // hkv, l), _grouped_q(do, hkv), causal=causal, window=window,
        softcap=softcap, bq=bq, bk=bk)
    return _ungrouped_q(dq), dk.transpose(1, 2), dv.transpose(1, 2)


def _grouped_q(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B,L,H,hd] → [B,Hkv,G,L,hd]."""
    b, l, h, hd = x.shape
    return x.reshape(b, l, hkv, h // hkv, hd).permute(0, 2, 3, 1, 4)


def _ungrouped_q(x: torch.Tensor) -> torch.Tensor:
    """[B,Hkv,G,L,hd] → [B,L,H,hd]."""
    b, hkv, g, l, hd = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, l, hkv * g, hd)


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, bq, bk):
        out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                       softcap=softcap, block_q=bq, block_k=bk,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, bq=bq, bk=bk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        kw = ctx.kw
        dq, dk, dv = ops.flash_attention_bwd(
            q, k, v, out, lse, do.to(q.dtype).contiguous(), causal=kw["causal"],
            window=kw["window"], softcap=kw["softcap"], block_q=kw["bq"], block_k=kw["bk"])
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """q: [B,L,H,hd]; k,v: [B,S,Hkv,hd] → [B,L,H,hd], differentiable.

    The backward's tiles are ``bq = min(block_q, L)`` and ``bk = min(block_k,
    S)``; L and S must tile by them, else ``ValueError``, as in the
    reference.
    """
    l, s_len = q.shape[1], k.shape[1]
    bq, bk = min(block_q, l), min(block_k, s_len)
    if l % bq or s_len % bk:
        raise ValueError(f"flash: L={l}/S={s_len} must tile by ({bq},{bk})")
    return _Flash.apply(q, k, v, bool(causal), int(window), float(softcap), bq, bk)
