"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each is the naive semantics, independent of the kernel's tiling: the CPU
path of :mod:`repro_torch.kernels.ops` and the yardstick the card's kernels
are held against.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models import attention as _attn


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The scans' working type: fp32, or fp64 for fp64 inputs (the tests'
    gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32

#: The JAX package's kernel cases (tests/test_kernels.py FLASH_CASES), the
#: shapes and tolerances the flash kernel is held to on the card and its
#: plain version on the CPU: (b, l, h, hkv, hd, window, softcap, dtype, tol).
FLASH_CASES = [
    (2, 256, 8, 4, 64, 0, 0.0, "float32", 2e-5),
    (1, 512, 4, 1, 32, 0, 0.0, "float32", 2e-5),
    (2, 256, 8, 8, 64, 128, 0.0, "float32", 2e-5),
    (1, 256, 4, 2, 128, 0, 30.0, "float32", 2e-5),
    (1, 512, 8, 2, 64, 128, 50.0, "float32", 2e-5),
    (2, 256, 8, 4, 64, 0, 0.0, "bfloat16", 2e-2),
    (1, 256, 16, 16, 32, 64, 0.0, "bfloat16", 2e-2),
]

#: Head dim 256 (recurrentgemma-9b's local attention), beyond the reference's
#: cases, at the same tolerances; one case has a window shorter than L.
FLASH_HD256_CASES = [
    (1, 256, 4, 1, 256, 0, 0.0, "float32", 2e-5),
    (1, 1024, 4, 1, 256, 256, 0.0, "float32", 2e-5),
    (2, 256, 8, 2, 256, 0, 30.0, "bfloat16", 2e-2),
    (1, 1024, 16, 1, 256, 256, 0.0, "bfloat16", 2e-2),
]

#: Head dim 96 (phi-3-vision-4.2b: d 3072 over 32 heads), beyond the
#: reference's cases, at the same tolerances: GQA groups 4 and 1 (MHA, as
#: phi-3-vision), a window and a softcap, in fp32 (fma) and bf16 (wgmma).
FLASH_HD96_CASES = [
    (1, 256, 4, 1, 96, 0, 0.0, "float32", 2e-5),
    (1, 256, 4, 4, 96, 64, 30.0, "float32", 2e-5),
    (2, 128, 8, 2, 96, 0, 0.0, "bfloat16", 2e-2),
    (1, 256, 8, 8, 96, 64, 50.0, "bfloat16", 2e-2),
]

#: bf16 cases of the wgmma variant beyond the reference's, all at tol 2e-2:
#: (b, l, h, hkv, hd, causal, window, softcap).  Every head dim it takes, GQA
#: groups 1–16, L a multiple of 64 but not of 128 (192, 576) or of neither
#: (100), window, softcap and the non-causal path.
FLASH_WGMMA_CASES = [
    (2, 192, 8, 2, 16, True, 0, 0.0),
    (1, 576, 8, 1, 32, True, 0, 0.0),
    (2, 100, 8, 8, 64, True, 0, 0.0),
    (1, 192, 16, 1, 128, True, 64, 0.0),
    (1, 576, 32, 4, 128, True, 0, 50.0),
    (2, 192, 8, 2, 128, False, 0, 0.0),
    (1, 100, 8, 1, 128, False, 0, 0.0),
    (1, 576, 4, 1, 256, True, 0, 30.0),
    (1, 100, 4, 2, 256, True, 40, 0.0),
    (2, 192, 16, 1, 256, True, 0, 0.0),
    (2, 192, 8, 2, 96, True, 0, 0.0),
    (1, 576, 32, 8, 96, True, 0, 50.0),
    (2, 100, 8, 8, 96, True, 0, 0.0),
    (1, 192, 16, 4, 96, True, 64, 0.0),
    (2, 192, 8, 8, 96, False, 0, 0.0),
    (1, 100, 8, 2, 96, False, 0, 0.0),
]

#: A sliding window without causal masking, which the reference's kernel
#: applies (``repro/kernels/flash_attention.py:57-58,73-74``): (b, l, h, hkv,
#: hd, window, dtype, tol), L = S.  fp32 runs the fma variant, bf16 the wgmma
#: one; windows shorter than a key tile, and L not a multiple of 128.
FLASH_WINDOW_CASES = [
    (1, 128, 4, 2, 32, 32, "float32", 2e-5),
    (2, 256, 8, 2, 64, 64, "float32", 2e-5),
    (1, 256, 8, 2, 64, 64, "bfloat16", 2e-2),
    (1, 512, 8, 1, 128, 100, "bfloat16", 2e-2),
    (2, 192, 8, 2, 128, 32, "bfloat16", 2e-2),
    (1, 256, 4, 1, 256, 64, "bfloat16", 2e-2),
    (1, 256, 8, 2, 96, 64, "float32", 2e-5),
    (1, 192, 8, 8, 96, 48, "bfloat16", 2e-2),
]

#: tests/test_kernels.py SSD_CASES: (bt, l, h, p, n, chunk, dtype, tol)
SSD_CASES = [
    (2, 128, 4, 16, 32, 32, "float32", 2e-4),
    (1, 256, 2, 64, 128, 64, "float32", 2e-4),
    (2, 64, 8, 32, 16, 64, "float32", 2e-4),
    (1, 128, 4, 16, 32, 32, "bfloat16", 5e-2),
]

#: bf16 cases of the SSD kernel's mma variant beyond the reference's, all at
#: y 5e-2 and final state 2e-4: (bt, l, h, p, n, chunk).  P 16–128, N 16–128
#: and Q 16–256 (48 and 80 not multiples of the 64-row tile); one chunk, and
#: 2, 3 and 8 (the long carry); the mamba2-370m serving dims; the last is
#: :data:`SSD_STRESS_CASE`.  Inputs follow the model's recipe, A =
#: −linspace(1, 16, H) and dt = softplus(N(0,1) + log(expm1(dt0))) with dt0
#: from :func:`ssd_dt0`: the reference test's dt ~ 0.8 and A down to −7.4
#: would drive cum towards −1500 in a chunk of 256, where the ulp of cum
#: alone nears the state's 2e-4 tolerance, whatever the kernel does.
SSD_MMA_CASES = [
    (1, 16, 2, 16, 16, 16),
    (2, 64, 4, 32, 48, 32),
    (1, 240, 3, 64, 80, 80),
    (2, 96, 2, 128, 128, 48),
    (1, 192, 4, 128, 64, 192),
    (1, 256, 2, 64, 112, 128),
    (1, 2048, 2, 16, 32, 256),
    (2, 512, 8, 64, 128, 256),
    (1, 512, 4, 32, 64, 256),
]
#: the stress case: a larger dt (dt0 0.02) takes the steepest head's cum to
#: between −100 and −200 within a chunk of 256, past the −88 at which
#: exp(−cum_j) overflows fp32 (tests assert the range)
SSD_STRESS_CASE = SSD_MMA_CASES[-1]


def ssd_dt0(case: tuple) -> float:
    """dt0 of an :data:`SSD_MMA_CASES` entry: 0.01, as the port's mamba2
    init (dt_bias = log(expm1(0.01))), and 0.02 for :data:`SSD_STRESS_CASE`."""
    return 0.02 if tuple(case) == SSD_STRESS_CASE else 0.01


#: tests/test_kernels.py RGLRU_CASES: (bt, l, w, bl, bw, dtype, atol); rtol 1e-3
RGLRU_CASES = [
    (2, 128, 64, 64, 64, "float32", 1e-5),
    (1, 512, 128, 128, 128, "float32", 1e-5),
    (2, 256, 64, 128, 32, "float32", 1e-5),
    (1, 128, 128, 32, 128, "bfloat16", 2e-2),
]

#: RG-LRU cases beyond the reference's 4, in its layout and at its fp32
#: tolerance: its long carry (L 1024 over 16 tiles of 64), one step, part
#: tiles of the kernel's 256 steps (L 100, 300), W = 6 (the scalar variant),
#: W = 100 (a block with one of its 8 float4 columns in use) and a long
#: sequence (16 of the kernel's tiles).
RGLRU_EDGE_CASES = [
    (1, 1024, 32, 64, 32, "float32", 1e-5),
    (2, 1, 64, 256, 256, "float32", 1e-5),
    (2, 100, 64, 256, 256, "float32", 1e-5),
    (2, 128, 6, 256, 256, "float32", 1e-5),
    (1, 300, 100, 300, 100, "float32", 1e-5),
    (1, 4096, 256, 256, 256, "float32", 1e-5),
]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Dense softmax attention. q: [B,L,H,hd]; k,v: [B,S,Hkv,hd]."""
    l, s = q.shape[1], k.shape[1]
    mask = (_attn.make_causal_mask(l, s, window=window, device=q.device)[None]
            if causal else None)
    return _attn._sdpa(q, k, v, mask, softcap)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """What the flash kernels compute: :func:`flash_attention_ref`, except that
    ``window`` also applies without ``causal`` (key j seen by query i iff
    j > i − window), as the reference's Pallas kernel masks it
    (``repro/kernels/flash_attention.py:57-58,73-74``).  Rows with no key in
    their window (L ≥ S + window) are outside the contract."""
    if causal or not window:
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return _attn._sdpa(q, k, v, _plain_mask(q.shape[1], k.shape[1], causal, window, q.device),
                       softcap)


def _plain_mask(l: int, s: int, causal: bool, window: int, device) -> Optional[torch.Tensor]:
    """The [1, L, S] mask :func:`flash_attention_plain` applies, or None."""
    if causal:
        return _attn.make_causal_mask(l, s, window=window, device=device)[None]
    if window:
        return _attn.make_window_mask(l, s, window=window, device=device)[None]
    return None


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, window: int = 0, softcap: float = 0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_plain` (the same ``out``, bit for bit) and each
    row's log-sum-exp, fp32 [B,H,L] = m + log(max(l, 1e-37)) over the
    scaled, capped, masked fp32 logits, head ``h = kv·G + g`` (the
    reference's [B,Hkv,G,L] lse, ``repro/models/flash.py:107-113``)."""
    out = flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    b, l, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    logits = torch.einsum("blkgd,bskd->bkgls", q.reshape(b, l, hkv, h // hkv, hd).float(),
                          k.float())
    logits = _attn.softcap(logits / torch.tensor(math.sqrt(hd), dtype=torch.float32), softcap)
    mask = _plain_mask(l, s, causal, window, q.device)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits,
                             torch.tensor(_attn.NEG_INF, dtype=torch.float32, device=q.device))
    m = logits.amax(dim=-1)
    lsum = torch.exp(logits - m[..., None]).sum(dim=-1)
    return out, (m + torch.log(torch.clamp(lsum, min=1e-37))).reshape(b, h, l)


def flash_bwd_mma_emulated(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                           causal: bool = True, window: int = 0, softcap: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward as the ``"wgmma"`` variant of the backward kernel
    (``csrc/flash_attention_bwd_sm90.cuh``; the ``mma.sync`` kernel it
    replaced rounded the same way) rounds it, for bf16 q, k, v, out, do
    and the forward's fp32 lse [B,H,L]: delta = rowsum(do·out), s = q·kᵀ and
    dp = do·vᵀ from bf16 operands into fp32 (exact products), p = exp(s_cap −
    lse) and ds = p·(dp − delta)·(1 − tanh²) in fp32, zero where masked; then
    p and ds rounded to bf16 as the A operands of pᵀ·do, dsᵀ·q and ds·k, fp32
    sums, each result rounded to bf16 once.  The tests hold that one
    rounding within the bf16 gradient tolerance, so p and ds need no bf16
    hi + lo split (the SSD mma backward's remedy).  The plain backward
    (``models/flash._flash_bwd_impl``) keeps p and ds fp32.  For the tests
    only."""
    b, l, h, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, l, hkv, g, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, l, hkv, g, hd)
    delta = (do.float() * out.float()).sum(-1).reshape(b, l, hkv, g)
    s = torch.einsum("blkgd,bskd->bkgls", qf, kf) * scale
    if softcap:
        t = torch.tanh(s / softcap)
        s, deriv = softcap * t, 1.0 - t * t
    mask = _plain_mask(l, s_len, causal, window, q.device)
    lse_g = lse.reshape(b, hkv, g, l)[..., None]
    p = torch.exp(s - lse_g)
    dp = torch.einsum("blkgd,bskd->bkgls", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap:
        ds = ds * deriv
    if mask is not None:
        p = torch.where(mask[:, None, None], p, torch.zeros((), device=q.device))
        ds = torch.where(mask[:, None, None], ds, torch.zeros((), device=q.device))
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgls,blkgd->bskd", p, dof)
    dk = torch.einsum("bkgls,blkgd->bskd", ds, qf) * scale
    dq = torch.einsum("bkgls,bskd->blkgd", ds, kf) * scale
    return dq.reshape(b, l, h, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x:[Bt,L,H,P] dt:[Bt,L,H] A:[H]<0  B,C:[Bt,L,N]  → (y:[Bt,L,H,P], h_last).

    The twin of ``repro.models.ssm.ssd_chunked``: all recurrence math in fp32
    (exponentials of within-chunk cumulative sums), y in x's dtype, h_last
    the fp32 ``[Bt,H,P,N]`` state after the last chunk.  L % chunk == 0.
    """
    bt, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    f32 = _wide(x.dtype)
    xc = x.reshape(bt, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bt, nc, chunk, h).to(f32)
    Bc = B.reshape(bt, nc, chunk, n).to(f32)
    Cc = C.reshape(bt, nc, chunk, n).to(f32)
    dA = dtc * A.to(f32)                                       # [Bt,NC,Q,H] ≤ 0
    cum = torch.cumsum(dA, dim=2)

    # intra-chunk: M[i,j] = C_i·B_j · exp(cum_i - cum_j) · dt_j for j ≤ i.
    # The mask goes inside the exp: above the diagonal exp(cum_i − cum_j)
    # overflows once cum falls 88 in a chunk, and autograd through
    # where(mask, exp(seg), 0) then meets 0·inf (the reference's ddt and dA
    # are NaN there); exp(−inf) = 0 has a zero derivative.  Values are the
    # same bit for bit.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [Bt,NC,Q,Q,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  torch.tensor(-math.inf, dtype=f32, device=x.device)))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    m = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)

    # chunk states S_c = Σ_j exp(cum_end - cum_j)·dt_j · B_j ⊗ x_j
    last = cum[:, :, -1:, :]
    w = torch.exp(last - cum) * dtc
    S = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, Bc, xc)

    # inter-chunk scan, emitting the state entering each chunk
    gamma = torch.exp(last[:, :, 0, :])                        # [Bt,NC,H]
    hcur = (torch.zeros((bt, h, p, n), dtype=f32, device=x.device) if h0 is None
            else h0.to(f32))
    h_in = []
    for c in range(nc):
        h_in.append(hcur)
        hcur = hcur * gamma[:, c, :, None, None] + S[:, c]
    h_in = torch.stack(h_in, dim=1)                            # [Bt,NC,H,P,N]

    y_inter = torch.einsum("bcih,bcin,bchpn->bcihp", torch.exp(cum), Cc, h_in)
    y = (y_intra + y_inter).reshape(bt, l, h, p)
    return y.to(x.dtype), hcur


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD recurrence (fp32); y only, as ``repro.kernels.ref.ssd_scan_ref``."""
    y, _ = ssd_chunked(x, dt, a, bmat, cmat, min(chunk, x.shape[1]))
    return y


def rglru_scan_ref(log_a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = exp(log_a_t)·h_{t-1} + b_t over axis 1, in fp32.

    The twin of ``repro.models.rglru.scan_ref``: a log-depth scan over the
    pairs (a, b) with (a₁,b₁)∘(a₂,b₂) = (a₁a₂, b₁a₂ + b₂), here the doubling
    (Hillis–Steele) form; an ``h0`` folds into the first step.
    """
    f32 = _wide(log_a.dtype)
    a = torch.exp(log_a.to(f32))
    b = b.to(f32)
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.to(f32)
    l = a.shape[1]
    d = 1
    while d < l:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


# ==========================================================================
# Backwards: the JAX package differentiates ssd_chunked and scan_ref by
# autodiff; its Pallas kernels have no backward.  The *_plain functions are
# that autodiff in torch (the yardstick of the backward kernels); the
# explicit formulas below are what the kernels compute.
# ==========================================================================


def rglru_scan_bwd_plain(log_a: torch.Tensor, b: torch.Tensor, dh: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dlog_a, db) of :func:`rglru_scan_ref` for the cotangent ``dh`` of h,
    by autograd, fp32."""
    with torch.enable_grad():
        la, bb = (t.detach().float().requires_grad_() for t in (log_a, b))
        grads = torch.autograd.grad(rglru_scan_ref(la, bb), (la, bb), dh.float(),
                                    allow_unused=True)     # L = 1 never reads log_a
    return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(grads, (la, bb)))


def rglru_scan_bwd_ref(log_a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The explicit backward of h_t = a_t·h_{t−1} + b_t (a_t = exp(log_a_t),
    h_{−1} = 0), from the forward's h: g_{L−1} = dh_{L−1}, g_t = dh_t +
    a_{t+1}·g_{t+1} (the same recurrence from the end, a shifted by one
    step); db = g; dlog_a_t = g_t·a_t·h_{t−1}.  Returns (dlog_a, db) in fp32
    (fp64 for fp64 log_a)."""
    f32 = _wide(log_a.dtype)
    la = log_a.to(f32)
    la_next = torch.cat([la[:, 1:], torch.zeros_like(la[:, :1])], dim=1)
    g = rglru_scan_ref(la_next.flip(1), dh.to(f32).flip(1)).flip(1)
    h_prev = torch.cat([torch.zeros_like(la[:, :1]), h[:, :-1].to(f32)], dim=1)
    return g * torch.exp(la) * h_prev, g


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, chunk: int, dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC) of :func:`ssd_chunked` for the cotangents ``dy``
    of y and ``dh_last`` of the final state (None: zero), by autograd; each
    gradient in its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
        y, h_last = ssd_chunked(*leaves, chunk)
        outs, cots = [y], [dy.to(y.dtype)]
        if dh_last is not None:
            outs.append(h_last)
            cots.append(dh_last.float())
        return torch.autograd.grad(outs, leaves, cots)


def ssd_chunked_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, chunk: int, dy: torch.Tensor,
                    dh_last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The explicit backward of :func:`ssd_chunked` (h0 = 0), in fp32 from x,
    B, C in either dtype (fp64 for fp64 x), in the chunked form the kernel
    computes.  Per
    (batch, chunk c, head), with cum the within-chunk cumsum of dt·A, L_ij =
    exp(cum_i − cum_j) for j ≤ i, cb_ij = C_i·B_j, w_j = exp(last −
    cum_j)·dt_j, γ_c = exp(last_c) and h_in[c] the state entering chunk c:

    * reverse state pass: G_NC = dh_last, G_c = γ_c·G_{c+1} + Σ_i
      exp(cum_i)·dy_i ⊗ C_i; dS_c = G_{c+1}, dγ_c = ⟨G_{c+1}, h_in[c]⟩;
    * with r_ij = dy_i·x_j and t_ij = r_ij·cb_ij·L_ij·dt_j (j ≤ i):
      dx_j = Σ_i cb_ij·L_ij·dt_j·dy_i + w_j·(dS_c B_j);
      dC_i = Σ_j r_ij·L_ij·dt_j·B_j + exp(cum_i)·h_in[c]ᵀdy_i (summed over heads);
      dB_j = Σ_i r_ij·L_ij·dt_j·C_i + w_j·dS_cᵀx_j (summed over heads);
      ddt_j = Σ_i r_ij·cb_ij·L_ij + (x_j·dS_c B_j)·exp(last − cum_j);
      dcum_i = Σ_j t_ij − Σ_k t_ki + exp(cum_i)·dy_i·(h_in[c] C_i)
               − (x_i·dS_c B_i)·w_i, plus d(last) = Σ_j (x_j·dS_c B_j)·w_j
               + dγ_c·γ_c at i = Q − 1;
    * d(dt·A)_k = Σ_{i≥k} dcum_i; ddt_k += d(dt·A)_k·A; dA = Σ d(dt·A)_k·dt_k.

    Returns (dx, ddt, dA, dB, dC): dx, dB, dC in x's, B's, C's dtypes, ddt
    and dA fp32.
    """
    bt, l, h, p = x.shape
    n = B.shape[-1]
    nc, q = l // chunk, chunk
    f32 = _wide(x.dtype)
    xc = x.reshape(bt, nc, q, h, p).to(f32)
    dyc = dy.reshape(bt, nc, q, h, p).to(f32)
    dtc = dt.reshape(bt, nc, q, h).to(f32)
    Bc = B.reshape(bt, nc, q, n).to(f32)
    Cc = C.reshape(bt, nc, q, n).to(f32)
    a = A.to(f32)
    cum = torch.cumsum(dtc * a, dim=2)                          # [Bt,NC,Q,H]
    last = cum[:, :, -1]                                        # [Bt,NC,H]
    gamma = torch.exp(last)
    ecum = torch.exp(cum)
    w = torch.exp(last[:, :, None] - cum) * dtc

    # state pass forward (h_in) and in reverse (dS_c = G_{c+1})
    S = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, Bc, xc)
    U = torch.einsum("bcih,bcin,bcihp->bchpn", ecum, Cc, dyc)
    hcur = torch.zeros((bt, h, p, n), dtype=f32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(hcur)
        hcur = hcur * gamma[:, c, :, None, None] + S[:, c]
    h_in = torch.stack(h_in, dim=1)                             # [Bt,NC,H,P,N]
    g = (torch.zeros((bt, h, p, n), dtype=f32, device=x.device) if dh_last is None
         else dh_last.to(f32))
    dS = [None] * nc
    for c in reversed(range(nc)):
        dS[c] = g
        g = g * gamma[:, c, :, None, None] + U[:, c]
    dS = torch.stack(dS, dim=1)
    dgamma = (dS * h_in).sum(dim=(-1, -2))                      # [Bt,NC,H]

    # within the chunk
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [Bt,NC,i,j,H]
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=f32, device=x.device))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
    r = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    m = decay * dtc[:, :, None, :, :]                            # L_ij·dt_j
    dx = torch.einsum("bcijh,bcihp->bcjhp", cb * m, dyc)
    dC = torch.einsum("bcijh,bcjn->bcin", r * m, Bc)
    dB = torch.einsum("bcijh,bcin->bcjn", r * m, Cc)
    v = r * cb * decay
    ddt = v.sum(dim=2)
    t = v * dtc[:, :, None, :, :]
    dcum = t.sum(dim=3) - t.sum(dim=2)

    # through the states
    dsb = torch.einsum("bchpn,bcjn->bcjhp", dS, Bc)              # dS_c B_j
    dx = dx + w[..., None] * dsb
    u = (xc * dsb).sum(dim=-1)                                   # x_j·dS_c B_j
    ddt = ddt + u * torch.exp(last[:, :, None] - cum)
    dcum = dcum - u * w
    dB = dB + torch.einsum("bcjh,bchpn,bcjhp->bcjn", w, dS, xc)
    hc = torch.einsum("bchpn,bcin->bcihp", h_in, Cc)             # h_in[c] C_i
    dcum = dcum + ecum * (dyc * hc).sum(dim=-1)
    dC = dC + torch.einsum("bcih,bchpn,bcihp->bcin", ecum, h_in, dyc)
    dlast = (u * w).sum(dim=2) + dgamma * gamma
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + dlast[:, :, None]], dim=2)

    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt + dda * a
    dA = (dda * dtc).sum(dim=(0, 1, 2))
    return (dx.reshape(x.shape).to(x.dtype), ddt.reshape(dt.shape), dA,
            dB.reshape(B.shape).to(B.dtype), dC.reshape(C.shape).to(C.dtype))


def block_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive sum over the last axis (≤ 256) in the order of the mma
    kernels' block scan: a Kogge-Stone scan in each warp of 32 lanes, the
    same over the warp totals, each lane then adding the totals of the warps
    before it."""
    q = v.shape[-1]
    nw = -(-q // 32)
    w = torch.nn.functional.pad(v, (0, nw * 32 - q)).reshape(*v.shape[:-1], nw, 32)

    def ks(t):
        d = 1
        while d < t.shape[-1]:
            t = torch.cat([t[..., :d], t[..., d:] + t[..., :-d]], -1)
            d *= 2
        return t

    w = ks(w)
    tot = ks(w[..., -1])
    w = torch.cat([w[..., :1, :], w[..., 1:, :] + tot[..., :-1, None]], -2)
    return w.reshape(*v.shape[:-1], nw * 32)[..., :q]


#: the fp32 operands of the mma backward's products, each split into bf16
#: hi + lo: X ⊙ w (S_c), dy ⊙ exp(cum) (U_c), dS_c and h_in[c] feed ddt and
#: da; the masked scores cb·L·dt (into dx) and r·L·dt (into dB and dC) feed
#: bf16 outputs that one rounding of them would put outside rtol 1e-2
SSD_BWD_SPLIT = frozenset({"xw", "dy_e", "ds", "h_in", "m1", "m2"})


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def ssd_chunked_bwd_mma(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor, chunk: int, dy: torch.Tensor,
                        dh_last: Optional[torch.Tensor] = None,
                        split=SSD_BWD_SPLIT) -> Tuple[torch.Tensor, ...]:
    """:func:`ssd_chunked_bwd` computed as the ``"mma"`` variant of the
    backward kernel (``csrc/ssd_scan_bwd_sm90.cu``) computes it, for bf16 x,
    B, C, dy.  Every product multiplies bf16 values into fp32 sums, so

    * C·Bᵀ and dy·xᵀ are exact up to summation order, and ddt and dcum take
      t_ij = r_ij·cb_ij·L_ij·dt_j from them in fp32;
    * an fp32 operand named in ``split`` (:data:`SSD_BWD_SPLIT`) is split
      into bf16 hi = bf16(v) and lo = bf16(v − hi); hi + lo is exact in fp32
      and its products with a bf16 value are too, so one product here
      equals the kernel's two; an operand left out is rounded once to bf16;
    * the state terms of dB and dC multiply bf16 x or dy by the split dS_c
      or h_in[c] and scale each row by w_j or exp(cum_i) afterwards;
      dγ_c = ⟨dS_c, h_in[c]⟩ takes h_in[c] as its split too;
    * cum comes from :func:`block_scan`; where cum never rises (A ≤ 0, dt ≥
      0) the decay of j before the 64-row tile of i is the product of
      exp(cum_i − cum_i0) and exp(cum_i0 − cum_j), i0 the tile's first row,
      both at most 1; the state pass and the rest of the chain run in fp32
      as :func:`ssd_chunked_bwd`.

    Returns (dx, ddt, dA, dB, dC) as :func:`ssd_chunked_bwd`."""
    bt, l, h, p = x.shape
    n = B.shape[-1]
    nc, q = l // chunk, chunk

    def hl(t, name):
        hi = _bf16(t)
        return hi + _bf16(t - hi) if name in split else hi

    def heads(t):                                                # b c h q ...
        return t.float().reshape(bt, nc, q, h, -1).permute(0, 1, 3, 2, 4)

    xc, dyc = heads(x), heads(dy)
    dtc = heads(dt)[..., 0]
    bc = B.float().reshape(bt, nc, 1, q, n)
    cc = C.float().reshape(bt, nc, 1, q, n)
    a = A.float()
    cum = block_scan(dtc * a[None, None, :, None])               # b c h q
    last = cum[..., -1:]
    el = torch.exp(last - cum)
    w = el * dtc
    ecum = torch.exp(cum)

    s_c = hl(xc * w[..., None], "xw").transpose(-1, -2) @ bc    # b c h p n
    u_c = hl(dyc * ecum[..., None], "dy_e").transpose(-1, -2) @ cc
    gamma = torch.exp(last[..., 0])                              # b c h
    hcur = torch.zeros((bt, h, p, n))
    h_in = []
    for c in range(nc):
        h_in.append(hcur)
        hcur = hcur * gamma[:, c, :, None, None] + s_c[:, c]
    h_in = torch.stack(h_in, dim=1)
    g = torch.zeros((bt, h, p, n)) if dh_last is None else dh_last.float()
    ds = [None] * nc
    for c in reversed(range(nc)):
        ds[c] = g
        g = g * gamma[:, c, :, None, None] + u_c[:, c]
    ds = torch.stack(ds, dim=1)
    dgamma = (ds * hl(h_in, "h_in")).sum(dim=(-1, -2))       # h_in[c] as passes 3–4 read it

    causal = torch.tril(torch.ones((q, q), dtype=torch.bool))
    decay = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                                  torch.tensor(-math.inf)))      # b c h i j
    if bool((a <= 0).all()) and bool((dt >= 0).all()):
        # where cum never rises, j before the 64-row tile of i takes the
        # factors exp(cum_i − cum_i0)·exp(cum_i0 − cum_j), i0 the tile's start
        i0 = torch.arange(q) // 64 * 64
        cref = cum[..., i0]
        factored = (torch.exp(cum - cref)[..., :, None]
                    * torch.exp(cref[..., :, None] - cum[..., None, :]))
        decay = torch.where(torch.arange(q)[None, :] < i0[:, None], factored, decay)
    cb = cc @ bc.transpose(-1, -2)                               # b c 1 i j
    r = dyc @ xc.transpose(-1, -2)                               # b c h i j
    v = r * cb * decay
    ddt = v.sum(dim=-2)                                          # column sums: b c h j
    t = v * dtc[..., None, :]
    dcum = t.sum(dim=-1) - t.sum(dim=-2)
    dx = hl(cb * decay * dtc[..., None, :], "m1").transpose(-1, -2) @ dyc
    m2 = hl(r * decay * dtc[..., None, :], "m2")
    db = m2.transpose(-1, -2) @ cc                               # b c h j n
    dc = m2 @ bc                                                 # b c h i n

    dsb = bc @ hl(ds, "ds").transpose(-1, -2)                    # dS_c B_j: b c h j p
    dx = dx + w[..., None] * dsb
    u = (xc * dsb).sum(dim=-1)
    ddt = ddt + u * el
    dcum = dcum - u * w
    db = db + w[..., None] * (xc @ hl(ds, "ds"))
    hc = cc @ hl(h_in, "h_in").transpose(-1, -2)                 # h_in[c] C_i: b c h i p
    dcum = dcum + ecum * (dyc * hc).sum(dim=-1)
    dc = dc + ecum[..., None] * (dyc @ hl(h_in, "h_in"))
    dlast = (u * w).sum(dim=-1) + dgamma * gamma
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + dlast[..., None]], dim=-1)

    dda = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), dim=-1), [-1])
    ddt = ddt + dda * a[None, None, :, None]
    dA = (dda * dtc).sum(dim=(0, 1, 3))

    def back(t):                                                 # b c h q k → b l h k
        return t.permute(0, 1, 3, 2, 4).reshape(bt, l, h, -1)

    return (back(dx).to(x.dtype), back(ddt[..., None])[..., 0], dA,
            db.sum(dim=2).reshape(B.shape).to(B.dtype), dc.sum(dim=2).reshape(C.shape).to(C.dtype))
