"""Shared model primitives: config, norms, RoPE, initializers, dtype policy.

The port of :mod:`repro.models.common`.  Parameters are nested dicts of
tensors; every module is an ``init(gen, cfg, device=...) -> params`` +
``apply(params, x, ...) -> y`` pair.  Hot-path math runs in
``cfg.compute_dtype`` against ``cfg.param_dtype`` master weights, cast at the
same points as the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


# ==========================================================================
# Architecture config (same fields and defaults as the JAX package)
# ==========================================================================


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    num_shared: int = 0           # always-on shared experts (DeepSeek-MoE)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:                   # Mamba2 / SSD
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:                 # RecurrentGemma / Griffin
    lru_width: int = 0             # 0 ⇒ == d_model
    conv_kernel: int = 4
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")  # 1:2 attn:rglru
    window: int = 2048             # local-attention window


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 ⇒ d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # gemma2-style features
    attn_softcap: float = 0.0     # 0 ⇒ off
    logit_softcap: float = 0.0
    window: int = 0               # sliding window; 0 ⇒ full attention
    layer_pattern: Tuple[str, ...] = ("attn",)   # cycled across layers
    post_norms: bool = False      # gemma2 post-attn/post-ffn norms
    # family-specific sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # enc-dec (seamless-m4t)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # vlm (phi-3-vision): number of prepended patch-embedding positions
    n_patches: int = 0
    # audio (seamless): encoder consumes precomputed frame embeddings
    frame_input: bool = False
    embed_scale: bool = False     # gemma-family: x *= sqrt(d_model)
    aux_loss_weight: float = 0.01  # MoE load-balance loss weight
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    vocab_pad_to: int = 128       # pad embedding/vocab for TP divisibility
    # distribution & performance knobs
    remat: str = "dots"           # none | dots | full
    scan_layers: bool = True
    gather_dtype: str = ""        # "" ⇒ param_dtype

    # ---- derived ----------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to ``vocab_pad_to`` (same padding as the JAX side)."""
        p = self.vocab_pad_to
        return ((self.vocab + p - 1) // p) * p

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def pattern_of(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (for roofline MODEL_FLOPS = 6·N·D) -------------------

    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, embeddings included."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
        per_layer: Dict[str, int] = {}
        per_layer["attn"] = attn + 2 * d + (2 * d if self.post_norms else 0) + dense_ffn
        if self.moe is not None:
            e = self.moe.num_experts if not active_only else self.moe.top_k
            moe_ffn = 3 * d * self.moe.d_expert * (e + self.moe.num_shared)
            router = d * self.moe.num_experts
            per_layer["attn"] = attn + 2 * d + moe_ffn + router
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            # standard accounting: in_proj + out_proj dominate
            per_layer["ssm"] = d * 2 * di + di * d + d * 2 * self.ssm.d_state + d
        if self.rglru is not None:
            w = self.rglru.lru_width or d
            per_layer["rglru"] = d * w * 2 + w * d + 3 * w + 2 * d + dense_ffn
        n = 0
        for i in range(self.n_layers):
            pat = self.pattern_of(i)
            n += per_layer.get(pat, per_layer["attn"])
        if self.enc_dec:
            enc = self.n_enc_layers * (attn + 2 * d + dense_ffn)
            cross = self.n_layers * (attn + d)
            n += enc + cross
        n += self.vocab * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab * d                   # lm head
        return n


# ==========================================================================
# Numerics helpers
# ==========================================================================


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(−|x|)).  ``F.softplus`` returns x itself above a threshold of
    20 and rounds differently."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, scaled by ``(1 + scale)`` (params initialise to 0)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding at given positions [..., L]."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs                  # [..., L, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split (not interleaved) RoPE. x: [..., L, H, hd]; cos/sin: [..., L, hd/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ==========================================================================
# Initializers (params are plain nested dicts)
# ==========================================================================
#
# ``lead`` prefixes the shape so that stacked blocks are drawn directly as
# ``[G, ...]`` tensors: at full width a stack of per-layer tensors would hold
# the whole model twice while it is being built.


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype, *,
               device, scale: float = 1.0, lead: Sequence[int] = ()) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype, *,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts that share their keys (the
    parameter and train-state trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating-point leaf to ``dtype``; other leaves (integer
    counters) pass through."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)
