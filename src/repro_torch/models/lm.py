"""LM assembly for the dense decoder patterns ("attn", "local").

The port of :mod:`repro.models.lm` for the serving slice.  The parameter
tree is the JAX package's: ``cfg.layer_pattern`` is cycled across
``n_layers``; each pattern slot owns one tree stacked over the ``[G]`` full
repetitions (``blocks/s{i}``), the remainder layers are unstacked
(``rem/r{i}``).  The JAX ``lax.scan`` over groups is a Python loop here.

Entry points
  * :func:`init` — parameters on ``device`` from a ``torch.Generator``.
  * :func:`forward` — tokens → logits.
  * :func:`prefill` — forward that also seeds a decode cache.
  * :func:`decode_step` — one token against the cache.

MoE, SSM, RG-LRU, enc-dec and VLM configs raise ``NotImplementedError``
naming the slice of the port that brings them (see ``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import attention, mlp
from repro_torch.models.common import (ModelConfig, dense_init, embed_init,
                                       rms_norm, softcap)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for configs outside the dense slice."""
    missing = None
    if cfg.moe is not None:
        missing = "MoE layers (ROADMAP: next slices, MoE/enc-dec/VLM)"
    elif cfg.enc_dec or cfg.frame_input:
        missing = "the enc-dec encoder (ROADMAP: next slices, MoE/enc-dec/VLM)"
    elif cfg.n_patches:
        missing = "the VLM patch prefix (ROADMAP: next slices, MoE/enc-dec/VLM)"
    elif "ssm" in cfg.layer_pattern:
        missing = "Mamba2 SSM layers (ROADMAP: next slices, Mamba2)"
    elif "rglru" in cfg.layer_pattern:
        missing = "RG-LRU layers (ROADMAP: next slices, RecurrentGemma)"
    if missing:
        raise NotImplementedError(f"{cfg.name}: {missing} are not ported yet")


# ==========================================================================
# Init
# ==========================================================================


def groups_of(cfg: ModelConfig, n_layers: int | None = None) -> Tuple[int, int]:
    """(full pattern repetitions, remainder layers)."""
    n = cfg.n_layers if n_layers is None else n_layers
    p = len(cfg.layer_pattern)
    return n // p, n % p


def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, *, device,
                lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    d, pd = cfg.d_model, cfg.pdtype

    def norm():
        return torch.zeros(tuple(lead) + (d,), dtype=pd, device=device)

    p: Dict[str, Any] = {"ln1": norm(),
                         "attn": attention.init(gen, cfg, device=device, lead=lead)}
    if cfg.d_ff:
        p["ln2"] = norm()
        p["mlp"] = mlp.init(gen, cfg, device=device, lead=lead)
    if cfg.post_norms:
        p["ln1b"] = norm()
        if cfg.d_ff:
            p["ln2b"] = norm()
    return p


def init(gen: torch.Generator, cfg: ModelConfig, *, device="cuda") -> Dict[str, Any]:
    """Random parameters with the JAX package's tree layout.

    ``gen`` must live on ``device`` (``torch.Generator(device=...)``).  The
    numbers differ from ``repro.models.lm.init``'s; parity goes through
    converted weights (:mod:`repro_torch.convert`).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    g, rem = groups_of(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype, device=dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=dev),
        "blocks": {f"s{i}": _block_init(gen, cfg, kind, device=dev, lead=(g,))
                   for i, kind in enumerate(cfg.layer_pattern)},
    }
    if rem:
        params["rem"] = {
            f"r{i}": _block_init(gen, cfg, cfg.pattern_of(g * len(cfg.layer_pattern) + i),
                                 device=dev)
            for i in range(rem)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       cfg.pdtype, device=dev)
    return params


def _index(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ==========================================================================
# Block application (prefill / forward)
# ==========================================================================


def _block_apply(cfg: ModelConfig, kind: str, p: Dict[str, Any], x: torch.Tensor,
                 positions: torch.Tensor, collect_kv: bool):
    """Returns (x, kv or None)."""
    window = cfg.window if kind == "local" else 0
    kv = None
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    if collect_kv:
        a, (k_new, v_new) = attention.apply_with_kv(p["attn"], cfg, h, positions,
                                                    window=window)
        kv = {"k": k_new, "v": v_new}
    else:
        a = attention.apply(p["attn"], cfg, h, positions, window=window)
    if cfg.post_norms:
        a = rms_norm(a, p["ln1b"], cfg.rms_eps)
    x = x + a
    if cfg.d_ff:
        h = rms_norm(x, p["ln2"], cfg.rms_eps)
        f = mlp.apply(p["mlp"], cfg, h)
        if cfg.post_norms:
            f = rms_norm(f, p["ln2b"], cfg.rms_eps)
        x = x + f
    return x, kv


def _run_blocks(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, collect_kv: bool):
    """The stacked pattern groups in order, then the remainder layers.

    Returns (x, caches): caches[f"s{i}"] holds k/v stacked over groups and
    caches[f"r{i}"] the remainder layers' k/v, when ``collect_kv``.
    """
    pattern = cfg.layer_pattern
    g, _ = groups_of(cfg)
    per_slot: Dict[str, list] = {f"s{i}": [] for i in range(len(pattern))}
    for gi in range(g):
        gp = _index(params["blocks"], gi)
        for i, kind in enumerate(pattern):
            x, kv = _block_apply(cfg, kind, gp[f"s{i}"], x, positions, collect_kv)
            if collect_kv:
                per_slot[f"s{i}"].append(kv)
    caches: Dict[str, Any] = {}
    if collect_kv:
        caches = {name: {key: torch.stack([kv[key] for kv in kvs])
                         for key in ("k", "v")}
                  for name, kvs in per_slot.items()}
    for i, (name, rp) in enumerate(sorted(params.get("rem", {}).items())):
        kind = cfg.pattern_of(g * len(pattern) + i)
        x, kv = _block_apply(cfg, kind, rp, x, positions, collect_kv)
        if collect_kv:
            caches[name] = kv
    return x, caches


# ==========================================================================
# Embedding / head
# ==========================================================================


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    ct = cfg.cdtype
    x = params["embed"][tokens.long()].to(ct)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=ct, device=x.device)
    return x


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    ct = cfg.cdtype
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(ct)
    return softcap(logits.float(), cfg.logit_softcap)


def _positions(b: int, l: int, device) -> torch.Tensor:
    return torch.arange(l, device=device)[None].expand(b, l)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, L] → (logits [B, L, Vp] fp32, aux).  aux is 0 for dense
    configs (it carries the MoE load-balance loss in the JAX package)."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, l, _ = x.shape
    x, _ = _run_blocks(params, cfg, x, _positions(b, l, x.device), collect_kv=False)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


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


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int):
    """Run the full prompt, seed the decode cache.

    Returns (cache, last_logits [B, Vp]).  ``max_len`` sizes the KV rings of
    full-attention layers (prompt + decode budget).
    """
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, l, _ = x.shape
    x, raw = _run_blocks(params, cfg, x, _positions(b, l, x.device), collect_kv=True)
    pattern = cfg.layer_pattern
    g, _ = groups_of(cfg)
    cache: Dict[str, Any] = {"blocks": {}, "rem": {}}
    for name, kv in raw.items():
        if name[0] == "s":
            kind, group = pattern[int(name[1:])], "blocks"
        else:
            kind, group = cfg.pattern_of(g * len(pattern) + int(name[1:])), "rem"
        slots = _attn_slots(cfg, kind, max_len)
        cache[group][name] = {"k": _ring_from_prefill(kv["k"], slots),
                              "v": _ring_from_prefill(kv["v"], slots)}
    if not cache["rem"]:
        del cache["rem"]
    cache["pos"] = l
    logits = _logits(params, cfg, x[:, -1:, :])[:, 0, :]
    return cache, logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Dict[str, Any]:
    """Empty decode cache (zeros; ``pos`` at the last slot, as in JAX)."""
    check_supported(cfg)
    dev = resolve_device(device)
    g, rem = groups_of(cfg)
    ct = cfg.cdtype

    def one(kind: str, lead: Tuple[int, ...]):
        shape = tuple(lead) + (batch, _attn_slots(cfg, kind, max_len),
                               cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=ct, device=dev),
                "v": torch.zeros(shape, dtype=ct, device=dev)}

    cache: Dict[str, Any] = {"blocks": {
        f"s{i}": one(kind, (g,)) for i, kind in enumerate(cfg.layer_pattern)}}
    if rem:
        cache["rem"] = {f"r{i}": one(cfg.pattern_of(g * len(cfg.layer_pattern) + i), ())
                        for i in range(rem)}
    cache["pos"] = max_len - 1
    return cache


def _block_decode(cfg: ModelConfig, kind: str, p, x, gc, pos: int):
    """One block, one token. x: [B,1,D] → x (gc's k/v rings updated in place)."""
    window = cfg.window if kind == "local" else 0
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    a, _ = attention.decode_step(p["attn"], cfg, h, gc, pos, window=window)
    if cfg.post_norms:
        a = rms_norm(a, p["ln1b"], cfg.rms_eps)
    x = x + a
    if cfg.d_ff:
        h = rms_norm(x, p["ln2"], cfg.rms_eps)
        f = mlp.apply(p["mlp"], cfg, h)
        if cfg.post_norms:
            f = rms_norm(f, p["ln2b"], cfg.rms_eps)
        x = x + f
    return x


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole batch.  token: [B,1] → logits [B, Vp].

    The KV rings are updated in place; the returned cache shares them with
    the one passed in and carries ``pos + 1``.
    """
    pos = cache["pos"]
    x = _embed(params, cfg, token)
    pattern = cfg.layer_pattern
    g, _ = groups_of(cfg)
    for gi in range(g):
        gp = _index(params["blocks"], gi)
        for i, kind in enumerate(pattern):
            gc = _index(cache["blocks"][f"s{i}"], gi)
            x = _block_decode(cfg, kind, gp[f"s{i}"], x, gc, pos)
    for i, (name, rp) in enumerate(sorted(params.get("rem", {}).items())):
        kind = cfg.pattern_of(g * len(pattern) + i)
        x = _block_decode(cfg, kind, rp, x, cache["rem"][name], pos)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    logits = _logits(params, cfg, x)[:, 0, :]
    return logits, new_cache
