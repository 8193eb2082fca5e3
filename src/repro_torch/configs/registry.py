"""Arch registry and ``input_specs()``: the port of ``repro.configs.registry``.

``input_specs(cfg, shape, device=...)`` returns every model input of one
(architecture × shape) cell as empty tensors on ``device``: on the ``meta``
device they hold no memory, and inside a ``FakeTensorMode`` they are fake
tensors of the card (the dry run's inputs, :mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import SHAPES, SUBQUADRATIC_FAMILIES, ShapeSpec
from repro_torch.models.common import ModelConfig

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "dbrx-132b": "dbrx_132b",
    "mistral-large-123b": "mistral_large_123b",
    "gemma2-27b": "gemma2_27b",
    "yi-9b": "yi_9b",
    "qwen1.5-110b": "qwen15_110b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "phi-3-vision-4.2b": "phi3_vision_42b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def skip_reason(arch: str, shape: str) -> Optional[str]:
    """None if the cell runs; otherwise why it is skipped."""
    cfg = get(arch)
    spec = SHAPES[shape]
    if spec.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return ("quadratic attention at 524k tokens — long-context cells run "
                "only for SSM/hybrid archs (assignment note)")
    return None


def runnable(arch: str, shape: str) -> bool:
    return skip_reason(arch, shape) is None


def all_cells() -> Tuple[Tuple[str, str], ...]:
    return tuple((a, s) for a in ARCHS for s in SHAPES)


# ==========================================================================
# input_specs
# ==========================================================================


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, device="cuda") -> Dict[str, Any]:
    """Model inputs of one cell, empty, on ``device``: the reference's keys,
    shapes and dtypes.

    train  → {tokens, labels, mask [, patches, frames]}
    prefill→ {tokens [, patches, frames]}
    decode → {token, cache}  (cache from ``lm.init_cache``, whose ``pos``
             is a Python int where the reference's is an int32 scalar)
    """
    b, l = shape.global_batch, shape.seq_len

    def empty(shape_, dtype):
        return torch.empty(tuple(shape_), dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        lt = l - cfg.n_patches                       # vlm: patches fill the rest
        out = {"tokens": empty((b, lt), torch.int32)}
        if shape.kind == "train":
            out["labels"] = empty((b, lt), torch.int32)
            out["mask"] = empty((b, lt), torch.float32)
        if cfg.n_patches:
            out["patches"] = empty((b, cfg.n_patches, 1024), torch.bfloat16)
        if cfg.frame_input:
            out["frames"] = empty((b, max(1, l // 8), 1024), torch.bfloat16)
        return out
    if shape.kind == "decode":
        from repro_torch.models import lm
        return {"token": empty((b, 1), torch.int32),
                "cache": lm.init_cache(cfg, b, l, device=device)}
    raise ValueError(shape.kind)
