"""Arch registry: the port's copy of ``repro.configs.registry``.

The JAX registry imports JAX for ``input_specs`` (the dry-run's abstract
inputs), so the port keeps its own copy of the rest.  ``input_specs`` comes
with the dry-run tooling.
"""

from __future__ import annotations

import importlib
from typing import Optional, Tuple

from repro_torch.configs.shapes import SHAPES, SUBQUADRATIC_FAMILIES
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
