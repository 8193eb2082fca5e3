"""PyTorch/CUDA port of the Jointλ model stack (serving slice).

The package mirrors :mod:`repro`'s layout module for module, holds the same
nested-dict parameter trees (same keys, same leading ``[G]`` group dim of the
stacked blocks), and never imports JAX or :mod:`repro`.  The framework-free
runtime it needs (``backends/``, ``core/``, ``configs/shapes.py`` and the arch
data modules) is kept here as verbatim copies with ``repro.`` rewritten to
``repro_torch.``.

Entry points take an explicit ``device=`` and default to ``"cuda"``: on a
machine without a card they raise unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if it asks for a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev
