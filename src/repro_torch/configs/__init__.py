"""Assigned-architecture configs (one module per arch) + the shape registry.

``get(arch_id)`` returns the exact published configuration; ``get_smoke``
returns the reduced same-family variant the CPU tests use.
"""

from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, SHAPES, all_cells, get, get_smoke, runnable, skip_reason)
