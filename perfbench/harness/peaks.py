"""Published peaks of the cards the benchmark runs on.

NVIDIA's data sheet for the H100 SXM5 80 GB: dense rates without sparsity, at
the full 700 W power limit.  A card set below it runs slower under load; the
run prints its power limit beside its numbers.
"""

from __future__ import annotations

from typing import Dict, Optional

#: device name (``torch.cuda.get_device_name``) → peak rates
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,        # FLOP/s, tensor cores
        "float16": 989e12,
        "tf32": 495e12,
        "float32": 67e12,          # outside the tensor cores
        "hbm_bytes_s": 3.35e12,
    },
}

#: bytes of one element by the dtype names the profiler records
ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8, "long int": 8,
            "int": 4, "bfloat16": 2, "float16": 2, "float32": 4}


def peak(kind: str, what: str) -> Optional[float]:
    """The peak ``what`` of card ``kind``, or None for a card not in the table."""
    return PEAKS.get(kind, {}).get(what)


def flop_peak(kind: str, dtype: str) -> Optional[float]:
    """The product rate of ``dtype`` (a profiler dtype name) on ``kind``."""
    name = {"c10::BFloat16": "bfloat16", "c10::Half": "float16", "float": "float32"}.get(
        dtype, dtype)
    return peak(kind, name)
