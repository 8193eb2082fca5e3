"""The assigned input-shape set (LM-family: seq_len × global_batch)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k requires sub-quadratic attention: SSM / hybrid (window-bounded
# attention + recurrence).  Quadratic archs skip it (noted in DESIGN.md §5).
SUBQUADRATIC_FAMILIES = {"ssm", "hybrid"}
