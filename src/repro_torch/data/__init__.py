"""Deterministic synthetic data pipeline (sharded host loading)."""

from repro_torch.data.synthetic import SyntheticLM, make_batch  # noqa: F401
