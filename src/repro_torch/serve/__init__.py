"""Serving substrate: prefill/decode with KV caches, plus the ByRedundant
straggler-mitigated serving workflow (paper §3.3/§4.3.2)."""

from repro_torch.serve.engine import (  # noqa: F401
    greedy_generate, make_decode_step, make_prefill_step)
