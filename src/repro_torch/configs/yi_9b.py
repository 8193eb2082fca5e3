"""yi-9b [dense] — llama-arch GQA (arXiv:2403.04652).

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32, n_kv_heads=4,
    d_ff=11_008,
    vocab=64_000,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
)
