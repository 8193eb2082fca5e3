"""mistral-large-123b [dense] (hf:mistralai/Mistral-Large-Instruct-2407).

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12_288,
    n_heads=96, n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab=32_768,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=512,
)
