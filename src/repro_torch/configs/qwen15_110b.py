"""qwen1.5-110b [dense] — QKV bias (hf:Qwen/Qwen1.5-110B family).

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64, n_kv_heads=8,
    d_ff=49_152,
    vocab=152_064,
    qkv_bias=True,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
)
