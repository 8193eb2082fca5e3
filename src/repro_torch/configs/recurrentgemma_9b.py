"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2 (arXiv:2402.19427).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; pattern
(rglru, rglru, local-attn) with window 2048; 38 = 12 full triples + 2
remainder recurrent layers (exercised by the unrolled-remainder path).
"""

from repro_torch.models.common import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16, n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab=256_000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    rglru=RGLRUConfig(lru_width=4096, conv_kernel=4, window=2048),
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512, window=16,
    rglru=RGLRUConfig(lru_width=64, conv_kernel=4, window=16),
)
