"""gemma2-27b [dense] — local+global alternating, logit softcap (arXiv:2408.00118).

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; head_dim=128,
sliding window 4096 on local layers, attn softcap 50, final logit softcap 30.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32, n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab=256_000,
    layer_pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, window=16,
)
