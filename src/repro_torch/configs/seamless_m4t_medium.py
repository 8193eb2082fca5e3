"""seamless-m4t-medium [audio] — enc-dec multimodal backbone (arXiv:2308.11596).

12L (decoder) + 12L encoder, d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=256206.  The speech frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings ([B, S/8, 1024]).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16, n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    enc_dec=True,
    n_enc_layers=12,
    frame_input=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    n_enc_layers=2,
)
