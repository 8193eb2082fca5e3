"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend
(hf:microsoft/Phi-3-vision-128k-instruct).

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.  The CLIP frontend is
a STUB per the assignment: ``input_specs()`` supplies precomputed patch
embeddings ([B, 576, 1024]); the backbone projects and prepends them.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32, n_kv_heads=32,
    d_ff=8192,
    vocab=32_064,
    n_patches=576,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    n_patches=8,
)
