"""mamba2-370m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L d_model=1024, attention-free (d_ff=0), vocab=50280, ssm_state=128.
"""

from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16, n_kv_heads=16,       # unused (attention-free)
    d_ff=0,
    vocab=50_280,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, vocab=512,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
)
