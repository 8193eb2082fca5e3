"""deepseek-moe-16b [moe] — fine-grained MoE, arXiv:2401.06066.

28L d_model=2048 16H (GQA kv=16) vocab=102400; 2 shared + 64 routed top-6
experts of width 1408.
"""

from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16, n_kv_heads=16,
    d_ff=1408,                        # flag only; experts define the FFN
    vocab=102_400,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=96, num_shared=1),
)
