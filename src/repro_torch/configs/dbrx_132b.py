"""dbrx-132b [moe] — 16 experts top-4 (hf:databricks/dbrx-base).

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.
"""

from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48, n_kv_heads=8,
    d_ff=10_752,
    vocab=100_352,
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10_752, num_shared=0),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=112, vocab=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=112, num_shared=0),
)
