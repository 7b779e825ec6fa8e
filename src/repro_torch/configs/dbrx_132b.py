"""dbrx-132b — fine-grained MoE, 16 experts top-4
[hf:databricks/dbrx-base]. 40L d_model=6144 48H (GQA kv=8) expert
d_ff=10752 vocab=100352."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352,
    n_experts=16, top_k=4, moe_d_ff=10752,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", arch_type="moe", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
    n_experts=4, top_k=2, moe_d_ff=512,
    capacity_factor=8.0,
)
