"""arctic-480b — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]. 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", arch_type="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
)

SMOKE = ModelConfig(
    name="arctic-smoke", arch_type="moe", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    n_experts=4, top_k=2, moe_d_ff=256, dense_residual=True,
    capacity_factor=8.0,
)
