"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]. 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64; shared attention block applied every 6 Mamba2 layers."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", arch_type="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", arch_type="hybrid", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, attn_every=2,
)
