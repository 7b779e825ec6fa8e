"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay
[arXiv:2404.05892]. 24L d_model=2048 d_ff=7168 vocab=65536."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", arch_type="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536,
    rwkv=True, rwkv_head_dim=64, rwkv_lora_dim=64, mlp_act="gelu",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", arch_type="ssm", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
    rwkv=True, rwkv_head_dim=32, rwkv_lora_dim=16, mlp_act="gelu",
)
