"""qwen3-8b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B].
36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, head_dim=128."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", arch_type="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12288, vocab=151936,
    head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", arch_type="dense", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
    head_dim=64, qk_norm=True,
)
