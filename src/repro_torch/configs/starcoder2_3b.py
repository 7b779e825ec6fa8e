"""starcoder2-3b — dense GQA kv=2, RoPE [arXiv:2402.19173].
30L d_model=3072 24H d_ff=12288 vocab=49152; GELU MLP."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", arch_type="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152,
    mlp_act="gelu",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", arch_type="dense", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512, mlp_act="gelu",
)
