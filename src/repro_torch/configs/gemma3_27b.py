"""gemma3-27b — dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family]. 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144; sliding window 1024, every 6th layer global."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", arch_type="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv_heads=16, d_ff=21504, vocab=262144,
    head_dim=128, qk_norm=True, sliding_window=1024, global_every=6,
    mlp_act="gelu", rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", arch_type="dense", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
    head_dim=64, qk_norm=True, sliding_window=32, global_every=2,
    mlp_act="gelu",
)
