"""yi-34b — llama-architecture dense GQA [arXiv:2403.04652].
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", arch_type="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
)

SMOKE = ModelConfig(
    name="yi-smoke", arch_type="dense", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
)
