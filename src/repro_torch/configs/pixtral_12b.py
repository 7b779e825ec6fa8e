"""pixtral-12b — pixtral-ViT + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409]. Decoder: 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072, head_dim=128. The ViT vision encoder + projector is
a STUB per the brief: input_specs provides precomputed patch embeddings
(1024 positions) prepended to the text tokens."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", arch_type="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072,
    head_dim=128, frontend_positions=1024, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="pixtral-smoke", arch_type="dense", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
    head_dim=64, frontend_positions=16,
)
