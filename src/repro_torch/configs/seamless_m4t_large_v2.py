"""seamless-m4t-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].
24L (enc) + 24L (dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
The audio frontend (mel-spectrogram + conv feature extractor) is a stub,
as in the reference: the batch carries precomputed frame embeddings."""

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", arch_type="encdec", n_layers=24,
    n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, frontend_positions=1,  # marker: frontend embeds expected
)

SMOKE = ModelConfig(
    name="seamless-smoke", arch_type="encdec", n_layers=2, n_enc_layers=2,
    d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
    frontend_positions=1,
)
