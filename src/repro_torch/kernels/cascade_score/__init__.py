"""K1 and K3, the batched cascade scorer and its backward, and K6 and K7,
the single-group and feature-major scorers (`kernel.py` wraps
`csrc/cascade_score.cu`, `csrc/cascade_score_bwd.cu` and
`csrc/cascade_score_single.cu`; `ref.py` holds their plain PyTorch
versions)."""
