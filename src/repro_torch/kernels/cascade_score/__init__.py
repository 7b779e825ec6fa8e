"""K1 and K3: the batched cascade scorer and its backward (`kernel.py` wraps
`csrc/cascade_score.cu` and `csrc/cascade_score_bwd.cu`; `ref.py` holds
their plain PyTorch versions)."""
