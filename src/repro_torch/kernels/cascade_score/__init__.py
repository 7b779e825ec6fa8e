"""K1: the batched cascade scorer (`kernel.py` wraps `csrc/cascade_score.cu`;
`ref.py` is its plain PyTorch version)."""
