"""K2: the fused cascade score + filter (`kernel.py` wraps
`csrc/cascade_filter.cu`; `ref.py` is its plain PyTorch version)."""
