"""K8: one-token GQA flash-decode attention over a (windowed) KV cache
(`kernel.py` wraps `csrc/swa_decode.cu`; `ref.py` holds its plain PyTorch
version)."""
