"""Kernels of the port: each TPU kernel on the path becomes a CUDA C++
kernel for sm_90a (`csrc/`) with its plain PyTorch version beside it
(`<kernel>/ref.py`). Call them through `kernels.ops`."""
