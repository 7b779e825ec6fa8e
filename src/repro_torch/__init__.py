"""PyTorch port of the CLOES cascade-ranking system for one NVIDIA H100.

The JAX package `repro` is the reference; this package computes the same
things in PyTorch, with hand-written CUDA C++ kernels (`csrc/`, built for
sm_90a on first use) on the serving hot path. It imports neither `jax`
nor `repro`.

Every entry point takes `device=` and defaults to "cuda"; the tests pass
device="cpu", where each kernel wrapper runs its plain PyTorch version.
"""
