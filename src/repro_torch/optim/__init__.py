"""Optimizers of the port (the reference's `optim/sgd.py`)."""

from repro_torch.optim.sgd import momentum_sgd, sgd

__all__ = ["sgd", "momentum_sgd"]
