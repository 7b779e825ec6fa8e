"""Optimizers of the port (the reference's `optim/sgd.py` and
`optim/adam.py`)."""

from repro_torch.optim.adam import adam
from repro_torch.optim.sgd import momentum_sgd, sgd

__all__ = ["sgd", "momentum_sgd", "adam"]
