"""Minimal optax-style optimizers, as in the reference (`optim/sgd.py`).

Each factory returns (init_fn, update_fn) where

    state = init_fn(params)
    updates, state = update_fn(grads, state, params)
    params = apply_updates(params, updates)

`params` is a dict of tensors (the cascade's w_x / w_q / b; nested for
the model zoo's trees) or one tensor (the trainer's raveled parameter
vector). The step counter is a host int; the trainer's checkpoints store it
as the reference's 0-d int32.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class OptPair(NamedTuple):
    init: Callable
    update: Callable


def _map(fn, *trees):
    """fn over the leaves of (nested) dicts of tensors with the same keys,
    or of tensors."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def apply_updates(params, updates):
    return _map(lambda p, u: p + u, params, updates)


def sgd(lr: float | Callable[[int], float]) -> OptPair:
    """Plain SGD — the paper's optimizer ('the Stochastic Gradient Descent
    algorithm is utilized because of its simplicity, speed, and stability')."""

    def init(params):
        return {"step": 0}

    def update(grads, state, params=None):
        step = state["step"]
        lr_t = lr(step) if callable(lr) else lr
        return _map(lambda g: -lr_t * g, grads), {"step": step + 1}

    return OptPair(init, update)


def momentum_sgd(lr: float | Callable[[int], float],
                 momentum: float = 0.9) -> OptPair:
    """mu = momentum * mu + g; update = -lr * mu (reference sgd.py:42-57)."""

    def init(params):
        return {"step": 0, "mu": _map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        step = state["step"]
        lr_t = lr(step) if callable(lr) else lr
        mu = _map(lambda m, g: momentum * m + g, state["mu"], grads)
        return _map(lambda m: -lr_t * m, mu), {"step": step + 1, "mu": mu}

    return OptPair(init, update)


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0,
                    min_frac: float = 0.1) -> Callable[[int], torch.Tensor]:
    """Linear warmup, then cosine decay to min_frac * base_lr; computed in
    float32, as the reference's schedule is."""

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp_max(step / max(warmup, 1), 1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * cos

    return lr
