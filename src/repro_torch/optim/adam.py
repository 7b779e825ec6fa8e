"""Adam (the neural-ranker training path; the CLOES cascade itself uses
plain SGD per the paper), ported from the reference's `optim/adam.py`.

The step counter is a 0-d int32 tensor, as the reference's, so a
checkpoint of the state round-trips in either package; the bias
corrections are computed from it in float32."""

from __future__ import annotations

import torch

from repro_torch.optim.sgd import OptPair, _map


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> OptPair:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "m": _map(torch.zeros_like, params),
                "v": _map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(m_, v_, p):
            u = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p
            return u

        if params is None:
            params = _map(torch.zeros_like, m)
        return _map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return OptPair(init, update)
