"""The CLOES cascade model (paper §3.1, Eqs 1–3).

A T-stage cascade of logistic classifiers. Stage j uses a fixed binary feature
mask f_{C_j} over the query-item features x and the full query-only features
g(q):

    p_{q,x,j} = sigma( w_{x,j}^T f_{C_j}(x) + w_{q,j}^T g(q) )            (Eq 1)
    p(y=1|q,x) = prod_j p_{q,x,j}                                          (Eq 2)

Parameters are a flat dict of float32 tensors {"w_x" (T, d_x), "w_q"
(T, d_q), "b" (T,)}, the reference's pytree layout, so params move between
the two packages as numpy arrays (`params_from_numpy`). Shapes use the
query-grouped batch layout (B groups, G items per group).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]
PARAM_KEYS = ("w_x", "w_q", "b")


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    n_stages: int
    d_x: int
    d_q: int
    # static (T, d_x) binary feature masks — which features each stage sees.
    # Stored as nested tuples so the config is hashable.
    masks: Any = None
    # per-item evaluation cost t_j of each stage (newly-computed features)
    stage_times: Any = None     # tuple (T,)

    def __post_init__(self):
        if self.masks is None or self.stage_times is None:
            raise ValueError("CascadeConfig needs masks and stage_times")
        object.__setattr__(self, "masks",
                           tuple(tuple(float(v) for v in row)
                                 for row in np.asarray(self.masks)))
        object.__setattr__(self, "stage_times",
                           tuple(float(v) for v in np.asarray(self.stage_times)))

    @property
    def t(self) -> np.ndarray:
        return np.asarray(self.stage_times)


def params_from_numpy(params: dict[str, np.ndarray], device="cuda") -> Params:
    """The port's params from numpy arrays of the reference layout — e.g.
    `jax.device_get` of a JAX fit or init, or a `.npz` of one — so that
    both packages compute the same cascade."""
    missing = [k for k in PARAM_KEYS if k not in params]
    if missing:
        raise ValueError(f"params missing {missing} "
                         f"(expected keys {PARAM_KEYS})")
    out = {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
           for k in PARAM_KEYS}
    t = out["b"].shape[0]
    if (out["w_x"].ndim != 2 or out["w_q"].ndim != 2 or out["b"].ndim != 1
            or out["w_x"].shape[0] != t or out["w_q"].shape[0] != t):
        raise ValueError("params shapes do not form a cascade: "
                         f"{ {k: tuple(v.shape) for k, v in out.items()} }")
    return out


@functools.lru_cache(maxsize=32)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def masks_tensor(cfg: CascadeConfig, device) -> torch.Tensor:
    """The (T, d_x) stage masks on `device`: made once per config and
    device, so a served chunk copies no constant to the card. Read-only."""
    return _constant(cfg.masks, torch.float32, torch.device(device))


def stage_times_tensor(cfg: CascadeConfig, dtype: torch.dtype,
                       device) -> torch.Tensor:
    """The (T,) stage times t_j on `device`, cached as `masks_tensor`."""
    return _constant(cfg.stage_times, dtype, torch.device(device))


def stage_logits(params: Params, cfg: CascadeConfig,
                 x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-stage pre-sigmoid scores.

    x: (..., d_x) query-item features; q: (..., d_q) query-only features
    (broadcast over the item axis). Returns (..., T).
    """
    w_eff = params["w_x"] * masks_tensor(cfg, x.device)       # (T, d_x)
    zx = torch.einsum("...d,td->...t", x, w_eff)
    zq = torch.einsum("...d,td->...t", q, params["w_q"])
    if zq.ndim < zx.ndim:  # q is (B, d_q) while x is (B, G, d_x)
        zq = zq[..., None, :] if zx.ndim - zq.ndim == 1 else zq
    return zx + zq + params["b"]


def stage_probs(params: Params, cfg: CascadeConfig,
                x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p_{q,x,j} for every stage: (..., T)."""
    return torch.sigmoid(stage_logits(params, cfg, x, q))


def pass_probs(params: Params, cfg: CascadeConfig,
               x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Cumulative pass probability p_{q,x,pass_k} = prod_{j<=k} p_j (Eq 6)."""
    return torch.cumprod(stage_probs(params, cfg, x, q), dim=-1)


def log_pass_probs(params: Params, cfg: CascadeConfig,
                   x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """log of Eq 6 via log-sigmoid cumsum — numerically stable for the NLL."""
    return torch.cumsum(F.logsigmoid(stage_logits(params, cfg, x, q)), dim=-1)


def final_prob(params: Params, cfg: CascadeConfig,
               x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p(y=1|q,x) = product over all T stages (Eq 2)."""
    return pass_probs(params, cfg, x, q)[..., -1]


def final_score(params: Params, cfg: CascadeConfig,
                x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Ranking score = log p(y=1|q,x); monotone in Eq 2, stable."""
    return log_pass_probs(params, cfg, x, q)[..., -1]


# ---------------------------------------------------------------------------
# Serving-time hard cascade: Eq 10 expected counts become stage thresholds.
# ---------------------------------------------------------------------------

def expected_counts_per_query(params: Params, cfg: CascadeConfig,
                              x: torch.Tensor, q: torch.Tensor,
                              mask: torch.Tensor,
                              m_q: torch.Tensor) -> torch.Tensor:
    """E[Count_{q,j}] ≈ (M_q / N_q) * sum_i p_pass_j  (Eq 10).

    x: (B, G, d_x), mask: (B, G), m_q: (B,). Returns (B, T).
    """
    pp = pass_probs(params, cfg, x, q) * mask[..., None]   # (B, G, T)
    n_q = torch.clamp_min(mask.sum(dim=-1), 1.0)           # (B,)
    return (m_q / n_q)[..., None] * pp.sum(dim=-2)


def hard_cascade_filter(params: Params, cfg: CascadeConfig,
                        x: torch.Tensor, q: torch.Tensor,
                        mask: torch.Tensor,
                        m_q: torch.Tensor) -> dict[str, torch.Tensor]:
    """Run the cascade as deployed: per stage keep the top-E[Count_{q,j}]
    items by cumulative score. Thin wrapper over
    core.pipeline.run_cascade(fused="none").

    Returns the survival mask after each stage (B, G, T), the final scores,
    and the per-stage survivor counts actually used.
    """
    from repro_torch.core import pipeline as P  # local: pipeline imports this module
    out = P.run_cascade(params, cfg, x, q, mask, m_q, fused="none")
    return {
        "survivors": out["survivors"],                     # (B, G, T)
        "scores": out["scores"],
        "kept_per_stage": out["kept_per_stage"],           # (B, T)
        "expected_counts": out["expected_counts"],
    }


def actual_cost_per_query(survivors: torch.Tensor, mask: torch.Tensor,
                          cfg: CascadeConfig) -> torch.Tensor:
    """Realized serving cost of the hard cascade, per query group:
    cost = sum_j (#items entering stage j) * t_j."""
    t = stage_times_tensor(cfg, survivors.dtype, survivors.device)
    entering = torch.cat(
        [mask.sum(-1, keepdim=True), survivors.sum(1)[:, :-1]], dim=-1)  # (B, T)
    return (entering * t).sum(-1)
