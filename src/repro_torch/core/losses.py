"""CLOES objectives (paper §3.2–3.3). The serving slice needs only the
loss configuration: `latency_scale` and `latency_convention` drive the
session's Eq-16 latency estimate. The losses themselves come with the
training slice."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LossConfig:
    alpha: float = 1e-4      # l2 regularization (Eq 5)
    beta: float = 1.0        # CPU-cost trade-off (Eq 9); paper sweeps 1..10
    delta: float = 1.0       # result-size penalty weight (Eq 15); paper: 1
    eps_latency: float = 0.05  # latency penalty weight (Eq 15 'epsilon'); paper: 0.05
    gamma: float = 0.05      # smooth-hinge sharpness (Eq 14)
    n_o: float = 200.0       # minimum result size N_o (paper: 200)
    t_l: float = 130.0       # latency budget T_l in ms (paper: 130 ms)
    # Converts per-item cost units to ms, calibrated jointly with the
    # synthetic recall distribution (see the reference's LossConfig).
    latency_scale: float = 0.0015
    # importance weights (Eq 17)
    eps_purchase: float = 1.0  # 'epsilon': purchase weight multiplier (paper: 10)
    mu_price: float = 1.0      # 'mu': price weight multiplier (paper sweeps 1..4)
    # Eq 16 as printed uses t_j * E[Count_{q,j}]; 'entering' uses the Eq-8
    # convention t_j * E[Count_{q,j-1}] with Count_{q,0} = M_q (items
    # entering stage j pay t_j) and is the default.
    latency_convention: str = "entering"
    # Count the expected cost (Eq 8) over negative instances only.
    cost_mask_positives: bool = False
