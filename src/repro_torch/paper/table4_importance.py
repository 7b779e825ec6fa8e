"""Paper Table 4: the importance-weight sweep (epsilon = purchase weight,
mu = price weight) -> CTR / #orders / GMV / unit price deltas against the
epsilon=1, mu=1 variant, under the simulated-user online model. The
port's counterpart of `benchmarks/table4_importance.py`.

    python -m repro_torch.paper.table4_importance [--scale ci|paper] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.core import cascade as C
from repro_torch.core import losses as L
from repro_torch.core import metrics as M
from repro_torch.data import SearchLog
from repro_torch.paper import common

SETTINGS = ((1.0, 1.0), (10.0, 1.0), (10.0, 2.0), (10.0, 3.0), (10.0, 4.0))
# Table 4's deltas (%) against the 2-stage baseline; the rows here are
# against eps=1, mu=1
PAPER = {(1.0, 1.0): (1.58, -1.35, -1.76, -0.42),
         (10.0, 1.0): (0.25, 1.89, -0.64, -2.49),
         (10.0, 2.0): (0.17, 1.65, 0.24, -1.39),
         (10.0, 3.0): (0.12, 0.36, 1.32, 0.95),
         (10.0, 4.0): (-0.13, -0.25, -0.92, 1.65)}


def _online_inputs(params, cfg, lcfg, te: SearchLog):
    """(scores (B, G) with -inf for the items the hard cascade filtered,
    Eq-16 latency (B,)) of the test log, as numpy arrays."""
    x, q, mask, m_q = common.log_tensors(te, params["w_x"].device)
    with torch.no_grad():
        res = C.hard_cascade_filter(params, cfg, x, q, mask, m_q)
        lat = L.expected_latency_per_query(params, cfg, lcfg, x, q, mask, m_q)
    scores = np.where(res["survivors"][..., -1].cpu().numpy() > 0,
                      res["scores"].cpu().numpy(), -np.inf)
    return scores, lat.cpu().numpy()


def _online_metrics(params, cfg, lcfg, te: SearchLog, seed: int = 0):
    """The simulated users' CTR / orders / GMV / escape rate."""
    scores, lat = _online_inputs(params, cfg, lcfg, te)
    return M.simulate_session(scores, te.relevance, te.price, te.mask, lat,
                              seed=seed)


def claims(rows: list) -> list[common.Claim]:
    """Purchase weighting lifts orders or GMV against eps=1 (the
    reference's assert)."""
    gmv = {k: m["gmv"] for k, m in rows}
    orders = {k: m["orders"] for k, m in rows}
    best_gmv = max(gmv[(10.0, mu)] for mu in (1.0, 2.0, 3.0))
    best_orders = max(orders[(10.0, mu)] for mu in (1.0, 2.0, 3.0))
    return [("purchase_weighting_lifts_transactions",
             best_gmv >= gmv[(1.0, 1.0)] or best_orders >= orders[(1.0, 1.0)],
             f"gmv {best_gmv:.1f} vs {gmv[(1.0, 1.0)]:.1f}, orders "
             f"{best_orders:.0f} vs {orders[(1.0, 1.0)]:.0f}")]


def run(split: common.Split, device) -> tuple[list, list[common.Claim]]:
    """The five fits' online metrics, printed as deltas; (rows, claims)
    with rows [((eps, mu), metrics), ...]."""
    _, te = split
    t0 = time.perf_counter()
    rows = []
    for eps, mu in SETTINGS:
        params, cfg, lcfg = common.trained_cloes(
            split, device, beta=5.0, eps_purchase=eps, mu_price=mu)
        rows.append(((eps, mu), _online_metrics(params, cfg, lcfg, te)))
    elapsed = (time.perf_counter() - t0) * 1e6 / len(SETTINGS)
    base = rows[0][1]
    for (eps, mu), m in rows:
        def d(k):
            return 100.0 * (m[k] - base[k]) / max(abs(base[k]), 1e-9)
        pp = PAPER[(eps, mu)]
        common.emit(
            f"table4/eps{eps:g}_mu{mu:g}", elapsed,
            f"dCTR={d('ctr'):+.2f}%;dOrders={d('orders'):+.2f}%;"
            f"dGMV={d('gmv'):+.2f}%;dUnitPrice={d('unit_price'):+.2f}%;"
            f"paper=({pp[0]:+.2f},{pp[1]:+.2f},{pp[2]:+.2f},{pp[3]:+.2f})")
    return rows, claims(rows)


if __name__ == "__main__":
    sys.exit(common.suite_main("table4", run))
