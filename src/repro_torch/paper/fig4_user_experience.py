"""Paper Fig 4: user experience per query, hot against long-tail, with
and without modelling user experience (the delta / epsilon penalties of
Eq 15). The port's counterpart of `benchmarks/fig4_user_experience.py`.

Claims (the reference asserts the first two):
  1. hot-query latency drops with UX modelling (the paper: below the
     130 ms budget);
  2. long-tail result counts rise toward N_o with UX modelling;
  3. (printed) the escape rate falls for hot queries; CTR improves or
     holds.

    python -m repro_torch.paper.fig4_user_experience [--scale ci|paper] \
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

# The reference's stress calibration, copied and not re-tuned:
# latency_scale x6.7 over the default puts the accuracy-tuned (beta=1)
# cascade WITHOUT UX modelling at the paper's pre-CLOES hot-query
# operating point (~170 ms, Fig 4 'storage box'); eps_latency=0.2
# rebalances the paper's eps=0.05 for that scale. Both arms share beta and
# the scale, isolating the delta / epsilon effect.
LATENCY_SCALE = 0.01
UX = dict(beta=1.0, delta=1.0, eps_latency=0.2, latency_scale=LATENCY_SCALE)
NO_UX = dict(beta=1.0, delta=0.0, eps_latency=0.0,
             latency_scale=LATENCY_SCALE)


def _per_query(params, cfg, lcfg, te: SearchLog):
    """(final expected count (B,), Eq-16 latency (B,), the simulated
    session's metrics) of the test log."""
    x, q, mask, m_q = common.log_tensors(te, params["w_x"].device)
    with torch.no_grad():
        counts = C.expected_counts_per_query(params, cfg, x, q, mask, m_q)
        lat = L.expected_latency_per_query(params, cfg, lcfg, x, q, mask, m_q)
        res = C.hard_cascade_filter(params, cfg, x, q, mask, m_q)
    counts, lat = counts[:, -1].cpu().numpy(), lat.cpu().numpy()
    scores = np.where(res["survivors"][..., -1].cpu().numpy() > 0,
                      res["scores"].cpu().numpy(), -np.inf)
    sess = M.simulate_session(scores, te.relevance, te.price, te.mask, lat)
    return counts, lat, sess


def claims(lat_hot: tuple[float, float],
           cnt_tail: tuple[float, float]) -> list[common.Claim]:
    """(without, with) UX modelling: hot latency falls, tail counts rise."""
    return [("ux_cuts_hot_latency", bool(lat_hot[1] < lat_hot[0]),
             f"{lat_hot[0]:.2f} -> {lat_hot[1]:.2f} ms"),
            ("ux_raises_tail_counts", bool(cnt_tail[1] > cnt_tail[0]),
             f"{cnt_tail[0]:.2f} -> {cnt_tail[1]:.2f}")]


def run(split: common.Split, device) -> tuple[dict, list[common.Claim]]:
    """({"lat_hot", "cnt_tail"} as (without, with) pairs, claims)."""
    _, te = split
    t0 = time.perf_counter()
    p_ux, cfg_ux, lcfg = common.trained_cloes(split, device, **UX)
    p_no, cfg_no, _ = common.trained_cloes(split, device, **NO_UX)
    c_ux, l_ux, s_ux = _per_query(p_ux, cfg_ux, lcfg, te)
    c_no, l_no, s_no = _per_query(p_no, cfg_no, lcfg, te)
    hot = te.m_q > np.percentile(te.m_q, 90)
    tail = te.m_q < np.percentile(te.m_q, 50)
    us = (time.perf_counter() - t0) * 1e6 / 6

    common.emit("fig4/hot_latency_ms", us,
                f"without_ux={l_no[hot].mean():.1f};"
                f"with_ux={l_ux[hot].mean():.1f};budget=130;paper=170_to_108")
    common.emit("fig4/hot_over_budget_frac", us,
                f"without_ux={(l_no[hot] > 130).mean():.2f};"
                f"with_ux={(l_ux[hot] > 130).mean():.2f}")
    common.emit("fig4/tail_result_count", us,
                f"without_ux={c_no[tail].mean():.1f};"
                f"with_ux={c_ux[tail].mean():.1f};"
                f"target=min(200,M_q);paper=floor_wax_8x_increase")
    common.emit("fig4/escape_rate", us,
                f"without_ux={s_no['escape_rate']:.3f};"
                f"with_ux={s_ux['escape_rate']:.3f}")
    common.emit("fig4/overall_ctr", us,
                f"without_ux={s_no['ctr']:.3f};with_ux={s_ux['ctr']:.3f}")
    common.emit("fig4/mean_latency_ms", us,
                f"without_ux={s_no['mean_latency_ms']:.1f};"
                f"with_ux={s_ux['mean_latency_ms']:.1f}")
    out = {"lat_hot": (float(l_no[hot].mean()), float(l_ux[hot].mean())),
           "cnt_tail": (float(c_no[tail].mean()), float(c_ux[tail].mean()))}
    return out, claims(out["lat_hot"], out["cnt_tail"])


if __name__ == "__main__":
    sys.exit(common.suite_main("fig4", run))
