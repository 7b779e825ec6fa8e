"""Paper Fig 3: rank-stage latency when CLOES is uninstalled (switched back
to the 2-stage heuristic) in two steps (a gray test, then the full
switch) on two independent clusters.

The two clusters are two disjoint halves of the test queries; the claim
is the two-step rise (~17 ms -> ~21 ms in the paper; the units here
follow the Eq-16 latency model). The port's counterpart of
`benchmarks/fig3_uninstall.py`.

    python -m repro_torch.paper.fig3_uninstall [--scale ci|paper] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.core import losses as L
from repro_torch.data import SearchLog
from repro_torch.data import features as F
from repro_torch.paper import common

TICKS = 30
SAMPLE = 128


def _latency(params, cfg, lcfg, te: SearchLog, idx) -> np.ndarray:
    """Eq-16 latency (ms) of the test groups idx under CLOES."""
    x, q, mask, m_q = common.log_tensors(te, params["w_x"].device, idx)
    with torch.no_grad():
        lat = L.expected_latency_per_query(params, cfg, lcfg, x, q, mask, m_q)
    return lat.cpu().numpy()


def _two_stage_latency(te: SearchLog, idx, keep: int = 6000) -> np.ndarray:
    """Eq-16 latency (ms) of the test groups idx under the 2-stage
    heuristic: sales volume on every recalled item, the other features on
    min(keep, M_q)."""
    m_q = te.m_q[idx]
    lat = (F.FEATURE_COSTS[F.FEATURE_NAMES.index("sales_volume")] * m_q
           + (F.FEATURE_COSTS.sum() - 0.02) * np.minimum(keep, m_q))
    return L.LossConfig().latency_scale * lat


def series(params, cfg, lcfg, te: SearchLog) -> dict[int, list[float]]:
    """Mean latency per tick for each cluster: CLOES on for 10 ticks, 30%
    of the queries switched for 10 (the gray test), all for the last 10."""
    rng = np.random.default_rng(0)
    n = te.x.shape[0]
    halves = [np.arange(n)[::2], np.arange(n)[1::2]]
    out: dict[int, list[float]] = {0: [], 1: []}
    for step in range(TICKS):
        frac_2stage = 0.0 if step < 10 else 0.3 if step < 20 else 1.0
        for c, idx in enumerate(halves):
            sample = rng.choice(idx, size=min(len(idx), SAMPLE),
                                replace=False)
            lat_c = _latency(params, cfg, lcfg, te, sample)
            lat_2 = _two_stage_latency(te, sample)
            mix = rng.random(len(sample)) < frac_2stage
            out[c].append(float(np.where(mix, lat_2, lat_c).mean()))
    return out


def claims(s: dict[int, list[float]]) -> list[common.Claim]:
    """The two-step rise on each cluster (the reference's assert)."""
    out = []
    for c in (0, 1):
        on, gray, off = (np.mean(s[c][:10]), np.mean(s[c][10:20]),
                         np.mean(s[c][20:]))
        out.append((f"cluster{c}_two_step_rise", bool(on < gray < off),
                    f"{on:.2f} < {gray:.2f} < {off:.2f} ms"))
    return out


def run(split: common.Split, device) -> tuple[dict, list[common.Claim]]:
    """(the two clusters' series, claims)."""
    _, te = split
    t0 = time.perf_counter()
    params, cfg, lcfg = common.trained_cloes(split, device, beta=5.0)
    s = series(params, cfg, lcfg, te)
    elapsed = (time.perf_counter() - t0) * 1e6
    for c in (0, 1):
        common.emit(f"fig3/cluster{c}", elapsed / 2,
                    f"cloes_on={np.mean(s[c][:10]):.1f}ms;"
                    f"gray={np.mean(s[c][10:20]):.1f}ms;"
                    f"off={np.mean(s[c][20:]):.1f}ms;paper=17_to_21ms")
    saved = 1 - np.mean(s[0][:10] + s[1][:10]) / np.mean(s[0][20:] + s[1][20:])
    common.emit("fig3/latency_saved", elapsed,
                f"frac={saved:.2f};paper=~0.20")
    return s, claims(s)


if __name__ == "__main__":
    sys.exit(common.suite_main("fig3", run))
