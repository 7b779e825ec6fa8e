"""Paper Fig 5 / §5.4: Singles' Day peak load. Search traffic triples; the
cluster must stay under 70% CPU utilisation WITHOUT dropping features.
The port's counterpart of `benchmarks/fig5_peak_load.py`, in three parts:

1. the CPU-utilisation model: util = QPS * cost_per_query / capacity,
   calibrated so the pre-CLOES (2-stage) system sits at the paper's 32%
   on a normal day. Claims: CLOES(beta=10) stays under 70% at 3x QPS
   while the 2-stage system does not, and saves over 30% of the cost
   (the paper: 45%);
2. the serving engine under load: the streaming CascadeSession (plan
   "filter": query_bias and the fused score-and-filter kernel on the
   card) driven open-loop at 0.25x, 1x and 4x the capacity measured on
   its live submit -> step path, each chunk costing exactly the
   calibrated chunk time (the reference asserts on the real clock, where
   a loaded machine serves the sweep at another speed than it calibrated
   at); the run on the real clock is printed, not claimed. Claims: it
   sheds over 10% at 4x, and no less than at 0.25x;
3. scale-out: the same 4x overload through a ReplicaRouter over 1 and 2
   replicas, each chunk costing exactly the calibrated chunk time (a
   deterministic service clock); the run on the real clock is printed,
   not claimed. Claim: 2 replicas serve at least 1.7x what 1 serves.

Every future must resolve and the router's accounting identity must
close; either failing raises (those are faults, not findings).

    python -m repro_torch.paper.fig5_peak_load [--scale ci|paper] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.core import cascade as C
from repro_torch.data import SearchLog
from repro_torch.data import features as F
from repro_torch.paper import common
from repro_torch.serving.batching import RankRequest
from repro_torch.serving.loadgen import run_open_loop, run_open_loop_router
from repro_torch.serving.router import ReplicaRouter, make_replicas
from repro_torch.serving.session import (CascadeSession, DegradePolicy,
                                         FlushPolicy, ServingConfig)

BATCH_GROUPS = 16
LOAD_MULTS = (0.25, 1.0, 4.0)
SWEEP_REQUESTS = 240
ROUTER_REQUESTS = 400
ROUTER_MULT = 4.0
SCALING_FLOOR = 1.7


def _cost_per_query(params, cfg, te: SearchLog) -> float:
    """Mean Eq-8 cost per query: items entering each stage x its t_j."""
    x, q, mask, m_q = common.log_tensors(te, params["w_x"].device)
    with torch.no_grad():
        counts = C.expected_counts_per_query(params, cfg, x, q, mask, m_q)
    m_q = te.m_q.astype(np.float64)
    entering = np.concatenate([m_q[:, None], counts.cpu().numpy()[:, :-1]],
                              axis=1)
    return (entering * cfg.t).sum(-1).mean()


def _two_stage_cost(te: SearchLog, keep: int = 6000) -> float:
    """Mean cost per query of the 2-stage heuristic."""
    m_q = te.m_q.astype(np.float64)
    sv = F.FEATURE_COSTS[F.FEATURE_NAMES.index("sales_volume")]
    return (sv * m_q + (F.FEATURE_COSTS.sum() - sv)
            * np.minimum(keep, m_q)).mean()


def utilisation(split: common.Split, device) -> dict:
    """Part 1: {"util_2stage", "cost": {name: cost per query}, "capacity"}."""
    _, te = split
    cost_2stage = _two_stage_cost(te)
    capacity = cost_2stage / 0.32            # calibrate: 2-stage = 32% util
    cost = {}
    for name, beta in (("cloes_beta1", 1.0), ("cloes_beta5", 5.0),
                       ("cloes_beta10", 10.0)):
        params, cfg, _ = common.trained_cloes(split, device, beta=beta)
        cost[name] = _cost_per_query(params, cfg, te)
    return {"util_2stage": cost_2stage / capacity, "cost": cost,
            "capacity": capacity, "cost_2stage": cost_2stage}


def make_reqs(te: SearchLog, n: int, seed: int) -> list[RankRequest]:
    """n requests for seeded draws of test queries, every item each."""
    picks = np.random.default_rng(seed).integers(0, te.x.shape[0], n)
    return [RankRequest(request_id=i, q_feat=te.q[qi].astype(np.float32),
                        item_feats=te.x[qi].astype(np.float32),
                        m_q=int(te.m_q[qi]))
            for i, qi in enumerate(picks)]


def make_session(params, cfg, lcfg, g: int, device) -> CascadeSession:
    bg = BATCH_GROUPS
    return CascadeSession(
        params, cfg, lcfg, device=device,
        scfg=ServingConfig(
            plan="filter", group_buckets=(g,), batch_groups=bg,
            max_queue=4 * bg, flush=FlushPolicy(max_wait_ms=5.0),
            degrade=DegradePolicy(high_watermark=2 * bg,
                                  low_watermark=bg // 2)))


def make_router(params, cfg, lcfg, g: int, n: int, device) -> ReplicaRouter:
    """n co-located replicas on `device` behind one global bound that
    scales with the fleet."""
    scfg = ServingConfig(
        plan="filter", group_buckets=(g,), batch_groups=BATCH_GROUPS,
        max_queue=4 * BATCH_GROUPS * n, flush=FlushPolicy(max_wait_ms=5.0),
        degrade=DegradePolicy(high_watermark=None))
    rt = ReplicaRouter(make_replicas(params, cfg, lcfg, n, scfg=scfg,
                                     devices=[device] * n))
    rt.warmup()
    return rt


def calibrate(params, cfg, lcfg, te: SearchLog, device) -> float:
    """The live path's time for one full chunk (us): the median of 5
    chunks of submit -> step (packing, pipeline, responses) after one
    warm chunk."""
    cal = make_session(params, cfg, lcfg, te.x.shape[1], device)
    cal.warmup()
    dts = []
    for rep in range(6):
        for r in make_reqs(te, BATCH_GROUPS, seed=100 + rep):
            cal.submit(r, now_ms=0.0)
        t0 = time.perf_counter()
        while cal.step(0.0):
            pass
        dts.append(time.perf_counter() - t0)
    return float(np.median(dts[1:])) * 1e6


class FixedTimer:
    """perf_counter stand-in advancing a fixed dt per call: every chunk's
    virtual service time is exactly the calibrated median."""

    def __init__(self, dt_s: float):
        self.t, self.dt = 0.0, dt_s

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def session_sweep(params, cfg, lcfg, te: SearchLog, device, cap_qps: float,
                  timer=None) -> dict:
    """Part 2: {mult: OpenLoopResult} at each LOAD_MULTS x cap_qps, on
    the real clock unless `timer` (a zero-argument factory of a timer) is
    given."""
    out = {}
    for mult in LOAD_MULTS:
        ses = make_session(params, cfg, lcfg, te.x.shape[1], device)
        ses.warmup()
        kw = {} if timer is None else {"timer": timer()}
        res = run_open_loop(ses, make_reqs(te, SWEEP_REQUESTS, seed=17),
                            mult * cap_qps, deadline_ms=None, seed=3, **kw)
        if res.unresolved:
            raise RuntimeError(f"x{mult}: {res.unresolved} futures never "
                               "resolved")
        out[mult] = res
    return out


def router_run(params, cfg, lcfg, te: SearchLog, device, n: int,
               qps: float, timer=None):
    """Part 3, one fleet size: (OpenLoopResult, the router's global
    stats). Raises if a future is unresolved or the accounting identity
    does not close."""
    rt = make_router(params, cfg, lcfg, te.x.shape[1], n, device)
    kw = {} if timer is None else {"timer": timer}
    res = run_open_loop_router(rt, make_reqs(te, ROUTER_REQUESTS, seed=29),
                               qps, seed=5, **kw)
    g = rt.stats_export()["global"]
    rt.close()
    if res.unresolved:
        raise RuntimeError(f"n={n}: {res.unresolved} futures never resolved")
    if g["submitted"] != (g["completed"] + g["shed"] + g["errors"]
                          + g["pending"] + g["inflight"]):
        raise RuntimeError(f"n={n}: the global accounting identity does not "
                           f"close: {g}")
    return res, g


def claims(util: dict, shed: dict[float, float],
           served: dict[int, int]) -> list[common.Claim]:
    """Fig 5's claims (the reference's asserts)."""
    u10 = util["cost"]["cloes_beta10"] / util["capacity"]
    saved = 1 - util["cost"]["cloes_beta10"] / util["cost_2stage"]
    scaling = served[2] / max(served[1], 1)
    return [
        ("beta10_under_red_line_at_3x", bool(3 * u10 < 0.70),
         f"3 x {100 * u10:.1f}% < 70%"),
        ("two_stage_over_red_line_at_3x", bool(3 * util["util_2stage"] > 0.70),
         f"3 x {100 * util['util_2stage']:.1f}% > 70%"),
        ("beta10_saves_over_30pct", bool(saved > 0.30),
         f"{100 * saved:.1f}%"),
        ("sheds_at_4x_capacity", bool(shed[4.0] > 0.1),
         f"shed {shed[4.0]:.3f} > 0.1"),
        ("sheds_no_less_at_4x_than_0.25x", bool(shed[4.0] >= shed[0.25]),
         f"{shed[4.0]:.3f} >= {shed[0.25]:.3f}"),
        ("two_replicas_scale", bool(scaling >= SCALING_FLOOR),
         f"served {served[2]} / {served[1]} = {scaling:.2f} >= "
         f"{SCALING_FLOOR}"),
    ]


def run(split: common.Split, device) -> tuple[dict, list[common.Claim]]:
    """All three parts; ({"util", "us_chunk", "shed", "served",
    "router_shed", "measured"}, claims). The chunk time `calibrate`
    measures sets the capacity the sweeps offer multiples of and the
    router's fixed chunk time."""
    _, te = split
    t0 = time.perf_counter()
    util = utilisation(split, device)
    us = (time.perf_counter() - t0) * 1e6 / 8
    cap = util["capacity"]
    common.emit("fig5/two_stage_normal_day", us,
                f"util={100 * util['util_2stage']:.1f}%;paper=32%")
    for name, c in util["cost"].items():
        common.emit(f"fig5/{name}", us,
                    f"util_normal={100 * c / cap:.1f}%;"
                    f"util_3xQPS={300 * c / cap:.1f}%;red_line=70%")
    u10 = util["cost"]["cloes_beta10"] / cap
    saved = 1 - util["cost"]["cloes_beta10"] / util["cost_2stage"]
    common.emit("fig5/beta10_saving", us,
                f"saved={100 * saved:.0f}%;paper=45%;"
                f"util_normal={100 * u10:.1f}%;paper_util=18%")

    params, cfg, lcfg = common.trained_cloes(split, device, beta=10.0)
    g = te.x.shape[1]
    us_chunk = calibrate(params, cfg, lcfg, te, device)
    cap_qps = BATCH_GROUPS / (us_chunk / 1e6)
    common.emit("fig5/session_capacity", us_chunk,
                f"chunk_qps_capacity={cap_qps:.0f};"
                f"bucket=({BATCH_GROUPS},{g});note=live_submit_step_path")
    # claimed on the calibrated fixed clock, as part 3: on the real clock
    # the machine's load may differ between the calibration and the
    # sweep, and then "4x capacity" is not 4x
    sweep = session_sweep(params, cfg, lcfg, te, device, cap_qps,
                          timer=lambda: FixedTimer(us_chunk / 1e6))
    # the same sweep on the real clock, reported but not claimed
    real = session_sweep(params, cfg, lcfg, te, device, cap_qps)
    for tag, runs in (("", sweep), ("_measured", real)):
        for mult, res in runs.items():
            common.emit(f"fig5/openloop_x{mult}{tag}", res.serve_s * 1e6,
                        f"offered_qps={res.offered_qps:.0f};"
                        f"achieved_qps={res.achieved_qps:.0f};"
                        f"shed_frac={res.shed_frac:.3f};"
                        f"p95_ms={res.pct(95):.2f};"
                        f"p50_ms={res.pct(50):.2f};degraded_frac="
                        f"{res.degraded / max(res.completed, 1):.3f}")

    served, shed_n, measured = {}, {}, {}
    for n in (1, 2):
        res, _ = router_run(params, cfg, lcfg, te, device, n,
                            ROUTER_MULT * cap_qps,
                            timer=FixedTimer(us_chunk / 1e6))
        served[n], shed_n[n] = res.completed, res.shed
        common.emit(f"fig5/router_x4_n{n}", res.sim_s * 1e6,
                    f"served={res.completed};shed={res.shed};"
                    f"achieved_qps={res.achieved_qps:.0f};"
                    f"offered_qps={res.offered_qps:.0f};replicas={n}")
        # the same sweep on the real clock, reported but not claimed
        measured[n] = router_run(params, cfg, lcfg, te, device, n,
                                 ROUTER_MULT * cap_qps)[0].completed
    common.emit("fig5/router_scaling_2x", us_chunk,
                f"served_ratio_2v1={served[2] / max(served[1], 1):.2f};"
                f"det_served={served};measured_served_ratio="
                f"{measured[2] / max(measured[1], 1):.2f};"
                f"floor={SCALING_FLOOR}")
    shed = {m: r.shed_frac for m, r in sweep.items()}
    rows = {"util": util, "us_chunk": us_chunk, "shed": shed,
            "measured_shed": {m: r.shed_frac for m, r in real.items()},
            "served": served, "router_shed": shed_n, "measured": measured}
    return rows, claims(util, shed, served)


if __name__ == "__main__":
    sys.exit(common.suite_main("fig5", run))
