"""End-to-end serving driver (the paper's kind of system): a trained CLOES
cascade behind the streaming CascadeSession API — open-loop Poisson
arrivals with per-request deadlines, bounded admission, and one of the
assigned architectures (smoke-sized) as the expensive neural final stage
(skipped under degraded mode when the queue backs up).

By default the open loop runs on the virtual-clock DES; with --pump it
runs on the wall clock instead — a live SessionPump background thread
with concurrent submitter threads blocking on their futures.

    PYTHONPATH=src python -m repro_torch.examples.cascade_serving \
        [--arch qwen3-8b] [--pump] [--chaos] [--replicas N] [--device cpu]

--chaos turns on seeded fault injection (serving.faults): transient
executor exceptions retry under capped backoff, poison requests are
bisected out of their batch and quarantined as status="error", and the
lifecycle report shows the retry / quarantine counters.

--replicas N serves through a ReplicaRouter over N co-located replicas
(on the card each on its own stream, sharing one pipeline) behind one
global admission point: least-loaded placement, breaker-driven failover,
probe re-admission.

The port's counterpart of `examples/cascade_serving.py`.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as CFG
from repro_torch.core import baselines as B
from repro_torch.core import losses as L
from repro_torch.core import metrics as M
from repro_torch.core import trainer as T
from repro_torch.data import LogConfig, generate_log
from repro_torch.launch.mesh import device_of
from repro_torch.serving.batching import RankRequest
from repro_torch.serving.cascade_server import NeuralScorer
from repro_torch.serving.faults import FaultConfig, FaultInjector
from repro_torch.serving.loadgen import run_open_loop, run_open_loop_router
from repro_torch.serving.pump import SessionPump, run_wall_clock
from repro_torch.serving.router import ReplicaRouter, make_replicas
from repro_torch.serving.session import (CascadeSession, DegradePolicy,
                                         FlushPolicy, ServingConfig)


def main(argv: list[str] | None = None) -> dict:
    """Serves the requests and prints the lifecycle report; returns
    {"result": the loadgen result, "mean_auc": float, "router": stats or
    None, "chaos": stats or None}."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "cascade_serving")
    ap.add_argument("--arch", default="starcoder2-3b",
                    help="assigned arch used (smoke-sized) as final stage")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--qps", type=float, default=300.0)
    ap.add_argument("--deadline-ms", type=float, default=130.0)
    ap.add_argument("--pump", action="store_true",
                    help="wall-clock SessionPump instead of the DES")
    ap.add_argument("--chaos", action="store_true",
                    help="inject faults (transients, latency spikes, NaN "
                         "corruption, poison requests) — watch retries, "
                         "quarantine, and explicit error statuses")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a ReplicaRouter over N co-located "
                         "replicas (1 = single session)")
    ap.add_argument("--queries", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    log = generate_log(LogConfig(n_queries=args.queries, seed=1))
    tr, te = log.split(0.8)
    params, cfg = B.fit_cloes(tr, lcfg=L.LossConfig(beta=5.0),
                              tcfg=T.TrainConfig(loss="l3", epochs=4,
                                                 lr=0.01), device=device)
    ncfg = dataclasses.replace(CFG.get_smoke(args.arch), dtype=torch.float32)
    neural = NeuralScorer.create(ncfg, 7, device=device)

    # --chaos: a seeded injector wrapping the execute seam — transient
    # exceptions retry with backoff, poison requests get bisected out and
    # quarantined as status="error" while their chunk-mates serve
    def injector(seed):
        return FaultInjector(FaultConfig(
            transient_rate=0.15, latency_rate=0.05, latency_spike_ms=5.0,
            corrupt_rate=0.05, poison_rate=0.02,
            seed=seed)) if args.chaos else None

    # watermarks sized so an arrival burst that outruns the neural stage
    # visibly enters degraded mode (skip the neural stage, tighten m_q)
    # and recovers once the queue drains
    scfg = ServingConfig(plan="filter", max_queue=64,
                         flush=FlushPolicy(max_wait_ms=5.0),
                         degrade=DegradePolicy(high_watermark=16,
                                               low_watermark=4))
    router = None
    faults = injector(0)
    t0 = time.perf_counter()
    if args.replicas > 1:
        router = ReplicaRouter(make_replicas(
            params, cfg, n=args.replicas, neural_stage=neural, scfg=scfg,
            faults=[injector(k) for k in range(args.replicas)]
            if args.chaos else None, devices=[device] * args.replicas))
        ses = router.replicas[0]
        faults = ses.faults
        shapes = router.warmup()
        print(f"warmed {len(shapes)} shape buckets {shapes} across "
              f"{args.replicas} replicas (one shared pipeline) "
              f"in {time.perf_counter() - t0:.1f}s")
    else:
        ses = CascadeSession(params, cfg, neural_stage=neural, faults=faults,
                             scfg=scfg, device=device)
        shapes = ses.warmup()    # run every serving shape bucket up front
        print(f"warmed {len(shapes)} shape buckets {shapes} "
              f"in {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    picks = rng.integers(0, te.x.shape[0], args.requests)
    t0 = time.perf_counter()
    reqs = [RankRequest(request_id=i,
                        q_feat=te.q[qi].astype(np.float32),
                        item_feats=te.x[qi, :int(rng.integers(8, 64))]
                        .astype(np.float32),
                        m_q=int(te.m_q[qi]))
            for i, qi in enumerate(picks)]
    gen_s = time.perf_counter() - t0
    if args.pump and router is not None:
        router.attach_pumps([SessionPump(s, name=f"pump-{s.name}").start()
                             for s in router.replicas])
        res = run_wall_clock(router, reqs, args.qps,
                             deadline_ms=args.deadline_ms)
        router.close()
        clock_note = f"{res.wall_s:.1f}s wall, {args.replicas} replicas"
    elif args.pump:
        with SessionPump(ses) as pump:
            res = run_wall_clock(pump, reqs, args.qps,
                                 deadline_ms=args.deadline_ms)
        clock_note = f"{res.wall_s:.1f}s wall"
    elif router is not None:
        res = run_open_loop_router(router, reqs, args.qps,
                                   deadline_ms=args.deadline_ms)
        router.close()
        clock_note = f"{res.serve_s:.1f}s compute, {args.replicas} replicas"
    else:
        res = run_open_loop(ses, reqs, args.qps,
                            deadline_ms=args.deadline_ms)
        clock_note = f"{res.serve_s:.1f}s compute"
    print(f"generated {len(reqs)} requests in {gen_s:.2f}s; offered "
          f"{res.offered_qps:.0f} QPS -> {res.achieved_qps:.0f} QPS achieved "
          f"({clock_note})")
    print(f"shed {res.shed} ({100 * res.shed_frac:.1f}%), errors "
          f"{res.errors}, degraded {res.degraded}, deadline-missed "
          f"{res.deadline_missed}")
    rst = chaos = None
    if router is not None:
        rst = router.stats_export()
        g = rst["global"]
        print(f"router: routed {rst['routed']} over {args.replicas} "
              f"replicas, failovers {rst['failovers']}, drained "
              f"{rst['drained']}, probes {rst['probes']}; global identity "
              f"submitted {g['submitted']} = completed {g['completed']} + "
              f"shed {g['shed']} + errors {g['errors']}")
    if faults is not None:
        if router is not None:
            chaos = dict(rst["global"])
            chaos["injected"] = {
                k: sum(s["injected"][k] for s in rst["replicas"])
                for k in ("transient", "latency", "corrupt", "poison")}
        else:
            chaos = ses.stats_export()
        print(f"chaos: injected {chaos['injected']} -> retries "
              f"{chaos['retries']}, quarantined {chaos['quarantined']}, "
              f"errors {chaos['errors']} (every future still resolved "
              f"explicitly)")
    if len(res.latency_ms):
        print(f"end-to-end latency p50 {res.pct(50):.1f}ms / "
              f"p95 {res.pct(95):.1f}ms (deadline {args.deadline_ms:.0f}ms)")
    # ranking quality on the SERVED responses vs ground-truth relevance
    # (shed requests return no ranking and are skipped)
    aucs = []
    for fut, qi in zip(res.futures, picks):
        r = fut.result()
        if r.status != "ok":
            continue
        n = len(r.scores)
        y = te.y[qi, :n] > 0
        if 0 < y.sum() < n and np.isfinite(r.scores).any():
            aucs.append(M.auc(r.scores, y.astype(float)))
    mean_auc = float(np.nanmean(aucs)) if aucs else float("nan")
    print(f"mean per-request AUC over {len(aucs)} served requests "
          f"(cascade + untrained neural stage): {mean_auc:.3f}  — train "
          f"the stage with repro_torch.examples.train_ranker for a real "
          f"final-stage model")
    return {"result": res, "mean_auc": mean_auc, "router": rst,
            "chaos": chaos}


if __name__ == "__main__":
    main()
