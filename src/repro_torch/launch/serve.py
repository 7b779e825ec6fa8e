"""Serving launcher of the port: drive the streaming CascadeSession over an
OPEN-LOOP synthetic request stream (Poisson arrivals at a fixed offered
rate, per-request deadlines, bounded admission with load-shedding and
degraded modes) on the virtual-clock DES (`loadgen.run_open_loop`:
arrivals and flush policy on a simulated millisecond clock, service times
real measured compute) and report shed / degraded / deadline-miss counts
and end-to-end latency percentiles.

The cascade is trained first, as the reference's launcher does: CLOES (L3)
on the log's training split, 4 epochs at lr 0.01 and `--beta` (5.0), on
`--device`. `--params PATH.npz` (numpy arrays w_x, w_q, b in the
reference's layout, e.g. saved from a JAX fit) serves those weights
instead and skips training. `--neural ARCH` adds the neural final stage:
the smoke variant of that dense architecture in float32 with random
weights (seed 7), scoring every batch's rows on `--device`.

Exit contract: nonzero when a future stays unresolved or the accounting
identity submitted = completed + shed + errors does not close.

`--profile TRACE.json` runs the DES under torch.profiler, writes its
Chrome trace there and prints where the serve time went: the device's busy
time (kernels and copies) against the measured compute, and the host ops
that took the most time. The profiler's own overhead inflates the
compute time of such a run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 500 \
      --qps 400 [--deadline-ms 130] [--max-queue 128] [--plan filter] \
      [--beta 5] [--params cascade.npz] [--device cuda] \
      [--neural gemma3-27b] [--report BENCH_serve.json] \
      [--profile serve_trace.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from repro_torch import configs as CFG
from repro_torch.configs import cloes
from repro_torch.core import baselines as B
from repro_torch.core import cascade as C
from repro_torch.core import losses as L
from repro_torch.core import trainer as T
from repro_torch.data import LogConfig, SearchLog, generate_log
from repro_torch.serving.batching import RankRequest
from repro_torch.serving.cascade_server import NeuralScorer
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.loadgen import run_open_loop
from repro_torch.serving.session import (CascadeSession, DegradePolicy,
                                         FlushPolicy, ServingConfig)


def build_serving_config(*, plan="filter", max_queue=128,
                         max_wait_ms=5.0) -> ServingConfig:
    """The launcher's serving profile: bounded queue with load-shedding,
    degradation watermarks derived from the queue bound (enter at 3/4
    capacity, exit at 1/4 — the hysteresis band)."""
    degrade = (DegradePolicy(high_watermark=max(1, (3 * max_queue) // 4),
                             low_watermark=max_queue // 4)
               if max_queue else DegradePolicy(high_watermark=None))
    return ServingConfig(plan=plan,
                         max_queue=max_queue or None,
                         flush=FlushPolicy(max_wait_ms=max_wait_ms),
                         degrade=degrade)


def build_session(params, cfg, lcfg=None, *, neural=None, plan="filter",
                  max_queue=128, max_wait_ms=5.0,
                  faults: FaultInjector | None = None,
                  device="cuda") -> CascadeSession:
    return CascadeSession(
        params, cfg, lcfg, neural_stage=neural, faults=faults, device=device,
        scfg=build_serving_config(plan=plan, max_queue=max_queue,
                                  max_wait_ms=max_wait_ms))


def compiled_count(sessions) -> int:
    """Distinct (skip_neural, b, g) shapes the sessions' pipelines have
    run. Its delta across the serve phase counts the shapes first seen
    after warmup, which must be 0."""
    return len(set().union(*(s.shapes_seen for s in sessions)))


def build_neural(arch: str, device="cuda") -> NeuralScorer:
    """The neural final stage of `--neural ARCH`: the architecture's smoke
    variant in float32, random weights from seed 7 (the reference's key)."""
    ncfg = dataclasses.replace(CFG.get_smoke(arch), dtype=torch.float32)
    return NeuralScorer.create(ncfg, 7, device=device)


def load_params(path: str, cfg: C.CascadeConfig, *,
                device="cuda") -> C.Params:
    """Cascade weights from a `.npz` of numpy arrays (w_x, w_q, b)."""
    with np.load(path) as f:
        params = C.params_from_numpy({k: f[k] for k in f.files},
                                     device=device)
    want = {"w_x": (cfg.n_stages, cfg.d_x), "w_q": (cfg.n_stages, cfg.d_q),
            "b": (cfg.n_stages,)}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != want:
        raise SystemExit(f"[serve] {path}: params shapes {got} do not fit "
                         f"the CLOES cascade {want}")
    return params


def make_requests(te: SearchLog, n: int, seed: int) -> list[RankRequest]:
    """n requests of 8-63 items drawn from the held-out log's queries."""
    rng = np.random.default_rng(seed)
    n_te = te.x.shape[0]
    reqs = []
    for i in range(n):
        qi = int(rng.integers(0, n_te))
        n_items = int(rng.integers(8, 64))
        reqs.append(RankRequest(
            request_id=i, q_feat=te.q[qi].astype(np.float32),
            item_feats=te.x[qi, :n_items].astype(np.float32),
            m_q=int(te.m_q[qi])))
    return reqs


def profile_summary(prof, serve_s: float, top: int = 8) -> dict:
    """Device busy time and the busiest host ops of a profiled serve.

    Busy time sums the device-side events (kernels, copies) only: the host
    op that launched a kernel reports the same device time again, so
    summing every event would count each kernel twice."""
    events = prof.key_averages()
    device = [e for e in events if e.device_type != DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "serve_ms": serve_s * 1e3,
        "device_busy_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / max(serve_s * 1e3, 1e-9),
        "top_host_ops": [
            {"name": e.key, "count": e.count,
             "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "self_device_ms": e.self_device_time_total / 1e3}
            for e in host[:top]],
        "device_ops": [
            {"name": e.key, "count": e.count,
             "self_device_ms": e.self_device_time_total / 1e3}
            for e in sorted(device, key=lambda e: e.self_device_time_total,
                            reverse=True)[:top]
            if e.self_device_time_total > 0],
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--qps", type=float, default=400.0,
                    help="offered load (Poisson arrival rate)")
    ap.add_argument("--deadline-ms", type=float, default=130.0,
                    help="per-request deadline budget (0 = no deadlines)")
    ap.add_argument("--max-queue", type=int, default=128,
                    help="admission bound (0 = unbounded, never sheds)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--plan", default="filter",
                    help="pipeline plan (core.pipeline.PLANS entry)")
    ap.add_argument("--beta", type=float, default=5.0,
                    help="CPU-cost trade-off of the L3 fit (Eq 9)")
    ap.add_argument("--params", default="",
                    help=".npz of the cascade weights (w_x, w_q, b) to "
                         "serve instead of training")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--neural", default="",
                    help="arch id for the neural final stage (smoke variant)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default="",
                    help="write the latency/lifecycle report as JSON here")
    ap.add_argument("--profile", default="",
                    help="run the DES under torch.profiler and write its "
                         "Chrome trace here")
    args = ap.parse_args(argv)

    log = generate_log(LogConfig(n_queries=800, seed=args.seed))
    tr, te = log.split(0.8)
    cfg = cloes.CASCADE
    if args.params:
        params = load_params(args.params, cfg, device=args.device)
        print(f"[serve] cascade weights: {args.params}")
    else:
        print("[serve] training cascade...")
        t0 = time.perf_counter()
        params, cfg = B.fit_cloes(
            tr, lcfg=L.LossConfig(beta=args.beta),
            tcfg=T.TrainConfig(loss="l3", epochs=4, lr=0.01),
            device=args.device)
        print(f"[serve] trained CLOES (L3, beta {args.beta}) in "
              f"{time.perf_counter() - t0:.1f}s")
    neural = None
    if args.neural:
        neural = build_neural(args.neural, device=args.device)
        print(f"[serve] neural final stage: {neural.cfg.name}")
    ses = build_session(params, cfg, neural=neural, plan=args.plan,
                        max_queue=args.max_queue,
                        max_wait_ms=args.max_wait_ms, device=args.device)
    t0 = time.perf_counter()
    shapes = ses.warmup()
    warmup_s = time.perf_counter() - t0
    print(f"[serve] warmed {len(shapes)} shape buckets on {ses.device} in "
          f"{warmup_s:.1f}s")
    shapes_after_warmup = compiled_count([ses])

    # -- request generation, timed on its own (NOT charged to the server) --
    t0 = time.perf_counter()
    reqs = make_requests(te, args.requests, args.seed)
    gen_s = time.perf_counter() - t0
    if not reqs:
        print("[serve] no requests submitted — nothing to report")
        return
    print(f"[serve] generated {len(reqs)} requests in {gen_s:.2f}s")

    deadline = args.deadline_ms if args.deadline_ms > 0 else None
    profile = None
    if args.profile:
        from torch.profiler import ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if ses.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            res = run_open_loop(ses, reqs, args.qps, deadline_ms=deadline,
                                seed=args.seed)
        prof.export_chrome_trace(args.profile)
        profile = profile_summary(prof, res.serve_s)
        print(f"[serve] profile: device busy {profile['device_busy_ms']:.3f}"
              f" ms of {profile['serve_ms']:.3f} ms compute (idle share "
              f"{profile['device_idle_share']:.4f}); trace in {args.profile}")
        for op in profile["top_host_ops"]:
            print(f"[serve]   host {op['self_cpu_ms']:9.3f} ms  "
                  f"x{op['count']:<6d} {op['name']}")
        for op in profile["device_ops"]:
            print(f"[serve]   device {op['self_device_ms']:7.3f} ms  "
                  f"x{op['count']:<6d} {op['name']}")
    else:
        res = run_open_loop(ses, reqs, args.qps, deadline_ms=deadline,
                            seed=args.seed)
    print(f"[serve] offered {res.offered_qps:.0f} QPS; served "
          f"{res.completed}/{res.n_requests} over {res.sim_s:.2f}s "
          f"simulated ({res.achieved_qps:.0f} QPS achieved, "
          f"{res.serve_s:.2f}s compute)")
    print(f"[serve] shed {res.shed} ({100*res.shed_frac:.1f}%), errors "
          f"{res.errors}, degraded {res.degraded}, deadline-missed "
          f"{res.deadline_missed}, truncated {res.truncated}")
    if len(res.latency_ms):
        print(f"[serve] end-to-end latency: p50 {res.pct(50):.1f}ms "
              f"p95 {res.pct(95):.1f}ms p99 {res.pct(99):.1f}ms")
    st = ses.stats_export()
    print(f"[serve] session stats: {st}")

    if res.unresolved:
        raise SystemExit(
            f"[serve] FAIL: {res.unresolved} futures never resolved — every "
            "submitted request must come back with an explicit status")
    if st["submitted"] != st["completed"] + st["shed"] + st["errors"]:
        raise SystemExit(
            f"[serve] FAIL: lifecycle accounting does not close — "
            f"submitted {st['submitted']} != completed {st['completed']} "
            f"+ shed {st['shed']} + errors {st['errors']}")
    print("[serve] all futures resolved (zero dropped; "
          "submitted = completed + shed + errors)")
    recompiles = compiled_count([ses]) - shapes_after_warmup
    print(f"[serve] recompiles after warmup: {recompiles}")

    if args.report:
        report = {
            "config": {"requests": args.requests, "offered_qps": args.qps,
                       "deadline_ms": args.deadline_ms,
                       "max_queue": args.max_queue, "plan": args.plan,
                       "seed": args.seed, "beta": args.beta,
                       "params": args.params or None,
                       "neural": args.neural or None,
                       "mode": "des", "device": str(ses.device),
                       "device_name": (torch.cuda.get_device_name(ses.device)
                                       if ses.device.type == "cuda"
                                       else "cpu")},
            "recompiles_after_warmup": recompiles,
            "phases_s": {"warmup": warmup_s, "generate": gen_s,
                         "serve": res.serve_s},
            "open_loop": res.summary(),
            "session_stats": st,
        }
        if profile is not None:
            report["profile"] = profile
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[serve] wrote {args.report}")


if __name__ == "__main__":
    main()
