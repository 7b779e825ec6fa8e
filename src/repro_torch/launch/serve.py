"""Serving launcher of the port: drive the streaming CascadeSession over an
OPEN-LOOP synthetic request stream (Poisson arrivals at a fixed offered
rate, per-request deadlines, bounded admission with load-shedding and
degraded modes) and report shed / degraded / deadline-miss counts and
end-to-end latency percentiles.

Two clocks, one lifecycle:
  * default: the virtual-clock DES (`loadgen.run_open_loop`) — arrivals
    and flush policy on a simulated millisecond clock, service times real
    measured compute;
  * --pump: WALL-CLOCK mode — a live SessionPump background thread with
    `--threads` concurrent submitter threads blocking on their futures;
    real time drives everything.
`--replicas N` serves through a ReplicaRouter over N replica sessions
(round-robin over the CUDA cards; replicas sharing a card each on their
own stream), on the DES (`run_open_loop_router`) or, with --pump, with one
pump per replica. `--kill-replica` makes replica 0's executor always fail:
the router must fail it over and the run still exit zero. `--faults RATE`
injects seeded faults (transients, latency spikes, corrupt scores, poison
requests) into every session.

The cascade is trained first, as the reference's launcher does: CLOES (L3)
on the log's training split, 4 epochs at lr 0.01 and `--beta` (5.0), on
`--device`. `--params PATH.npz` (numpy arrays w_x, w_q, b in the
reference's layout, e.g. saved from a JAX fit) serves those weights
instead and skips training. `--neural ARCH` adds the neural final stage:
the smoke variant of that dense or moe architecture in float32 with
random weights (seed 7), scoring every batch's rows on `--device`.

Exit contract: nonzero when a future stays unresolved or the accounting
identity submitted = completed + shed + errors does not close (over the
whole fleet under a router, where drained and adopted work cancel).

`--serve-dir DIR` makes the shutdown graceful and durable: pumps and the
router close with drain=True (every queued request is served), then the
params, the configs that rebuild the session and its warmup manifest are
written to DIR with `checkpoint.save_pytree` (crash-safe), the manifest
mirrored as `warmup_manifest.json`. `--warm-restart` restores them from
`--serve-dir` instead of training and replays the manifest on every
replica; the run exits nonzero if the serve phase then meets a shape
first seen after warmup. `--serve-dir` persists the cascade only, so it
refuses `--neural`; `--warm-restart` refuses `--params`.

`--profile TRACE.json` runs the single-session DES under torch.profiler,
writes its Chrome trace there and prints where the serve time went: the
device's busy time (kernels and copies) against the measured compute, and
the host ops that took the most time. The profiler's own overhead inflates the
compute time of such a run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 500 \
      --qps 400 [--deadline-ms 130] [--max-queue 128] [--plan filter] \
      [--beta 5] [--params cascade.npz] [--device cuda] \
      [--pump [--threads 4]] [--replicas 2 [--kill-replica]] \
      [--faults 0.2] [--neural gemma3-27b] [--report BENCH_serve.json] \
      [--profile serve_trace.json] [--serve-dir DIR [--warm-restart]]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from repro_torch import configs as CFG
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import cloes
from repro_torch.core import baselines as B
from repro_torch.core import cascade as C
from repro_torch.core import losses as L
from repro_torch.core import trainer as T
from repro_torch.data import LogConfig, SearchLog, generate_log
from repro_torch.launch.mesh import replica_devices
from repro_torch.serving.batching import RankRequest
from repro_torch.serving.cascade_server import NeuralScorer
from repro_torch.serving.faults import FaultConfig, FaultInjector
from repro_torch.serving.loadgen import run_open_loop, run_open_loop_router
from repro_torch.serving.pump import SessionPump, run_wall_clock
from repro_torch.serving.router import (ReplicaRouter, RouterConfig,
                                        make_replicas)
from repro_torch.serving.session import (CascadeSession, DegradePolicy,
                                         FlushPolicy, ServingConfig)


def build_serving_config(*, plan="filter", max_queue=128,
                         max_wait_ms=5.0) -> ServingConfig:
    """The launcher's serving profile: bounded queue with load-shedding,
    degradation watermarks derived from the queue bound (enter at 3/4
    capacity, exit at 1/4 — the hysteresis band). Under a router the same
    bound and watermarks apply to the GLOBAL depth — one admission
    controller over the fleet."""
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


def build_injector(rate: float, seed: int) -> FaultInjector | None:
    """Chaos profile for --faults RATE: transients at the full rate,
    latency spikes and score corruption at half, poison at a quarter —
    one knob that exercises every fault class, seeded so a DES chaos run
    replays deterministically."""
    if rate <= 0:
        return None
    return FaultInjector(FaultConfig(
        transient_rate=rate, latency_rate=rate / 2,
        latency_spike_ms=5.0, corrupt_rate=rate / 2,
        poison_rate=rate / 4, seed=seed))


def build_router(params, cfg, lcfg=None, *, n, neural=None, plan="filter",
                 max_queue=128, max_wait_ms=5.0, fault_rate=0.0,
                 kill_replica=False, seed=0, device="cuda") -> ReplicaRouter:
    """N replicas behind one admission point, round-robin over the cards
    of `device`'s kind (`launch.mesh.replica_devices`: on one card every
    replica shares it, each on its own stream). --faults gives every
    replica its own seeded injector (seed+k: independent fault streams,
    reproducible); --kill-replica gives replica 0 an always-failing
    executor instead, so the chaos smoke exercises breaker-open failover:
    its backlog must drain to survivors and the run must still exit
    zero."""
    scfg = build_serving_config(plan=plan, max_queue=max_queue,
                                max_wait_ms=max_wait_ms)
    faults: list[FaultInjector | None] | None = None
    if kill_replica:
        faults = [FaultInjector(FaultConfig(transient_rate=1.0,
                                            seed=seed))]
        faults += [build_injector(fault_rate, seed + 1 + k)
                   for k in range(n - 1)]
    elif fault_rate > 0:
        faults = [build_injector(fault_rate, seed + k) for k in range(n)]
    return ReplicaRouter(
        make_replicas(params, cfg, lcfg, n, neural_stage=neural,
                      scfg=scfg, faults=faults,
                      devices=replica_devices(n, torch.device(device).type)),
        RouterConfig())


def compiled_count(sessions) -> int:
    """Distinct (skip_neural, b, g) shapes the sessions' pipelines have
    run (co-located replicas share one record). Its delta across the
    serve phase counts the shapes first seen after warmup, which must be
    0. Read it while no pump is serving."""
    return len(set().union(*(s.shapes_seen for s in sessions)))


def save_serving_state(serve_dir: str, ses: CascadeSession) -> None:
    """The graceful-shutdown write: everything a restarted server needs to
    serve its first request with no new shape — params, the configs that
    rebuild the session, and the warmup manifest (also mirrored as plain
    JSON) — in the reference's tree, so either package restores it.
    Crash-safe via save_pytree."""
    manifest = ses.warmup_manifest()
    cfg = ses.cfg
    save_pytree(Path(serve_dir) / "serve_state", {
        "params": {k: v.detach().cpu().numpy()
                   for k, v in ses.params.items()},
        "cfg": {"n_stages": cfg.n_stages, "d_x": cfg.d_x, "d_q": cfg.d_q,
                "masks": cfg.masks, "stage_times": cfg.stage_times},
        "lcfg": dataclasses.asdict(ses.lcfg),
        "manifest": manifest,
    })
    with open(Path(serve_dir) / "warmup_manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)


def load_serving_state(serve_dir: str, *, device="cuda"):
    """Restore what save_serving_state wrote (verified: a torn or corrupt
    state raises instead of warm-starting a wrong server). Returns
    (params on `device`, CascadeConfig, LossConfig, warmup manifest)."""
    state = load_pytree(Path(serve_dir) / "serve_state")
    cfg = C.CascadeConfig(**state["cfg"])
    lcfg = L.LossConfig(**state["lcfg"])
    return (C.params_from_numpy(state["params"], device=device), cfg, lcfg,
            state["manifest"])


def build_neural(arch: str, device="cuda") -> NeuralScorer:
    """The neural final stage of `--neural ARCH`: the architecture's smoke
    variant in float32, random weights from seed 7 (the reference's key).
    A family the scorer cannot run (ssm, hybrid) raises ValueError before
    a weight is drawn."""
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


def main(argv: list[str] | None = None):
    """Run the launcher; returns the serve phase's result (OpenLoopResult
    or WallClockResult: its futures hold the responses), or None when no
    request was made."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--qps", type=float, default=400.0,
                    help="offered load (Poisson arrival rate)")
    ap.add_argument("--deadline-ms", type=float, default=130.0,
                    help="per-request deadline budget (0 = no deadlines)")
    ap.add_argument("--max-queue", type=int, default=128,
                    help="admission bound (0 = unbounded, never sheds)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--pump", action="store_true",
                    help="wall-clock mode: live SessionPump + concurrent "
                         "submitter threads (default: virtual-clock DES)")
    ap.add_argument("--threads", type=int, default=4,
                    help="submitter threads in --pump mode")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a ReplicaRouter over N replica "
                         "sessions (1 = the single-session path)")
    ap.add_argument("--kill-replica", action="store_true",
                    help="chaos smoke: replica 0's executor always fails "
                         "— the router must fail it over and the run "
                         "must still exit zero (requires --replicas > 1)")
    ap.add_argument("--faults", type=float, default=0.0,
                    help="chaos mode: injected-fault rate (transient "
                         "exceptions, latency spikes, NaN corruption, "
                         "poison requests; 0 = off)")
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
                    help="run the single-session DES under torch.profiler "
                         "and write its Chrome trace here")
    ap.add_argument("--serve-dir", default="",
                    help="durable serving state: graceful shutdown drains "
                         "the pumps then writes params + warmup manifest "
                         "here (crash-safe)")
    ap.add_argument("--warm-restart", action="store_true",
                    help="restore params from --serve-dir and replay its "
                         "warmup manifest instead of training — the first "
                         "live request must meet no new shape (enforced)")
    args = ap.parse_args(argv)
    serve_dir = args.serve_dir or None
    if args.warm_restart and not serve_dir:
        raise SystemExit("[serve] --warm-restart requires --serve-dir")
    if serve_dir and args.neural:
        raise SystemExit("[serve] --serve-dir persists the cascade params "
                         "only — the neural stage's weights are not "
                         "durable state; drop --neural")
    if args.warm_restart and args.params:
        raise SystemExit("[serve] --warm-restart restores the params from "
                         "--serve-dir; drop --params")
    if args.kill_replica and args.replicas < 2:
        raise SystemExit("[serve] --kill-replica needs --replicas >= 2 "
                         "(a survivor must exist to absorb the backlog)")
    if args.profile and (args.pump or args.replicas > 1):
        raise SystemExit("[serve] --profile profiles the single-session "
                         "DES: drop --pump / --replicas")

    log = generate_log(LogConfig(n_queries=800, seed=args.seed))
    tr, te = log.split(0.8)
    cfg = cloes.CASCADE
    lcfg = manifest = None  # the session's defaults unless restored
    t0 = time.perf_counter()
    if args.warm_restart:
        params, cfg, lcfg, manifest = load_serving_state(serve_dir,
                                                         device=args.device)
        print(f"[serve] warm restart from {serve_dir}: restored params + "
              f"manifest ({len(manifest['shapes'])} shapes) in "
              f"{time.perf_counter() - t0:.2f}s, no training")
    elif args.params:
        params = load_params(args.params, cfg, device=args.device)
        print(f"[serve] cascade weights: {args.params}")
    else:
        print("[serve] training cascade...")
        params, cfg = B.fit_cloes(
            tr, lcfg=L.LossConfig(beta=args.beta),
            tcfg=T.TrainConfig(loss="l3", epochs=4, lr=0.01),
            device=args.device)
        print(f"[serve] trained CLOES (L3, beta {args.beta}) in "
              f"{time.perf_counter() - t0:.1f}s")
    train_s = time.perf_counter() - t0
    neural = None
    if args.neural:
        neural = build_neural(args.neural, device=args.device)
        print(f"[serve] neural final stage: {neural.cfg.name}")
    router = None
    t0 = time.perf_counter()
    if args.replicas > 1:
        if args.faults > 0 or args.kill_replica:
            print(f"[serve] CHAOS MODE: rate {args.faults}"
                  + (", replica 0 FORCED DEAD" if args.kill_replica else "")
                  + f" (seed {args.seed})")
        router = build_router(params, cfg, lcfg, n=args.replicas,
                              neural=neural,
                              plan=args.plan, max_queue=args.max_queue,
                              max_wait_ms=args.max_wait_ms,
                              fault_rate=args.faults,
                              kill_replica=args.kill_replica,
                              seed=args.seed, device=args.device)
        ses = router.replicas[0]
        sessions = router.replicas
        if manifest is not None:
            # replay the restored manifest on every replica (co-located
            # replicas share one pipeline and its shape record)
            for r in sessions:
                shapes = r.warm_restart(manifest)
        else:
            shapes = router.warmup()
        print(f"[serve] warmed {len(shapes)} shape buckets on each of "
              f"{args.replicas} replicas ("
              + ", ".join(f"{r.name} on {r.device}"
                          + ("" if r.stream is None else " stream "
                             f"{r.stream.cuda_stream:#x}")
                          for r in sessions)
              + f") in {time.perf_counter() - t0:.1f}s")
    else:
        injector = build_injector(args.faults, args.seed)
        if injector is not None:
            print(f"[serve] CHAOS MODE: fault injection at rate "
                  f"{args.faults} (seed {args.seed})")
        ses = build_session(params, cfg, lcfg, neural=neural, plan=args.plan,
                            max_queue=args.max_queue,
                            max_wait_ms=args.max_wait_ms, faults=injector,
                            device=args.device)
        sessions = [ses]
        shapes = (ses.warm_restart(manifest) if manifest is not None
                  else ses.warmup())
        print(f"[serve] warmed {len(shapes)} shape buckets on {ses.device} "
              f"in {time.perf_counter() - t0:.1f}s")
    warmup_s = time.perf_counter() - t0
    shapes_after_warmup = compiled_count(sessions)

    # -- request generation, timed on its own (NOT charged to the server) --
    t0 = time.perf_counter()
    reqs = make_requests(te, args.requests, args.seed)
    gen_s = time.perf_counter() - t0
    if not reqs:
        print("[serve] no requests submitted — nothing to report")
        return
    print(f"[serve] generated {len(reqs)} requests in {gen_s:.2f}s")

    # -- the serve phase: wall-clock pump(s) or virtual-clock DES ----------
    deadline = args.deadline_ms if args.deadline_ms > 0 else None
    profile = pump_stats = router_stats = None
    if args.pump and router is not None:
        router.attach_pumps([SessionPump(s, name=f"pump-{s.name}").start()
                             for s in router.replicas])
        res = run_wall_clock(router, reqs, args.qps, deadline_ms=deadline,
                             n_threads=args.threads, seed=args.seed)
        # graceful shutdown (--serve-dir): drain the queues so every
        # future resolves with a real result before state is persisted
        router.close(drain=bool(serve_dir))
        router_stats = router.stats_export()
        print(f"[serve] router pump mode: offered {res.offered_qps:.0f} "
              f"QPS from {args.threads} threads over {args.replicas} "
              f"replicas; served {res.completed}/{res.n_requests} in "
              f"{res.wall_s:.2f}s wall ({res.achieved_qps:.0f} QPS)")
        serve_s = res.wall_s
    elif args.pump:
        pump = SessionPump(ses).start()
        res = run_wall_clock(pump, reqs, args.qps, deadline_ms=deadline,
                             n_threads=args.threads, seed=args.seed)
        pump.close(drain=bool(serve_dir))
        pump_stats = pump.stats_export()
        print(f"[serve] pump mode: offered {res.offered_qps:.0f} QPS from "
              f"{args.threads} threads; served {res.completed}/"
              f"{res.n_requests} in {res.wall_s:.2f}s wall "
              f"({res.achieved_qps:.0f} QPS achieved)")
        print(f"[serve] pump stats: "
              f"{ {k: v for k, v in pump_stats.items() if k != 'session'} }")
        serve_s = res.wall_s
    elif router is not None:
        res = run_open_loop_router(router, reqs, args.qps,
                                   deadline_ms=deadline, seed=args.seed)
        router.close(drain=bool(serve_dir))
        router_stats = router.stats_export()
        print(f"[serve] router DES: offered {res.offered_qps:.0f} QPS over "
              f"{args.replicas} replicas; served {res.completed}/"
              f"{res.n_requests} over {res.sim_s:.2f}s simulated "
              f"({res.achieved_qps:.0f} QPS achieved, {res.serve_s:.2f}s "
              "compute)")
        serve_s = res.serve_s
    elif args.profile:
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
        serve_s = res.serve_s
    else:
        res = run_open_loop(ses, reqs, args.qps, deadline_ms=deadline,
                            seed=args.seed)
        serve_s = res.serve_s
    if not args.pump and router is None:
        print(f"[serve] offered {res.offered_qps:.0f} QPS; served "
              f"{res.completed}/{res.n_requests} over {res.sim_s:.2f}s "
              f"simulated ({res.achieved_qps:.0f} QPS achieved, "
              f"{res.serve_s:.2f}s compute)")
    # futures still pending once every pump is closed (run_wall_clock
    # counted those unresolved at its own timeout)
    unresolved = max(res.unresolved,
                     sum(1 for f in res.futures if not f.done()))
    print(f"[serve] shed {res.shed} ({100*res.shed_frac:.1f}%), errors "
          f"{res.errors}, degraded {res.degraded}, deadline-missed "
          f"{res.deadline_missed}, truncated {res.truncated}")
    if len(res.latency_ms):
        print(f"[serve] end-to-end latency: p50 {res.pct(50):.1f}ms "
              f"p95 {res.pct(95):.1f}ms p99 {res.pct(99):.1f}ms")
    if router_stats is not None:
        keys = ("routed", "failovers", "drained", "adopted", "probes",
                "recoveries", "failed")
        print(f"[serve] router stats: "
              f"{ {k: router_stats[k] for k in keys} }")
        for rep in router_stats["replicas"]:
            st = rep.get("session", rep)
            pump_part = ("" if "session" not in rep else
                         f", pump cycles {rep['cycles']} slot joins "
                         f"{rep['slot_joins']} cycle errors "
                         f"{rep['cycle_errors']} restarts {rep['restarts']}")
            print(f"[serve]   {st['name']}: submitted {st['submitted']} "
                  f"completed {st['completed']} shed {st['shed']} errors "
                  f"{st['errors']} drained {st['drained']} adopted "
                  f"{st['adopted']}{pump_part}")
        st = router_stats["global"]
    else:
        st = ses.stats_export()
    print(f"[serve] session stats: {st}")

    if unresolved:
        raise SystemExit(
            f"[serve] FAIL: {unresolved} futures never resolved — every "
            "submitted request must come back with an explicit status")
    # Over the whole fleet (or the single session) every admitted request
    # ends in exactly one terminal state; work drained off a dead replica
    # completes on a survivor, so the drained/adopted legs cancel.
    if st["submitted"] != st["completed"] + st["shed"] + st["errors"]:
        raise SystemExit(
            f"[serve] FAIL: lifecycle accounting does not close — "
            f"submitted {st['submitted']} != completed {st['completed']} "
            f"+ shed {st['shed']} + errors {st['errors']}")
    print("[serve] all futures resolved (zero dropped; "
          "submitted = completed + shed + errors"
          + (" globally across replicas)" if router_stats else ")"))
    # The warm-restart contract: every shape the serve phase needed was
    # run before the first live request. A cold start reports the same
    # number; a warm restart FAILS on it.
    recompiles = compiled_count(sessions) - shapes_after_warmup
    print(f"[serve] recompiles after warmup: {recompiles}")
    if args.warm_restart and recompiles:
        raise SystemExit(
            f"[serve] FAIL: warm restart promised no new shape but the "
            f"serve phase ran {recompiles} shape(s) first seen after warmup")
    if serve_dir:
        save_serving_state(serve_dir, ses)
        print(f"[serve] graceful shutdown: wrote serving state "
              f"(params + warmup manifest) to {serve_dir}")

    if args.report:
        report = {
            "config": {"requests": args.requests, "offered_qps": args.qps,
                       "deadline_ms": args.deadline_ms,
                       "max_queue": args.max_queue, "plan": args.plan,
                       "seed": args.seed, "beta": args.beta,
                       "params": args.params or None,
                       "neural": args.neural or None,
                       "faults": args.faults, "replicas": args.replicas,
                       "kill_replica": args.kill_replica,
                       "mode": "pump" if args.pump else "des",
                       "threads": args.threads if args.pump else None,
                       "serve_dir": serve_dir,
                       "warm_restart": args.warm_restart,
                       "device": str(ses.device),
                       "device_name": (torch.cuda.get_device_name(ses.device)
                                       if ses.device.type == "cuda"
                                       else "cpu")},
            "recompiles_after_warmup": recompiles,
            "phases_s": {"train": train_s, "warmup": warmup_s,
                         "generate": gen_s, "serve": serve_s},
            ("wall_clock" if args.pump else "open_loop"): res.summary(),
            "session_stats": st,
        }
        if profile is not None:
            report["profile"] = profile
        if pump_stats is not None:
            report["pump_stats"] = pump_stats
        if router_stats is not None:
            report["router_stats"] = router_stats
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[serve] wrote {args.report}")
    return res


if __name__ == "__main__":
    main()
