"""Open-loop load generation for CascadeSession.

Closed-loop load generators (submit everything, then serve) can never exhibit the
paper's peak-load behavior: the arrival process adapts to the server, so
the queue never grows and nothing ever sheds. This module drives a session
OPEN-LOOP — Poisson inter-arrivals at a fixed offered rate, arrivals do
not wait for service — as a discrete-event simulation on a virtual
millisecond clock whose service times are REAL measured compute:

  * arrival i happens at virtual time A_i = sum of exp(1/qps) gaps;
  * submit/step run against the virtual clock, so flush policy, deadlines
    and admission control behave exactly as they would in real time;
  * every step() that flushes a chunk advances the virtual clock by the
    chunk's measured wall-clock service time.

When the offered rate exceeds the host's service rate the virtual clock
falls behind the arrival process, the queue fills, and the session sheds /
degrades — the fig-5 saturation sweep and launch.serve both report from
this generator. Request *generation* cost never pollutes the numbers: the
caller builds the request list up front and times it separately.

`run_open_loop_router` drives N replicas behind a ReplicaRouter the same
way, each replica with its own virtual service clock.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.batching import RankRequest
from repro_torch.serving.session import CascadeSession


@dataclasses.dataclass
class OpenLoopResult:
    offered_qps: float
    n_requests: int
    completed: int
    shed: int
    degraded: int
    deadline_missed: int
    truncated: int
    unresolved: int         # futures never resolved — must always be 0
    serve_s: float          # real wall-clock spent in step()/flush compute
    sim_s: float            # virtual span from first arrival to last resolve
    latency_ms: np.ndarray  # per served request: resolve - arrival (virtual)
    errors: int = 0         # status="error": service failed after retries
    futures: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def achieved_qps(self) -> float:
        return self.completed / self.sim_s if self.sim_s > 0 else 0.0

    @property
    def shed_frac(self) -> float:
        return self.shed / max(self.n_requests, 1)

    def pct(self, p: float) -> float:
        return float(np.percentile(self.latency_ms, p)) \
            if len(self.latency_ms) else float("nan")

    def summary(self) -> dict:
        return {
            "offered_qps": self.offered_qps,
            "achieved_qps": self.achieved_qps,
            "n_requests": self.n_requests,
            "completed": self.completed,
            "shed": self.shed,
            "shed_frac": self.shed_frac,
            "errors": self.errors,
            "degraded": self.degraded,
            "deadline_missed": self.deadline_missed,
            "truncated": self.truncated,
            "unresolved": self.unresolved,
            "serve_s": self.serve_s,
            "sim_s": self.sim_s,
            "latency_ms": {"p50": self.pct(50), "p95": self.pct(95),
                           "p99": self.pct(99),
                           "mean": float(np.mean(self.latency_ms))
                           if len(self.latency_ms) else float("nan")},
        }


def run_open_loop(session: CascadeSession, reqs: list[RankRequest],
                  qps: float, *, deadline_ms: float | None = None,
                  seed: int = 0, timer=time.perf_counter) -> OpenLoopResult:
    """Drive `reqs` through `session` at offered rate `qps` (Poisson).

    deadline_ms is a per-request RELATIVE budget (absolute deadline =
    arrival + deadline_ms). Returns per-request virtual latencies
    (resolve - arrival, queue wait + measured service) and the lifecycle
    counts. Every future is accounted for; `unresolved` must come back 0.

    `timer` is the service-time clock (seconds, perf_counter semantics).
    The default measures REAL compute; the determinism tests inject a
    fake deterministic timer so two same-seed runs produce byte-identical
    reports — every other source of randomness here is already seeded.
    """
    if not reqs:
        return OpenLoopResult(
            offered_qps=qps, n_requests=0, completed=0, shed=0, degraded=0,
            deadline_missed=0, truncated=0, unresolved=0, serve_s=0.0,
            sim_s=0.0, latency_ms=np.empty(0))
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1e3 / qps, size=len(reqs)))
    now = 0.0                   # when the (synchronous) server is next free
    serve_s = 0.0
    arrival_of: dict[int, float] = {}
    latencies: list[float] = []
    completions = {"degraded": 0, "deadline_missed": 0, "truncated": 0,
                   "errors": 0}
    futures = []
    last_resolve = 0.0
    i = 0

    def record(resps, done_ms):
        nonlocal last_resolve
        last_resolve = max(last_resolve, done_ms)
        for r in resps:
            if r.status == "error":
                # service failed after retries (fault injection / a real
                # executor fault): an explicit outcome, not a completion
                completions["errors"] += 1
                continue
            latencies.append(done_ms - arrival_of[r.request_id])
            completions["degraded"] += bool(r.degraded)
            # the session's accounting is resolve-time-consistent (the
            # virtual completion time is passed into resolve_chunk), so
            # the response flag IS the truth — no local re-check
            completions["deadline_missed"] += r.deadline_missed
            completions["truncated"] += r.truncated

    # Event loop in virtual-time order. The two event kinds are "request
    # arrives at arr_i" and "a due chunk starts service at
    # max(server-free, due)". Every arrival earlier than the next flush
    # instant is admitted FIRST — while the server is busy (now has raced
    # ahead of the arrival process), arrivals keep landing in the queue,
    # which is exactly how an open-loop overload fills a bounded queue.
    while i < len(reqs) or session.pending:
        due = session.next_due_ms()
        t_flush = None if due is None else max(now, due)
        if i < len(reqs) and (t_flush is None or arrivals[i] <= t_flush):
            arr = float(arrivals[i])
            req = reqs[i]
            i += 1
            arrival_of[req.request_id] = arr
            fut = session.submit(
                req, now_ms=arr,
                deadline_ms=None if deadline_ms is None
                else arr + deadline_ms)
            futures.append(fut)
            # simulation time has reached arr: an idle server fast-forwards
            # to the arrival (it cannot serve a batch before the requests
            # that form it exist)
            now = max(now, arr)
            if fut.done():              # shed at admission
                last_resolve = max(last_resolve, arr)
            continue
        if t_flush is None:
            break
        # claim -> execute -> resolve: the chunk starts service at t_flush
        # (virtual), its REAL compute time is measured around execute, and
        # the virtual completion time t_flush + dt is passed through to
        # resolve_chunk so deadline accounting happens at completion — a
        # chunk that starts before its deadline but finishes after is
        # reported late by the session itself.
        chunk = session.claim_due(t_flush)
        if chunk is None:               # defensive: due bucket raced away
            now = t_flush
            continue
        t0 = timer()
        results = session.execute_chunk(chunk)
        dt_ms = (timer() - t0) * 1e3
        serve_s += dt_ms / 1e3
        now = t_flush + dt_ms
        resps = session.resolve_chunk(chunk, results, now_ms=t_flush,
                                      done_ms=now)
        record(resps, now)
    # loop exit requires session.pending == 0 (next_due_ms() is None only
    # when every bucket is empty): nothing is ever left hanging here

    shed = sum(1 for f in futures if f.done() and f.result().status == "shed")
    unresolved = sum(1 for f in futures if not f.done())
    sim_s = max(last_resolve - float(arrivals[0]), 1e-9) / 1e3
    return OpenLoopResult(
        offered_qps=qps, n_requests=len(reqs),
        completed=len(latencies), shed=shed,
        degraded=completions["degraded"],
        deadline_missed=completions["deadline_missed"],
        truncated=completions["truncated"],
        unresolved=unresolved, serve_s=serve_s, sim_s=sim_s,
        latency_ms=np.asarray(latencies), errors=completions["errors"],
        futures=futures)


def run_open_loop_router(router, reqs: list[RankRequest], qps: float, *,
                         deadline_ms: float | None = None, seed: int = 0,
                         timer=time.perf_counter) -> OpenLoopResult:
    """The N-replica counterpart of run_open_loop: one open-loop Poisson
    arrival stream submitted through a ReplicaRouter, served as a DES
    with PER-REPLICA virtual service concurrency.

    Each replica k has its own virtual free time `free_at[k]`; a due
    chunk on replica k starts service at max(due_k, free_at[k]), its REAL
    measured compute advances only that replica's clock, and the
    simulation always processes the globally earliest service start — so
    two replicas genuinely overlap in virtual time even though this
    driver executes their chunks one after the other (each on its own
    stream). That is how N replicas beat one on virtual-time throughput:
    the offered load splits across clocks that run in parallel.

    With one replica this reduces to run_open_loop's schedule exactly:
    free_at[0] plays the single `now`, every event lands at the same
    virtual instant, and same seed + same timer gives byte-identical
    results (tests/test_torch_router.py pins it).

    `router.tick(now)` runs at each event boundary, so a breaker that
    trips mid-soak triggers failover (backlog drains to survivors) and
    probe re-admission on the virtual clock with no new arrivals needed.
    """
    if not reqs:
        return OpenLoopResult(
            offered_qps=qps, n_requests=0, completed=0, shed=0, degraded=0,
            deadline_missed=0, truncated=0, unresolved=0, serve_s=0.0,
            sim_s=0.0, latency_ms=np.empty(0))
    replicas = router.replicas
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1e3 / qps, size=len(reqs)))
    free_at = [0.0] * len(replicas)
    now = 0.0                   # sim front: latest event processed
    serve_s = 0.0
    arrival_of: dict[int, float] = {}
    latencies: list[float] = []
    completions = {"degraded": 0, "deadline_missed": 0, "truncated": 0,
                   "errors": 0}
    futures = []
    last_resolve = 0.0
    i = 0

    def record(resps, done_ms):
        nonlocal last_resolve
        last_resolve = max(last_resolve, done_ms)
        for r in resps:
            if r.request_id < 0:
                continue        # router probe, not caller traffic
            if r.status == "error":
                completions["errors"] += 1
                continue
            latencies.append(done_ms - arrival_of[r.request_id])
            completions["degraded"] += bool(r.degraded)
            completions["deadline_missed"] += r.deadline_missed
            completions["truncated"] += r.truncated

    while i < len(reqs) or router.pending:
        # control plane on the virtual clock: failover drains and probes
        # happen between events, exactly like a real steering loop
        router.tick(now)
        best_k, best_start = None, float("inf")
        for k, r in enumerate(replicas):
            due = r.next_due_ms()
            if due is None:
                continue
            start = max(due, free_at[k])
            if start < best_start:
                best_k, best_start = k, start
        if i < len(reqs) and (best_k is None or arrivals[i] <= best_start):
            arr = float(arrivals[i])
            req = reqs[i]
            i += 1
            arrival_of[req.request_id] = arr
            fut = router.submit(
                req, now_ms=arr,
                deadline_ms=None if deadline_ms is None
                else arr + deadline_ms)
            futures.append(fut)
            # simulation time has reached arr: an idle replica cannot have
            # served before the requests forming its batch existed
            for k in range(len(free_at)):
                free_at[k] = max(free_at[k], arr)
            now = max(now, arr)
            if fut.done():
                last_resolve = max(last_resolve, arr)
            continue
        if best_k is None:
            break
        rep = replicas[best_k]
        chunk = rep.claim_due(best_start)
        if chunk is None:       # defensive: the due bucket raced away
            now = max(now, best_start)      # (e.g. a failover drain moved
            free_at[best_k] = best_start    # it between tick and claim)
            continue
        t0 = timer()
        results = rep.execute_chunk(chunk)
        dt_ms = (timer() - t0) * 1e3
        serve_s += dt_ms / 1e3
        done = best_start + dt_ms
        free_at[best_k] = done
        now = max(now, done)
        resps = rep.resolve_chunk(chunk, results, now_ms=best_start,
                                  done_ms=done)
        record(resps, done)
    router.tick(now)

    shed = sum(1 for f in futures if f.done() and f.result().status == "shed")
    unresolved = sum(1 for f in futures if not f.done())
    sim_s = max(last_resolve - float(arrivals[0]), 1e-9) / 1e3
    return OpenLoopResult(
        offered_qps=qps, n_requests=len(reqs),
        completed=len(latencies), shed=shed,
        degraded=completions["degraded"],
        deadline_missed=completions["deadline_missed"],
        truncated=completions["truncated"],
        unresolved=unresolved, serve_s=serve_s, sim_s=sim_s,
        latency_ms=np.asarray(latencies), errors=completions["errors"],
        futures=futures)
