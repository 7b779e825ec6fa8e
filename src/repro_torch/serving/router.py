"""Multi-replica serving router: one admission point over N replicas.

CLOES is not one server: the operational system spreads ~40k QPS across
hundreds of machines (paper §4.1), with a steering layer placing work on
replicated rankers behind a single admission point — the baseline
production-ranking architecture. This module is that layer for this repo:

  * `ReplicaRouter` owns N replicas, each a warmed `CascadeSession`
    (+ optionally a per-replica `SessionPump` for wall-clock serving)
    bound to one device from `launch.mesh.replica_devices`. Replicas that
    share a CUDA card each get their own `torch.cuda.Stream`
    (`make_replicas`), so their copies and kernels overlap on the card
    instead of serialising on one stream; co-located replicas share one
    pipeline and its shape record via `pipeline_from`. On the CPU the
    same code serves N simulated replicas, so tests exercise the full
    multi-replica path;
  * placement is least-loaded: each submit lands on the replica with the
    smallest queue-depth + inflight score, so a slow or degraded replica
    naturally receives less new work;
  * admission is GLOBAL: every replica's `depth_fn` is wired to the
    router's aggregate depth, so bounded-queue shedding and the
    degradation watermarks judge total system load, not one replica's
    slice — one admission controller, N executors. (The aggregate read
    is lock-free by design: taking a second session lock from inside a
    replica's submit path could deadlock two concurrent submitters.)
  * failover rides the session's circuit breaker: a replica whose breaker
    trips open is treated as FAILED — its queued backlog atomically drains
    (`takeover_pending`) and is grafted onto the least-loaded survivors
    (`adopt_entries`, at the queue FRONT so FIFO seniority survives the
    move). Adopted work is re-claimed through the ordinary
    `claim_*`/`pack_chunk` seams: same shapes (each survivor's warmed
    pow2 ladder), the same results, and every future still resolves
    exactly once because futures travel with their entries. Entries
    move, never device tensors: the survivor packs them into its own
    buffers and runs them on its own stream;
  * recovery is probed: once a failed replica's queue is empty, the
    router periodically submits one synthetic probe (negative request
    id, zeroed features, smallest bucket) straight to it — a recovered
    executor serves the probe, resets the breaker's consecutive-fault
    count, and the replica rejoins placement.

The DES driver for this layer is `loadgen.run_open_loop_router` (virtual
clock, per-replica service concurrency); the wall-clock driver is the
existing `pump.run_wall_clock`, which duck-types against the router's
`running`/`submit` exactly as against a single pump.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

import torch

from repro_torch.serving.batching import RankRequest
from repro_torch.serving.pump import SessionPump
from repro_torch.serving.session import CascadeSession, RankFuture


def _monotonic_ms() -> float:
    return time.monotonic() * 1e3


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Placement / failover policy for ReplicaRouter."""
    inflight_weight: float = 1.0    # in-flight entries' weight in the
    #                                 least-loaded placement score
    failover: bool = True           # drain a breaker-open replica's backlog
    #                                 to survivors (False strands it behind
    #                                 the broken executor;
    #                                 tests/test_torch_router.py pins that)
    probe_interval_ms: float = 50.0  # min gap between re-admission probes
    #                                 per failed replica


class ReplicaRouter:
    """One admission controller over N replica sessions.

    Construct with DES replicas (no pumps — an explicit-clock driver
    claims and executes on each replica itself) or with one started
    `SessionPump` per replica for wall-clock serving. Either way, callers
    submit through the router only; placement, global admission, failover
    and probe re-admission are its job."""

    def __init__(self, replicas: list[CascadeSession],
                 rcfg: RouterConfig | None = None, *,
                 pumps: list[SessionPump] | None = None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas = list(replicas)
        self.pumps: list[SessionPump] | None = None
        self.rcfg = rcfg or RouterConfig()
        self._ctl: threading.Thread | None = None
        self._ctl_stop = threading.Event()
        # Router-private state (failed set, probe clock, counters) under
        # its OWN lock — never held while taking a session lock with
        # another session lock already held.
        self._lock = threading.Lock()
        self._failed: set[int] = set()
        self._last_probe_ms: dict[int, float] = {}
        self._probe_seq = 0
        self.stats = {"routed": 0, "failovers": 0, "drained": 0,
                      "adopted": 0, "probes": 0, "recoveries": 0}
        # Global admission: every replica judges the ROUTER's depth.
        for r in self.replicas:
            r.depth_fn = self.global_depth
        if pumps is not None:
            self.attach_pumps(pumps)

    def attach_pumps(self, pumps: list[SessionPump]) -> None:
        """Bind one pump per replica (wall-clock mode) and start the
        control-plane thread: on the wall clock nothing else runs tick()
        once submissions stop, so without it a breaker tripping after the
        last submit would strand that replica's backlog until close()."""
        if len(pumps) != len(self.replicas):
            raise ValueError("pumps must align 1:1 with replicas")
        for p, s in zip(pumps, self.replicas):
            if p.session is not s:
                raise ValueError(
                    "pumps[k] must wrap replicas[k] (pump-per-replica)")
        self.pumps = list(pumps)
        self._ctl = threading.Thread(target=self._control_loop,
                                     name="router-control", daemon=True)
        self._ctl.start()

    def _control_loop(self) -> None:
        while not self._ctl_stop.wait(0.02):
            self.tick()

    # -- load signals ------------------------------------------------------

    def global_depth(self) -> int:
        """Total queued depth across replicas — the admission controller's
        input. Lock-free (GIL-atomic list lengths): called from inside a
        replica's submit path, where taking other replicas' session locks
        could deadlock concurrent submitters."""
        return sum(r.queue_depth() for r in self.replicas)

    @property
    def pending(self) -> int:
        return self.global_depth()

    def _load(self, k: int) -> float:
        """Least-loaded placement score for replica k: queued depth plus
        weighted in-flight entries (a replica mid-execute is busier than
        its queue alone shows). Lock-free reads — approximate is fine,
        placement only needs to be directionally right."""
        r = self.replicas[k]
        return (r.queue_depth()
                + self.rcfg.inflight_weight * r.stats["inflight"])

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        """Duck-types SessionPump.running for run_wall_clock: True when
        every per-replica pump is alive (DES mode has no pumps and is
        always 'running' — the driver owns the clock)."""
        if self.pumps is None:
            return True
        return all(p.running for p in self.pumps)

    def warmup(self) -> list[tuple[int, int]]:
        """Run every replica's pipeline once for every serving shape, each
        on its own stream (co-located replicas share one pipeline and one
        shape record)."""
        shapes: list[tuple[int, int]] = []
        for r in self.replicas:
            shapes = r.warmup()
        return shapes

    def close(self, *, drain: bool = False, timeout: float | None = None
              ) -> int:
        """Stop serving. Pumps (if any) close first — in-flight service
        completes, drain=True serves the remaining queues — then every
        still-queued future on every replica resolves with status="shed".
        Returns the number of futures shed; afterwards no future anywhere
        in the fleet is unresolved."""
        self._ctl_stop.set()
        if self._ctl is not None:
            self._ctl.join(timeout)
        if self.pumps is not None:
            for p in self.pumps:
                p.close(drain=drain, timeout=timeout)
        return sum(r.shed_pending() for r in self.replicas)

    # -- admission ---------------------------------------------------------

    def submit(self, req: RankRequest, *,
               deadline_ms: float | None = None,
               now_ms: float | None = None) -> RankFuture:
        """Admit one request through the global controller and place it on
        the least-loaded live replica. In pump mode deadline_ms is a
        RELATIVE budget (each pump owns its wall clock, exactly like
        SessionPump.submit); in DES mode it is ABSOLUTE on the driver's
        virtual clock, exactly like CascadeSession.submit."""
        now = _monotonic_ms() if now_ms is None else float(now_ms)
        self.tick(now)
        k = self._place()
        with self._lock:
            self.stats["routed"] += 1
        if self.pumps is not None:
            return self.pumps[k].submit(req, deadline_ms=deadline_ms)
        return self.replicas[k].submit(req, deadline_ms=deadline_ms,
                                       now_ms=now_ms)

    def _place(self) -> int:
        """Least-loaded placement over live replicas. With every breaker
        open there is nowhere good to place — fall back to least-loaded
        over ALL replicas, whose own breaker-open admission then sheds
        (global shedding degrades gracefully instead of raising)."""
        with self._lock:
            failed = set(self._failed)
        alive = [k for k in range(len(self.replicas)) if k not in failed]
        pool = alive or list(range(len(self.replicas)))
        return min(pool, key=self._load)

    # -- failover ----------------------------------------------------------

    def tick(self, now_ms: float | None = None) -> None:
        """One control-plane pass: detect newly opened breakers (drain
        their backlogs to survivors), probe failed replicas for recovery,
        and re-admit the recovered. Called on every submit; explicit-clock
        drivers also call it between service events so failures that trip
        mid-soak are noticed without new arrivals."""
        now = _monotonic_ms() if now_ms is None else float(now_ms)
        self._check_failover()
        self._probe_failed(now)

    def _check_failover(self) -> None:
        # two passes: mark EVERY newly opened breaker before draining any
        # backlog, so simultaneous failures never drain onto a peer whose
        # own breaker is open but not yet discovered
        newly_failed: list[int] = []
        for k, r in enumerate(self.replicas):
            with self._lock:
                failed = k in self._failed
            if not failed and r._breaker_open():
                with self._lock:
                    self._failed.add(k)
                    self.stats["failovers"] += 1
                newly_failed.append(k)
            elif failed and not r._breaker_open():
                # a probe (or the last inflight chunk) succeeded: the
                # breaker's consecutive-fault count reset to 0
                with self._lock:
                    self._failed.discard(k)
                    self._last_probe_ms.pop(k, None)
                    self.stats["recoveries"] += 1
        if self.rcfg.failover:
            for k in newly_failed:
                self._drain(k)

    def _drain(self, dead: int) -> None:
        """Move the failed replica's entire queued backlog to survivors.
        Futures travel with their entries; adopted work re-enters each
        survivor's queues at the FRONT (seniority preserved) and is served
        through the normal claim/pack/execute seams — warmed shapes only,
        the same results."""
        with self._lock:
            failed = set(self._failed)
        survivors = [k for k in range(len(self.replicas))
                     if k not in failed]
        if not survivors:
            # nowhere to drain to: leave the backlog in place — it still
            # resolves (execute turns faults into explicit errors), and
            # probes may yet recover a replica
            return
        taken = self.replicas[dead].takeover_pending()
        moved = 0
        woken: set[int] = set()
        for g, entries in taken.items():
            k = min(survivors, key=self._load)
            moved += self.replicas[k].adopt_entries(g, entries)
            woken.add(k)
        with self._lock:
            self.stats["drained"] += moved
            self.stats["adopted"] += moved
        if self.pumps is not None:
            for k in woken:
                # adopt_entries bypasses submit(): kick the pump awake
                self.pumps[k].wake()

    # -- probe re-admission ------------------------------------------------

    def _probe_request(self, session: CascadeSession) -> RankRequest:
        """A synthetic probe: negative request id (never collides with
        caller traffic), zeroed features, one item — packs into the
        smallest warmed bucket at batch rows 1."""
        with self._lock:
            self._probe_seq += 1
            seq = self._probe_seq
        return RankRequest(
            request_id=-seq,
            q_feat=np.zeros(session.cfg.d_q, np.float32),
            item_feats=np.zeros((1, session.cfg.d_x), np.float32),
            m_q=1)

    def _probe_failed(self, now_ms: float) -> None:
        """Submit one probe per failed, fully-drained replica, rate-limited
        to probe_interval_ms. The probe is admitted because the session's
        breaker-open shed only applies while pending > 0; it is then served
        synchronously through the claim seam, on the replica's own stream
        and outside the router's lock (under a live pump the pump may
        claim it first — either server works: success resets the
        breaker, failure keeps it open)."""
        for k in sorted(self._failed_snapshot()):
            r = self.replicas[k]
            if r.pending > 0 or r.stats["inflight"] > 0:
                continue                    # still draining: not probe time
            with self._lock:
                last = self._last_probe_ms.get(k)
                # 0 <= elapsed: a DES driver's virtual clock restarts at 0
                # each run — a last-probe stamp from a previous run's clock
                # must not suppress probes forever
                if (last is not None
                        and 0 <= now_ms - last < self.rcfg.probe_interval_ms):
                    continue
                self._last_probe_ms[k] = now_ms
                self.stats["probes"] += 1
            fut = r.submit(self._probe_request(r), now_ms=now_ms)
            if fut.done():
                continue                    # raced a concurrent submitter
            chunk = r.claim_bucket(fut.bucket)
            if chunk is None:
                continue                    # a pump claimed the probe
            results = r.execute_chunk(chunk)
            r.resolve_chunk(chunk, results, now_ms)
            # success reset _consec_faults inside execute; the next tick's
            # _check_failover re-admits the replica

    def _failed_snapshot(self) -> set[int]:
        with self._lock:
            return set(self._failed)

    # -- reporting ---------------------------------------------------------

    def stats_export(self) -> dict:
        """Router counters, each replica's full metrics surface, and the
        GLOBAL aggregate with its accounting identity:
          Σ submitted = Σ completed + shed + errors + pending + inflight
        (the per-replica drained/adopted legs cancel in the sum — adopted
        work completes on a different replica than it was submitted to)."""
        with self._lock:
            out: dict = dict(self.stats)
            out["failed"] = sorted(self._failed)
        out["n_replicas"] = len(self.replicas)
        if self.pumps is not None:
            per = [p.stats_export() for p in self.pumps]
            out["replicas"] = per
            sessions = [p["session"] for p in per]
        else:
            sessions = [r.stats_export() for r in self.replicas]
            out["replicas"] = sessions
        glob = {key: sum(s[key] for s in sessions)
                for key in ("submitted", "completed", "shed", "errors",
                            "refused", "pending", "inflight", "drained",
                            "adopted", "faults", "retries", "quarantined")}
        out["global"] = glob
        return out


def make_replicas(params, cfg, lcfg=None, n: int = 2, *,
                  neural_stage=None, scfg=None,
                  faults: list | None = None,
                  devices: list | None = None,
                  name_prefix: str = "replica") -> list[CascadeSession]:
    """Build N replica sessions over shared params. `devices` (e.g.
    launch.mesh.replica_devices(n)) pins replica k to devices[k]; without
    it every replica is on the CUDA card, the sessions' default. Each replica
    on a CUDA device gets its own `torch.cuda.Stream`, so replicas sharing
    a card overlap there; replicas co-located on one device share the
    first one's pipeline via `pipeline_from`. `faults` is an optional
    per-replica FaultInjector list (None entries fine) — the chaos tests'
    per-replica targeting seam."""
    if faults is not None and len(faults) != n:
        raise ValueError("faults must have one entry per replica")
    if devices is not None and len(devices) != n:
        raise ValueError("devices must have one entry per replica")
    sessions: list[CascadeSession] = []
    for k in range(n):
        dev = torch.device(devices[k] if devices is not None else "cuda")
        stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" \
            else None
        donor = next((s for s in sessions if s.device == dev), None)
        sessions.append(CascadeSession(
            params, cfg, lcfg, neural_stage=neural_stage, scfg=scfg,
            faults=faults[k] if faults is not None else None,
            name=f"{name_prefix}{k}", device=dev, stream=stream,
            pipeline_from=donor))
    return sessions
