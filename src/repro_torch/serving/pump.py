"""Real-time continuous-batching pump for CascadeSession.

The session's lifecycle core (admission, bucketed pending queues, flush
policy, degraded modes) is explicitly clocked by design — `step(now_ms)`
keeps the DES and the tests deterministic — so nothing in it can serve
CONCURRENT callers in wall-clock time. SessionPump is that serving layer:
a background thread that owns the clock (`time.monotonic`), wrapping the
session lifecycle unchanged behind a thread-safe `submit()`.

Shape (JetStream's interleaved engine + the SHARK service_v1 pattern):

  * submitters call `pump.submit(req, deadline_ms=...)` from any thread
    and block on `RankFuture.result(timeout=)` / `wait()` — one
    threading.Event per future, set exactly once at resolution;
  * the pump thread sleeps until the session's `next_due_ms()` (or a
    submit wakes it), then runs one service cycle through the session's
    claim → pack → execute → resolve seam: claim under the session lock,
    pack/execute OUTSIDE it so submitters never stall behind the
    accelerator, resolve at the measured wall completion time (so
    deadline_missed reflects when service actually finished);
  * slot late-join: a claimed under-full chunk stays `open` while its
    initial rows are staged — a request submitted for the same bucket in
    that window rides one of the pow2-PADDING rows the batch already pays
    for, instead of waiting for the next due time (zero extra compute,
    the row was being computed as zeros anyway);
  * request packing reuses the session's TransferBufferPool (page-locked
    on a CUDA device), so the steady-state hot path performs no host
    allocations;
  * device work goes where the session puts it: a session built with
    `stream=` (a replica of a shared card) enters its own stream inside
    rank_batch/fetch, so the pump thread never launches on the legacy
    default stream, and the fetch that waits for the device runs outside
    every lock;
  * `close()` drains cleanly: in-flight service finishes, then every
    still-queued future resolves with status="shed" (drain=True serves
    them instead) — no future is ever left hanging.

The DES tests keep running on the virtual clock untouched; the pump gets
its own wall-clock soak (tests/test_torch_pump.py, `launch.serve --pump`).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np

from repro_torch.serving.batching import RankRequest
from repro_torch.serving.session import CascadeSession, FlushChunk, RankFuture


def _monotonic_ms() -> float:
    return time.monotonic() * 1e3


class SessionPump:
    """Background pump thread: wall-clock continuous batching over one
    CascadeSession. Construct, `start()` (or use as a context manager),
    `submit()` from any number of threads, `close()` when done."""

    def __init__(self, session: CascadeSession, *,
                 idle_wait_s: float = 0.05, name: str = "cascade-pump",
                 watchdog_interval_s: float = 0.1):
        self.session = session
        self.idle_wait_s = idle_wait_s
        self.watchdog_interval_s = watchdog_interval_s
        self._wake = threading.Event()
        self._closing = False
        self._drain = False
        self._started = False
        self._name = name
        # open (claimed, still-staging) chunk per bucket: submit() slots
        # late arrivals into these — guarded by session.lock
        self._open: dict[int, FlushChunk] = {}
        self.stats = {"cycles": 0, "served": 0, "slot_joins": 0,
                      "shutdown_shed": 0, "cycle_errors": 0, "restarts": 0}
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        # Supervision: chunk-level failures are contained inside
        # _service_cycle (futures resolve as errors, the loop keeps
        # pumping); a bug in the pump loop ITSELF kills the service
        # thread, and the watchdog restarts it so queued futures are
        # never stranded behind a dead thread.
        self._watch_stop = threading.Event()
        self._watchdog = threading.Thread(
            target=self._watch, name=f"{name}-watchdog", daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SessionPump":
        if self._started:
            raise RuntimeError("pump already started")
        self._started = True
        self._thread.start()
        self._watchdog.start()
        return self

    def __enter__(self) -> "SessionPump":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def running(self) -> bool:
        return self._started and self._thread.is_alive()

    def close(self, *, drain: bool = False, timeout: float | None = None
              ) -> None:
        """Stop the pump. In-flight service completes; with drain=True the
        remaining queue is served first, otherwise (shutdown semantics)
        every still-queued future resolves with status="shed". Either way
        no outstanding future is left unresolved."""
        ses = self.session
        with ses.lock:
            self._closing = True
            self._drain = drain
        self._wake.set()
        self._watch_stop.set()
        if self._started:
            self._thread.join(timeout)
            self._watchdog.join(timeout)
        # Whatever the thread did not serve (drain=False, or a raced
        # submit that landed after its last cycle) is shed explicitly.
        n_shed = ses.shed_pending()
        with ses.lock:
            self.stats["shutdown_shed"] += n_shed

    def wake(self) -> None:
        """Kick the pump thread out of its idle/due-time sleep — the
        router calls this after grafting drained entries into this pump's
        session (adopt_entries bypasses submit(), so nothing else would
        wake the thread before its idle timeout)."""
        self._wake.set()

    # -- submission --------------------------------------------------------

    def submit(self, req: RankRequest, *,
               deadline_ms: float | None = None) -> RankFuture:
        """Thread-safe admission on the pump's wall clock. deadline_ms is
        a RELATIVE budget (the pump owns the absolute clock — callers
        never see raw monotonic time). Admission control, degradation and
        shedding behave exactly as session.submit."""
        ses = self.session
        with ses.lock:
            if self._closing:
                raise RuntimeError("pump is closed — no new submissions")
            now = _monotonic_ms()
            fut = ses.submit(
                req, now_ms=now,
                deadline_ms=None if deadline_ms is None
                else now + deadline_ms)
            if not fut.done() and fut.bucket is not None:
                self._try_slot_join(fut)
        self._wake.set()
        return fut

    def _try_slot_join(self, fut: RankFuture) -> None:
        """Move the just-queued entry into an open in-flight chunk for its
        bucket, if one has a free padded row — the late arrival departs
        with the imminent flush instead of waiting for the next due time.
        Caller holds session.lock."""
        chunk = self._open.get(fut.bucket)
        if (chunk is None or not chunk.open
                or len(chunk.entries) >= chunk.capacity):
            return
        queue = self.session._pending[fut.bucket]
        assert queue and queue[-1].future is fut
        chunk.entries.append(queue.pop())
        # pending -> inflight, same as claim_bucket: the entry left the
        # queue for a claimed chunk, and the snapshot identity must see it
        self.session.stats["inflight"] += 1
        self.stats["slot_joins"] += 1

    # -- the pump loop -----------------------------------------------------

    def _run(self) -> None:
        ses = self.session
        while True:
            self._wake.clear()
            with ses.lock:
                closing, drain = self._closing, self._drain
                due = ses.next_due_ms()
            if due is None:
                if closing:
                    return
                self._wake.wait(self.idle_wait_s)
                continue
            if closing and not drain:
                return                          # close() sheds the queue
            now = _monotonic_ms()
            if due > now and not closing:
                # sleep until the earliest due time or the next submit
                # (which may create an earlier one); cap so a stray clock
                # never wedges the pump
                self._wake.wait(min((due - now) / 1e3, self.idle_wait_s))
                continue
            self._service_cycle(claim_at=math.inf if closing else now)

    def _service_cycle(self, claim_at: float) -> None:
        """One continuous-batching cycle through the session's seam.

        Exception-safe: execute_chunk already turns executor failures
        into explicit error results, but a bug anywhere else in the
        pack → resolve seam would kill the service thread and hang every
        blocked future forever. Instead any escaped exception resolves
        the claimed chunk's futures with status="error" and the loop
        keeps pumping; the finally block guarantees the open-chunk
        registration never leaks (a stale entry in self._open would
        swallow that bucket's slot-joins into a chunk nobody will ever
        execute)."""
        ses = self.session
        start = _monotonic_ms()
        chunk = ses.claim_due(claim_at)
        if chunk is None:
            return
        try:
            with ses.lock:
                self.stats["cycles"] += 1
                if (len(chunk.entries) < chunk.capacity
                        and not self._closing):
                    chunk.open = True
                    self._open[chunk.g] = chunk
            # Stage the claimed rows OUTSIDE the lock: submitters keep
            # running, and same-bucket arrivals slot-join the open chunk.
            ses.pack_chunk(chunk)
            with ses.lock:
                chunk.open = False
                if self._open.get(chunk.g) is chunk:
                    del self._open[chunk.g]
            ses.pack_chunk(chunk)               # late joiners' rows
            results = ses.execute_chunk(chunk)
            done = _monotonic_ms()
            resps = ses.resolve_chunk(chunk, results, now_ms=start,
                                      done_ms=done)
            with ses.lock:
                self.stats["served"] += len(resps)
        except Exception as e:                  # noqa: BLE001 — contain:
            # a crashed cycle must cost exactly its own chunk, resolved
            # with an explicit error, never the service thread
            with ses.lock:
                self.stats["cycle_errors"] += 1
            ses.fail_chunk(chunk, e, now_ms=start,
                           done_ms=_monotonic_ms())
        finally:
            with ses.lock:
                chunk.open = False
                if self._open.get(chunk.g) is chunk:
                    del self._open[chunk.g]

    # -- supervision -------------------------------------------------------

    def _watch(self) -> None:
        """Watchdog: restart the service thread if it ever dies while the
        pump is open. _service_cycle contains chunk-level failures, so a
        dead thread means a bug in the pump loop itself — restarting it
        keeps queued futures from being stranded; close() still sheds
        whatever remains, so the no-hung-future contract holds either
        way."""
        while not self._watch_stop.wait(self.watchdog_interval_s):
            with self.session.lock:
                if self._closing:
                    return
                dead = self._started and not self._thread.is_alive()
                if dead:
                    self.stats["restarts"] += 1
                    self._thread = threading.Thread(
                        target=self._run, name=self._name, daemon=True)
                    self._thread.start()

    def stats_export(self) -> dict:
        """Pump counters (cycles/served/slot_joins/shutdown_shed/
        cycle_errors/restarts) plus the wrapped session's full metrics
        surface (lifecycle, faults, pool allocated/reused). The pump
        counters are copied under the session lock — every mutation site
        holds it, so a live reporter cannot read a half-updated cycle."""
        with self.session.lock:
            out = dict(self.stats)
        out["running"] = self.running
        out["session"] = self.session.stats_export()
        return out


# ---------------------------------------------------------------------------
# Wall-clock open-loop driver: N submitter threads against a live pump —
# the real-time counterpart of loadgen.run_open_loop's virtual-clock DES.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WallClockResult:
    offered_qps: float
    n_requests: int
    completed: int
    shed: int
    unresolved: int         # futures never resolved — must always be 0
    degraded: int
    deadline_missed: int
    truncated: int
    wall_s: float           # first submit -> last future resolved
    latency_ms: np.ndarray  # per served request: wait_ms + service_ms
    errors: int = 0         # status="error": service failed after retries
    futures: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def achieved_qps(self) -> float:
        return self.completed / self.wall_s if self.wall_s > 0 else 0.0

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
            "unresolved": self.unresolved,
            "errors": self.errors,
            "degraded": self.degraded,
            "deadline_missed": self.deadline_missed,
            "truncated": self.truncated,
            "wall_s": self.wall_s,
            "latency_ms": {"p50": self.pct(50), "p95": self.pct(95),
                           "p99": self.pct(99),
                           "mean": float(np.mean(self.latency_ms))
                           if len(self.latency_ms) else float("nan")},
        }


def run_wall_clock(pump: SessionPump, reqs: list[RankRequest], qps: float,
                   *, deadline_ms: float | None = None, n_threads: int = 4,
                   seed: int = 0, result_timeout_s: float = 60.0
                   ) -> WallClockResult:
    """Offer `reqs` to a RUNNING pump from n_threads submitter threads at
    aggregate Poisson rate `qps` (each thread offers qps/n_threads), then
    block until every future resolves. The pump is left running — the
    caller owns close()."""
    if not pump.running:
        raise RuntimeError("run_wall_clock needs a started pump")
    rng = np.random.default_rng(seed)
    shards = [reqs[k::n_threads] for k in range(n_threads)]
    gaps = [rng.exponential(n_threads / max(qps, 1e-9), size=len(s))
            for s in shards]
    futures_by_shard: list[list[RankFuture]] = [[] for _ in shards]

    def submitter(k: int) -> None:
        for req, gap in zip(shards[k], gaps[k]):
            time.sleep(gap)
            futures_by_shard[k].append(
                pump.submit(req, deadline_ms=deadline_ms))

    t0 = time.monotonic()
    threads = [threading.Thread(target=submitter, args=(k,), daemon=True)
               for k in range(len(shards)) if shards[k]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    futures = [f for shard in futures_by_shard for f in shard]
    deadline_wall = time.monotonic() + result_timeout_s
    for f in futures:
        f.wait(max(deadline_wall - time.monotonic(), 0.0))
    wall_s = time.monotonic() - t0

    shed = completed = degraded = missed = truncated = unresolved = 0
    errors = 0
    latencies = []
    for f in futures:
        if not f.done():
            unresolved += 1
            continue
        r = f.result()
        if r.status == "shed":
            shed += 1
            continue
        if r.status == "error":
            errors += 1
            continue
        completed += 1
        latencies.append(r.wait_ms + r.service_ms)
        degraded += bool(r.degraded)
        missed += r.deadline_missed
        truncated += r.truncated
    return WallClockResult(
        offered_qps=qps, n_requests=len(reqs), completed=completed,
        shed=shed, unresolved=unresolved, degraded=degraded,
        deadline_missed=missed, truncated=truncated, wall_s=wall_s,
        latency_ms=np.asarray(latencies), errors=errors, futures=futures)
