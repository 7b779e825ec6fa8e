"""Deterministic fault injection for the serving stack (chaos testing).

CLOES-scale serving (hundreds of servers, hundreds of millions of
queries/day) treats executor faults, latency spikes, and bad inputs as
routine, not exceptional — so the serving stack's contract ("every
future always resolves with an explicit status") has to hold under them,
and that can only be *tested* if faults are reproducible. This module is
the one fault source for the whole stack:

  * `FaultInjector` wraps the session's chunk-execute seam with four
    fault classes, each at its own configured rate:
      - transient:  the execute attempt raises `TransientFault` — a retry
        re-draws, so transients clear under the session's capped
        exponential backoff;
      - latency:    the attempt sleeps `latency_spike_ms` first (a slow
        shard / GC pause). On the wall clock this is real delay; under
        the DES the sleep is *measured* around execute and becomes
        virtual service time, so deadline accounting sees it either way;
      - corrupt:    the fetched scores gain a NaN/+Inf — caught by the
        session's output guard and treated exactly like a raised fault
        (silent numeric corruption must never reach a response);
      - poison:     a per-REQUEST fault, decided by a stable hash of the
        request id (or an explicit `poison_ids` list): every attempt on
        a batch containing that request raises `PoisonFault`. Retries
        cannot clear it — the session must bisect the chunk until the
        poison request is isolated and quarantined as status="error"
        while its chunk-mates serve normally.
  * every stochastic decision draws from ONE seeded generator (and the
    poison set is order-independent by construction), so a DES chaos run
    replays bit-identically for a given seed and call sequence;
  * `stats` counts every injected fault by class, and `enabled` gates
    the whole injector at runtime (tests flip it to watch the breaker
    close; a chaos soak flips it to verify recovery).

The filesystem fault injector of the checkpoint layer comes with the
checkpoint slice.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np


class InjectedFault(RuntimeError):
    """Base class for faults raised by the injector — the session's retry
    layer treats them exactly like real executor exceptions."""


class TransientFault(InjectedFault):
    """A one-shot executor fault: clears on retry (re-drawn per attempt)."""


class PoisonFault(InjectedFault):
    """A per-request fault: raised on EVERY attempt whose batch contains
    the poisoned request — only bisection can isolate it."""


class CorruptOutput(RuntimeError):
    """Raised by the session's output guard when fetched results carry
    NaN/+Inf scores or a non-finite latency estimate. Defined here (not
    raised by the injector itself — corruption is injected silently and
    must be *detected*) so guard and injector share one vocabulary."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-class injection rates, all default-off (a zero-rate injector
    is a no-op and keeps the serving path bit-identical)."""
    transient_rate: float = 0.0     # P(attempt raises TransientFault)
    latency_rate: float = 0.0       # P(attempt sleeps latency_spike_ms)
    latency_spike_ms: float = 10.0
    corrupt_rate: float = 0.0       # P(attempt's scores gain NaN/+Inf)
    poison_rate: float = 0.0        # P(a request id is poisoned) — stable
    #                                 per-id hash, independent of ordering
    poison_ids: tuple[int, ...] = ()  # explicitly poisoned request ids
    seed: int = 0


def _hash01(request_id: int, seed: int) -> float:
    """Stable per-id uniform in [0, 1): poison membership must not depend
    on arrival order, batch composition, or how many rng draws happened
    before — only on (id, seed)."""
    h = (request_id * 2654435761 + seed * 0x9E3779B9) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x45D9F3B) & 0xFFFFFFFF
    h ^= h >> 16
    return h / 2**32


class FaultInjector:
    """Seeded fault source wrapping the chunk-execute seam.

    The session calls `on_attempt(request_ids)` before running the jitted
    pipeline (may sleep, may raise) and `on_results(results, n_real)`
    after fetching (may corrupt scores in place). Thread-safe: the rng
    and stats are lock-guarded (the pump's service thread and a DES
    caller never interleave, but a restarted pump thread may overlap a
    dying one's last draw)."""

    def __init__(self, cfg: FaultConfig, *, sleep=time.sleep):
        self.cfg = cfg
        self.enabled = True
        self._sleep = sleep
        self._rng = np.random.default_rng(cfg.seed)
        self._lock = threading.Lock()
        self.stats = {"transient": 0, "latency": 0, "corrupt": 0,
                      "poison": 0}

    def is_poisoned(self, request_id: int) -> bool:
        cfg = self.cfg
        if request_id in cfg.poison_ids:
            return True
        return (cfg.poison_rate > 0.0
                and _hash01(request_id, cfg.seed) < cfg.poison_rate)

    def snapshot(self) -> dict:
        """Consistent point-in-time copy of the per-class fault counts,
        taken under the injector lock (a live pump thread may be mid-draw
        while a reporter reads)."""
        with self._lock:
            return dict(self.stats)

    def on_attempt(self, request_ids: list[int]) -> None:
        """Pre-execute hook: poison check (deterministic, rng-free) first,
        then latency spike, then transient fault — each an independent
        seeded draw per attempt."""
        if not self.enabled:
            return
        cfg = self.cfg
        for rid in request_ids:
            if self.is_poisoned(rid):
                with self._lock:
                    self.stats["poison"] += 1
                raise PoisonFault(
                    f"poisoned request {rid} in batch (injected)")
        with self._lock:
            spike = (cfg.latency_rate > 0.0
                     and self._rng.random() < cfg.latency_rate)
            if spike:
                self.stats["latency"] += 1
            fail = (cfg.transient_rate > 0.0
                    and self._rng.random() < cfg.transient_rate)
            if fail:
                self.stats["transient"] += 1
        if spike:
            self._sleep(cfg.latency_spike_ms / 1e3)
        if fail:
            raise TransientFault("transient executor fault (injected)")

    def on_results(self, results: dict, n_real: int) -> None:
        """Post-fetch hook: with probability corrupt_rate, plant a NaN or
        +Inf in one real row's scores — the session's guard must catch it
        before any response is built."""
        if not self.enabled or self.cfg.corrupt_rate <= 0.0 or n_real == 0:
            return
        with self._lock:
            if self._rng.random() >= self.cfg.corrupt_rate:
                return
            self.stats["corrupt"] += 1
            row = int(self._rng.integers(n_real))
            col = int(self._rng.integers(results["scores"].shape[1]))
            bad = np.nan if self._rng.random() < 0.5 else np.inf
        results["scores"][row, col] = bad
