"""Streaming CascadeSession serving engine — the request lifecycle API.

The paper's system is *operational*: hundreds of millions of queries/day
under joint accuracy / latency / result-size / CPU constraints, with
graceful degradation instead of failure at peak load (Fig 5: Singles' Day
traffic triples). That behavior lives in the request lifecycle, which this
module makes the API:

  session.submit(req, deadline_ms=...) -> RankFuture   (bounded admission)
  session.step(now_ms)                 -> [RankResponse]  (the pump)
  session.flush(now_ms)                -> [RankResponse]  (drain on demand)

* Admission control: the queue is bounded (ServingConfig.max_queue). At
  capacity the session LOAD-SHEDS — the future resolves immediately with
  status="shed" (or raises QueueFull with admission="raise") instead of
  queueing unboundedly. Every future always resolves with an explicit
  status; nothing is silently dropped.
* Flush policy: a bucket flushes when it can fill a batch, when its oldest
  request's wait exceeds FlushPolicy.max_wait_ms, when a request's
  deadline (minus deadline_slack_ms) falls due, or on demand (flush()).
  step() flushes the single most-urgent due chunk so a caller can
  interleave time accounting with service.
* Degraded modes: under queue-depth pressure (DegradePolicy watermark
  hysteresis: enter at high_watermark, exit at low_watermark) the session
  trades result quality for CPU along the paper's multi-factor axes —
  skip the neural final stage, tighten m_q (fewer expected survivors ->
  less downstream cost), fall back to a smaller shape bucket. Every
  degradation applied to a request is recorded on its response.

The compute core is core.pipeline.run_cascade through the plan registry
plus the optional neural final stage (serving.cascade_server.NeuralScorer)
and the Eq-16 latency estimate, run on the session's device (by default
the CUDA card, where plans "filter" and "score" launch the hand-written
kernels). Each packed numpy batch is copied to the device (from
page-locked staging on a CUDA device, without blocking the host), and the
results come back to numpy before any response is built. A session given
`stream=` enqueues those copies and its kernels on that CUDA stream, so
replicas of one card (serving.router) run side by side; the
CascadeServer shim (serving.cascade_server), the wall-clock SessionPump
(serving.pump) and the ReplicaRouter (serving.router) drive it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time

import numpy as np
import torch

from repro_torch.core import cascade as C
from repro_torch.core import losses as L
from repro_torch.core import pipeline as P
from repro_torch.serving.batching import (PinnedBatch, RankRequest,
                                          RankResponse, TransferBufferPool,
                                          bucket_of, pack_into,
                                          padded_batch_rows,
                                          warmup_batch_sizes)
from repro_torch.serving.faults import CorruptOutput, FaultInjector


class QueueFull(RuntimeError):
    """submit() refused: the bounded queue is at capacity and the session
    was configured with admission='raise' instead of load-shedding."""


STATUS_OK = "ok"
STATUS_SHED = "shed"
STATUS_ERROR = "error"

DEGRADE_SKIP_NEURAL = "skip_neural"
DEGRADE_TIGHTEN_MQ = "tighten_m_q"
DEGRADE_SHRINK_BUCKET = "shrink_bucket"


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """When does a bucket's pending chunk go to the accelerator?"""
    max_wait_ms: float = 5.0        # oldest request's queue-wait ceiling
    deadline_slack_ms: float = 2.0  # flush this early relative to deadlines
    flush_full: bool = True         # flush the moment a full batch is ready


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Queue-depth hysteresis for graceful degradation (paper Fig 5).

    high_watermark=None disables degradation entirely. Otherwise the
    session enters degraded mode when the pending depth (at admission or
    at a pump step) reaches high_watermark and leaves it only once the
    depth falls back to low_watermark — the gap is the hysteresis band
    that stops the mode from flapping at the boundary."""
    high_watermark: int | None = None
    low_watermark: int = 0
    skip_neural: bool = True        # drop the expensive neural final stage
    mq_scale: float = 0.5           # tighten m_q -> fewer expected survivors
    shrink_bucket: bool = True      # serve large requests in a smaller bucket


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Fault handling around the chunk-execute seam.

    An execute attempt that raises (executor exception, injected fault)
    or returns corrupt scores (NaN/+Inf — caught by the output guard) is
    retried up to max_attempts with capped exponential backoff. A chunk
    that exhausts its retries is BISECTED: each half retries solo, so one
    poisoned request is isolated and quarantined as status="error" while
    its chunk-mates serve normally (bisection shapes are the warmed pow2
    ladder — no new shapes).

    The circuit breaker counts CONSECUTIVE failed attempts session-wide
    (any success resets it) and feeds the existing degradation ladder
    before tripping open: at breaker_degrade_after the session behaves as
    if the queue-depth watermark fired (skip_neural / tighten_m_q /
    shrink_bucket); at breaker_open_after new submissions are shed while
    earlier work is still pending — once the queue drains, one probe
    request is admitted so a recovered executor can close the breaker.
    None disables that stage of the breaker."""
    max_attempts: int = 3
    backoff_ms: float = 1.0         # first retry's sleep
    backoff_factor: float = 2.0
    max_backoff_ms: float = 50.0
    breaker_degrade_after: int | None = 8
    breaker_open_after: int | None = 32


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """ONE configuration surface for the serving engine (replaces the
    accreted per-call kwargs: use_fused_kernel/fused/batcher/neural_cost).

    plan names a core.pipeline.PLANS entry; the batcher geometry mirrors
    RequestBatcher's defaults; max_queue=None keeps the legacy unbounded
    queue (the CascadeServer shim's compatibility mode)."""
    plan: str = "filter"
    group_buckets: tuple[int, ...] = (16, 64, 256)
    batch_groups: int = 32
    max_queue: int | None = None
    admission: str = "shed"             # "shed" | "raise"
    flush: FlushPolicy = FlushPolicy()
    degrade: DegradePolicy = DegradePolicy()
    retry: RetryPolicy = RetryPolicy()
    default_deadline_ms: float | None = None  # relative budget for submit()
    neural_cost: float = 0.84           # Table-1 cost of the neural stage


class RankFuture:
    """Handle for a submitted request. Resolves exactly once — shed at
    admission, served by a later step()/flush()/pump cycle, or shed at
    pump shutdown.

    Two consumption styles, matching the two clocks:
      * explicitly-clocked callers (the DES, tests) poll done() and call
        result() with no timeout — still-pending raises immediately, the
        original poll semantics;
      * wall-clock callers (threads submitting through a SessionPump)
        block on wait(timeout)/result(timeout=...) — a threading.Event
        per future, set exactly once at resolution."""

    __slots__ = ("request_id", "bucket", "_response", "_event")

    def __init__(self, request_id: int):
        self.request_id = request_id
        self.bucket: int | None = None   # shape bucket queued under (None: shed)
        self._response: RankResponse | None = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._response is not None

    def wait(self, timeout: float | None = None) -> bool:
        """Block until resolved (or timeout seconds); True when done."""
        self._event.wait(timeout)
        return self.done()

    def result(self, timeout: float | None = None) -> RankResponse:
        """The response. With no timeout, a still-pending future raises
        RuntimeError immediately (poll semantics — the DES's contract);
        with a timeout, blocks up to that many seconds and raises
        TimeoutError if the future is still unresolved."""
        if self._response is None and timeout is not None:
            if not self.wait(timeout):
                raise TimeoutError(
                    f"request {self.request_id} unresolved after "
                    f"{timeout:g}s — is the pump running?")
        if self._response is None:
            raise RuntimeError(
                f"request {self.request_id} is still pending — pump the "
                "session with step()/flush() before asking for the result")
        return self._response

    def _resolve(self, resp: RankResponse) -> None:
        assert self._response is None, \
            f"request {self.request_id} resolved twice"
        self._response = resp
        self._event.set()


@dataclasses.dataclass
class _Pending:
    req: RankRequest
    future: RankFuture
    submit_ms: float
    deadline_ms: float | None
    degraded: tuple[str, ...]   # admission-time degradations (bucket shrink)
    truncated: bool


@dataclasses.dataclass
class FlushChunk:
    """A claimed unit of service: entries dequeued from one bucket's
    pending queue plus the degradation decision taken at claim time.

    The claim → pack → execute → resolve seam exists so callers that know
    completion time can account at it: the pump claims under the session
    lock, packs/executes outside it (submitters keep running), and
    resolves with the real wall completion time; the DES passes its
    virtual completion time through. `capacity` is the pow2-padded batch
    rows the packed buffer will carry — while `open` is True the pump may
    slot late arrivals into rows [len(entries), capacity): padding rows
    the batch pays for anyway."""
    g: int
    entries: list[_Pending]
    degrades: tuple[str, ...]       # flush-time degradations (chunk-wide)
    skip_neural: bool
    mq_scale: float
    capacity: int                   # padded batch rows (pow2 rule)
    packed: int = 0                 # rows already staged into the buffer
    open: bool = False              # pump: accepting slot late-joins
    batch: dict | None = None       # pooled staging buffer once packed
    mq_applied: bool = False        # mq_scale already folded into the
    # staged m_q column (must happen exactly once across retry attempts)


def _shed_response(req: RankRequest) -> RankResponse:
    return RankResponse(
        request_id=req.request_id,
        order=np.empty(0, np.int64),
        scores=np.empty(0, np.float32),
        survivors=np.empty(0, bool),
        est_latency_ms=0.0,
        stage_counts=[],
        status=STATUS_SHED,
    )


def _error_response(req: RankRequest, error: str, attempts: int,
                    **lifecycle) -> RankResponse:
    return RankResponse(
        request_id=req.request_id,
        order=np.empty(0, np.int64),
        scores=np.empty(0, np.float32),
        survivors=np.empty(0, bool),
        est_latency_ms=0.0,
        stage_counts=[],
        status=STATUS_ERROR,
        error=error,
        attempts=attempts,
        **lifecycle,
    )


class CascadeSession:
    def __init__(self, params: C.Params, cfg: C.CascadeConfig,
                 lcfg: L.LossConfig | None = None, *,
                 neural_stage=None,
                 scfg: ServingConfig | None = None,
                 faults: FaultInjector | None = None,
                 name: str = "session",
                 device="cuda",
                 stream: torch.cuda.Stream | None = None,
                 pipeline_from: "CascadeSession | None" = None):
        # Every input and the whole pipeline live on `device`; asking for
        # "cuda" without a card raises here instead of serving elsewhere.
        self.device = torch.device(device)
        if neural_stage is not None and neural_stage.device.type \
                != self.device.type:
            raise ValueError(
                f"the neural stage's weights are on {neural_stage.device}, "
                f"the session serves on {self.device}")
        # The CUDA stream this session's copies and kernels go on (a
        # replica's own stream of a shared card); None keeps the calling
        # thread's current stream.
        if stream is not None and self.device.type != "cuda":
            raise ValueError(f"a CUDA stream was given to a session on "
                             f"{self.device}")
        self.stream = stream
        self.params = {k: torch.as_tensor(v, dtype=torch.float32)
                       .to(self.device).contiguous()
                       for k, v in params.items()}
        self.cfg = cfg
        self.lcfg = lcfg or L.LossConfig()
        self.neural = neural_stage
        self.scfg = scfg or ServingConfig()
        # Replica identity (the stats seam a router reads).
        self.name = name
        # Optional chaos hook: a seeded FaultInjector wrapping the execute
        # seam (faults=None keeps the serving path bit-identical).
        self.faults = faults
        # Resolve the plan at construction — unknown plans must fail here,
        # with the registry's one shared error, not from the first batch.
        P.resolve_plan(self.scfg.plan)
        self.buckets = tuple(sorted(self.scfg.group_buckets))
        # The pipeline is a plain function: nothing compiles per shape.
        # What the reference's jit cache counted is kept as the set of
        # (skip_neural, b, g) shapes the pipeline has run, so "no new
        # shapes after warmup" keeps its meaning (launch.serve).
        if pipeline_from is not None:
            # Co-located replicas share ONE pipeline and its shape record:
            # same plan, neural stage and device -> the same compute, and
            # the fleet's "no new shapes after warmup" is one count.
            if (pipeline_from.scfg.plan != self.scfg.plan
                    or pipeline_from.neural is not self.neural
                    or pipeline_from.device != self.device):
                raise ValueError(
                    "pipeline_from requires the same plan, neural stage "
                    "and device as the donor session")
            self.shapes_seen = pipeline_from.shapes_seen
            self._rank = pipeline_from._rank
            self._rank_noneural = pipeline_from._rank_noneural
        else:
            self.shapes_seen: set[tuple[bool, int, int]] = set()
            self._rank = self._make_rank(with_neural=True)
            # The degraded pipeline drops the neural stage; it only exists
            # as a distinct pipeline when there is a neural stage to skip.
            if self.neural is not None and self.scfg.degrade.skip_neural:
                self._rank_noneural = self._make_rank(with_neural=False)
            else:
                self._rank_noneural = self._rank
        self._pending: dict[int, list[_Pending]] = {g: [] for g in self.buckets}
        self._degraded_active = False
        # ONE lock around admission + the pending queues + resolution. The
        # explicitly-clocked DES path is single-threaded (the lock is then
        # uncontended); the pump shares this lock with its submitters.
        # RLock: the pump composes claim/resolve under the same lock the
        # session's own methods take.
        self.lock = threading.RLock()
        # Staging buffers for request packing: per-(B, G) reuse so the
        # flush hot path stops allocating (see TransferBufferPool);
        # page-locked when the session copies them to a CUDA device.
        self.pool = TransferBufferPool(cfg.d_x, cfg.d_q,
                                       pin=self.device.type == "cuda")
        # "refused" counts admission="raise" rejections (QueueFull, no
        # future) — distinct from "shed" (resolved future with
        # status="shed"); "submitted" counts only requests that got a
        # future.
        # Accounting identity: submitted = completed + shed + errors once
        # all work is resolved (refused requests never got a future).
        # "inflight" counts entries claimed into a chunk but not yet
        # resolved: claim_bucket moves them out of pending and into
        # inflight under ONE lock hold, resolve/fail move them out, so a
        # stats_export snapshot always satisfies
        #   submitted = completed + shed + errors + pending + inflight
        # — the atomic-snapshot identity a live reporter can assert. It is
        # also the router's in-flight load signal for replica placement.
        self.stats = {"submitted": 0, "shed": 0, "refused": 0,
                      "completed": 0, "degraded": 0, "deadline_missed": 0,
                      "truncated": 0, "degrade_enters": 0,
                      "degrade_exits": 0, "faults": 0, "retries": 0,
                      "errors": 0, "quarantined": 0, "breaker_shed": 0,
                      "inflight": 0, "drained": 0, "adopted": 0}
        # Global-depth hook (the replica router): when set, bounded
        # admission and the degradation watermarks judge THIS callable's
        # depth instead of the local queue — one admission controller over
        # N replicas. Must be safe to call without the session lock.
        self.depth_fn = None
        # Consecutive failed execute attempts, session-wide — the circuit
        # breaker's input; any successful attempt resets it.
        self._consec_faults = 0
        # Backoff sleep, stubable in tests (and measured into virtual
        # service time by the DES, which times real wall around execute).
        self._sleep = time.sleep

    # -- the pipeline ---------------------------------------------------------

    def _make_rank(self, with_neural: bool):
        neural = self.neural if with_neural else None

        def impl(params: C.Params, x: torch.Tensor, q: torch.Tensor,
                 mask: torch.Tensor, m_q: torch.Tensor) -> dict:
            """Score -> hard filter -> latency estimate, end to end."""
            out = P.run_cascade(params, self.cfg, x, q, mask, m_q,
                                fused=self.scfg.plan)
            surv = out["survivors"][..., -1]
            final_scores = torch.where(surv > 0, out["scores"], -torch.inf)

            if neural is not None:
                # the expensive stage scores every row of the padded batch
                # (flattened); only the survivors keep its score
                b, g, _ = x.shape
                nscore = neural.score(x.reshape(b * g, -1)).reshape(b, g)
                final_scores = torch.where(
                    surv > 0, final_scores + nscore.float(), -torch.inf)

            # Eq-16 latency from the pipeline's own expected counts — no
            # re-scoring of the batch.
            lat = P.latency_from_counts(out["expected_counts"], m_q, self.cfg,
                                        self.lcfg.latency_scale,
                                        self.lcfg.latency_convention)
            if neural is not None:
                lat = lat + (self.lcfg.latency_scale * self.scfg.neural_cost
                             * surv.sum(-1) / torch.clamp(mask.sum(-1), min=1)
                             * torch.clamp(m_q, max=6000.0))
            return {
                "scores": final_scores,
                "survivors": surv,
                "stage_survivors": out["survivors"],
                "est_latency_ms": lat,
            }

        return impl

    def _on_stream(self):
        """The context that puts this session's device work on its own
        stream (`stream=`): entered by rank_batch and fetch themselves, so
        every caller (pump thread, DES, router probe) gets the same
        placement. Without a stream, the caller's current stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def rank_batch(self, batch: dict, *, skip_neural: bool = False) -> dict:
        """Run the hard-cascade pipeline on a padded numpy batch, copied to
        the session's device. Returns device tensors, to be read with
        `fetch` (on this session's stream). A pooled page-locked batch
        (`PinnedBatch`) is copied without blocking the host, and its
        `copied` event is recorded after the copies, so that the pool
        hands the buffer out again only once they are done."""
        b, g = batch["mask"].shape
        self.shapes_seen.add((skip_neural, b, g))
        keys = ("x", "q", "mask", "m_q")
        rank = self._rank_noneural if skip_neural else self._rank
        with self._on_stream():
            if isinstance(batch, PinnedBatch):
                x, q, mask, m_q = (batch.pinned[k].to(self.device,
                                                      non_blocking=True)
                                   for k in keys)
                batch.copied.record()
            else:
                x, q, mask, m_q = (torch.as_tensor(batch[k],
                                                   dtype=torch.float32)
                                   .to(self.device) for k in keys)
            return rank(self.params, x, q, mask, m_q)

    def fetch(self, res: dict) -> dict:
        """rank_batch's device results as host numpy arrays: the copies
        that wait for the device, on this session's stream (the one the
        results were computed on). Warmup runs them too, so that serving
        meets no device code for the first time."""
        with self._on_stream():
            return {
                "scores": res["scores"].cpu().numpy(),
                "survivors": res["survivors"].cpu().numpy(),
                "lat": res["est_latency_ms"].cpu().numpy(),
                "stage_counts": res["stage_survivors"].sum(dim=1)
                .cpu().numpy(),
            }

    def warmup_manifest(self) -> dict:
        """The shape surface of this session as a JSON-serializable
        record, in the reference's format: everything that determines
        WHICH pipelines exist and WHAT shapes they run. `warm_restart`
        replays it so the first live request meets no new shape (and no
        kernel build). Versioned so a reader can refuse a future format
        instead of misreading it."""
        return {
            "version": 1,
            "plan": self.scfg.plan,
            "group_buckets": list(self.buckets),
            "batch_groups": self.scfg.batch_groups,
            "d_x": self.cfg.d_x,
            "d_q": self.cfg.d_q,
            "n_stages": self.cfg.n_stages,
            # distinct skip-neural pipeline to re-warm?
            "degraded_pipeline": self._rank_noneural is not self._rank,
            "dtype": "float32",      # the pipeline's input/compute dtype
            "shapes": [[b, g] for g in self.buckets
                       for b in warmup_batch_sizes(self.scfg.batch_groups)],
        }

    def warm_restart(self, manifest: dict) -> list[tuple[int, int]]:
        """Replay a warmup manifest through the pipeline(s): every
        recorded (b, g) shape runs once for the normal and (when the
        manifest says one existed) the degraded skip-neural pipeline, its
        results fetched as in serving; on a CUDA device the first run
        builds and loads the kernel library. A manifest written by a
        session with a different shape surface (plan, dims, geometry) is
        rejected — warming the wrong shapes would silently bring
        first-request work back."""
        if manifest.get("version", 0) != 1:
            raise ValueError(
                f"unsupported warmup manifest version: {manifest.get('version')!r}")
        want = {
            "plan": self.scfg.plan, "group_buckets": list(self.buckets),
            "batch_groups": self.scfg.batch_groups, "d_x": self.cfg.d_x,
            "d_q": self.cfg.d_q, "n_stages": self.cfg.n_stages,
            "dtype": "float32",
        }
        got = {k: manifest.get(k) for k in want}
        if got != want:
            raise ValueError(
                "warmup manifest does not match this session's shape "
                f"surface: manifest {got} != session {want}")
        warm_degraded = (bool(manifest.get("degraded_pipeline"))
                         and self._rank_noneural is not self._rank)
        shapes = []
        for b, g in manifest["shapes"]:
            batch = {
                "x": np.zeros((b, g, self.cfg.d_x), np.float32),
                "q": np.zeros((b, self.cfg.d_q), np.float32),
                "mask": np.ones((b, g), np.float32),
                "m_q": np.full((b,), float(g), np.float32),
            }
            self.fetch(self.rank_batch(batch))
            if warm_degraded:
                self.fetch(self.rank_batch(batch, skip_neural=True))
            shapes.append((b, g))
        return shapes

    def warmup(self) -> list[tuple[int, int]]:
        """Run the pipeline once for every serving shape — each (b, g)
        with b a power of two up to batch_groups (the exact shapes a chunk
        can pack into) per bucket, for the normal AND (when distinct) the
        degraded skip-neural pipeline. After warmup, live traffic — including
        degraded flushes — meets no new shape.
        Implemented as a warm restart from this session's own manifest:
        cold start and warm restart are ONE code path, so the manifest can
        never drift from what warmup actually runs."""
        return self.warm_restart(self.warmup_manifest())

    # -- request lifecycle -------------------------------------------------

    @staticmethod
    def _now(now_ms: float | None) -> float:
        return time.monotonic() * 1e3 if now_ms is None else float(now_ms)

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def queue_depth(self) -> int:
        """Local pending depth WITHOUT taking the session lock: list len()
        is GIL-atomic, so this is a safe (if instantaneously approximate)
        read. The router's global depth_fn aggregates this across replicas
        from inside a replica's submit path, where taking a SECOND session
        lock could deadlock two concurrent submitters (A holds lock_A and
        wants lock_B while B holds lock_B and wants lock_A)."""
        return sum(len(v) for v in self._pending.values())

    def _depth(self) -> int:
        """Effective depth for admission and the degradation watermarks:
        the router's GLOBAL depth when the hook is set (one admission
        controller over N replicas), else the local queue."""
        return self.pending if self.depth_fn is None else int(self.depth_fn())

    @property
    def degraded(self) -> bool:
        return self._degraded_active or self._breaker_degraded()

    def _breaker_degraded(self) -> bool:
        """Consecutive-fault count has reached the degrade stage of the
        circuit breaker: behave exactly as if the queue-depth watermark
        fired (a faulting executor sheds expensive work first)."""
        k = self.scfg.retry.breaker_degrade_after
        return k is not None and self._consec_faults >= k

    def _breaker_open(self) -> bool:
        k = self.scfg.retry.breaker_open_after
        return k is not None and self._consec_faults >= k

    def _update_degrade(self) -> None:
        hw = self.scfg.degrade.high_watermark
        if hw is None:
            return
        depth = self._depth()
        if not self._degraded_active and depth >= hw:
            self._degraded_active = True
            self.stats["degrade_enters"] += 1
        elif self._degraded_active and depth <= self.scfg.degrade.low_watermark:
            self._degraded_active = False
            self.stats["degrade_exits"] += 1

    def _bucket(self, n_items: int) -> int:
        return bucket_of(n_items, self.buckets)

    def submit(self, req: RankRequest, *, deadline_ms: float | None = None,
               now_ms: float | None = None) -> RankFuture:
        """Admit one request. deadline_ms is ABSOLUTE (same clock as
        step()'s now_ms); ServingConfig.default_deadline_ms, if set, is a
        RELATIVE budget applied when no explicit deadline is given.

        At capacity the request is shed: the returned future is already
        resolved with status="shed" (admission="raise" raises QueueFull
        instead, counted under stats["refused"] — no future, no "shed" or
        "submitted" increment). Nothing ever queues past max_queue."""
        with self.lock:
            now = self._now(now_ms)
            # Breaker open: the executor has failed breaker_open_after
            # consecutive attempts — shed new work instead of queueing it
            # behind a broken service. Once the backlog drains, admit one
            # probe so a recovered executor can close the breaker.
            if self._breaker_open() and self.pending > 0:
                fut = RankFuture(req.request_id)
                self.stats["submitted"] += 1
                self.stats["shed"] += 1
                self.stats["breaker_shed"] += 1
                fut._resolve(_shed_response(req))
                return fut
            mq = self.scfg.max_queue
            if mq is not None and self._depth() >= mq:
                if self.scfg.admission == "raise":
                    # Refused-by-raise is NOT a shed-with-future: the
                    # caller gets an exception instead of a future, so it
                    # gets its own stat and leaves submitted/shed alone.
                    self.stats["refused"] += 1
                    raise QueueFull(
                        f"queue at capacity ({mq}); request "
                        f"{req.request_id} refused")
                fut = RankFuture(req.request_id)
                self.stats["submitted"] += 1
                self.stats["shed"] += 1
                fut._resolve(_shed_response(req))
                return fut
            fut = RankFuture(req.request_id)
            self.stats["submitted"] += 1
            if (deadline_ms is None
                    and self.scfg.default_deadline_ms is not None):
                deadline_ms = now + self.scfg.default_deadline_ms
            # Depth-pressure check BEFORE bucketing: a request admitted
            # while degraded may be demoted to a smaller shape bucket.
            self._update_degrade()
            degraded: tuple[str, ...] = ()
            n = len(req.item_feats)
            g = self._bucket(n)
            if (self.degraded and self.scfg.degrade.shrink_bucket
                    and g > self.buckets[0]):
                g = self.buckets[self.buckets.index(g) - 1]
                degraded += (DEGRADE_SHRINK_BUCKET,)
            # truncated means the request exceeded the LARGEST bucket —
            # items genuinely beyond serving capacity. Items dropped by a
            # shrink_bucket demotion are a degradation, carried by
            # degraded=("shrink_bucket",), not conflated into truncated.
            fut.bucket = g
            self._pending[g].append(_Pending(
                req=req, future=fut, submit_ms=now,
                deadline_ms=deadline_ms, degraded=degraded,
                truncated=n > self.buckets[-1]))
            return fut

    def _due_ms(self, entries: list[_Pending]) -> float:
        """Earliest moment this bucket must flush: oldest wait ceiling or
        tightest deadline (minus slack); -inf when a full batch is ready
        and the policy flushes full buckets eagerly."""
        pol = self.scfg.flush
        if pol.flush_full and len(entries) >= self.scfg.batch_groups:
            return -math.inf
        due = math.inf
        for e in entries:
            due = min(due, e.submit_ms + pol.max_wait_ms)
            if e.deadline_ms is not None:
                due = min(due, e.deadline_ms - pol.deadline_slack_ms)
        return due

    def next_due_ms(self) -> float | None:
        """Earliest due time over all pending buckets (None when idle) —
        open-loop load generators use this to fast-forward virtual time instead of
        busy-polling step()."""
        with self.lock:
            dues = [self._due_ms(v) for v in self._pending.values() if v]
            return min(dues) if dues else None

    def step(self, now_ms: float | None = None) -> list[RankResponse]:
        """The pump: flush the single most-urgent due chunk, if any.

        Returns that chunk's responses ([] when nothing is due yet). One
        chunk per call, most-urgent first (earliest due time; ties go to
        the smaller bucket), so deadline pressure — not arrival order —
        decides flush ordering, and a caller can account service time
        between chunks.

        On the explicit clock the whole flush "occurs at now_ms":
        completion-time accounting (deadline_missed after real service
        time) needs a caller that knows when service finished — the
        SessionPump reads its wall clock, the DES loadgen passes its
        virtual completion time — both through the claim_due /
        execute_chunk / resolve_chunk seam below."""
        now = self._now(now_ms)
        chunk = self.claim_due(now)
        if chunk is None:
            return []
        return self.resolve_chunk(chunk, self.execute_chunk(chunk), now)

    def flush(self, now_ms: float | None = None) -> list[RankResponse]:
        """Drain EVERYTHING on demand, ignoring due times: buckets in
        ascending size order, FIFO chunks within a bucket — exactly the
        order CascadeServer.serve() always used, so a submit-all-then-
        flush session reproduces serve() bit for bit."""
        now = self._now(now_ms)
        out: list[RankResponse] = []
        for g in self.buckets:
            while self._pending[g]:
                chunk = self.claim_bucket(g)
                out.extend(self.resolve_chunk(
                    chunk, self.execute_chunk(chunk), now))
        return out

    # -- the claim / pack / execute / resolve seam -------------------------
    #
    # step()/flush() compose these four on the caller's single clock
    # instant. Drivers that track completion time use them directly:
    # the pump claims under the lock, packs+executes outside it (so
    # submitters keep running, and late arrivals can slot-join an open
    # chunk), then resolves at the measured wall completion; the DES
    # loadgen executes between two virtual instants and passes the
    # virtual completion time into resolve_chunk.

    def claim_due(self, now_ms: float) -> FlushChunk | None:
        """Dequeue the single most-urgent due chunk (None when nothing is
        due): earliest due time wins, ties go to the smaller bucket."""
        with self.lock:
            self._update_degrade()
            best_g, best_due = None, math.inf
            for g in self.buckets:
                entries = self._pending[g]
                if not entries:
                    continue
                due = self._due_ms(entries)
                if due <= now_ms and due < best_due:
                    best_g, best_due = g, due
            if best_g is None:
                return None
            return self.claim_bucket(best_g)

    def claim_bucket(self, g: int) -> FlushChunk | None:
        """Dequeue one FIFO chunk from bucket g with the degradation
        decision frozen at claim time (the moment service is committed)."""
        with self.lock:
            self._update_degrade()
            entries = self._pending[g][:self.scfg.batch_groups]
            if not entries:
                return None
            del self._pending[g][:len(entries)]
            # pending -> inflight under ONE lock hold: the atomic-snapshot
            # identity (see stats init) must hold at every instant
            self.stats["inflight"] += len(entries)
            degrades: tuple[str, ...] = ()
            skip_neural = False
            mq_scale = 1.0
            if self.degraded:
                deg = self.scfg.degrade
                if deg.skip_neural and self.neural is not None:
                    skip_neural = True
                    degrades += (DEGRADE_SKIP_NEURAL,)
                if deg.mq_scale < 1.0:
                    mq_scale = deg.mq_scale
                    degrades += (DEGRADE_TIGHTEN_MQ,)
            return FlushChunk(
                g=g, entries=entries, degrades=degrades,
                skip_neural=skip_neural, mq_scale=mq_scale,
                capacity=padded_batch_rows(len(entries),
                                           self.scfg.batch_groups))

    def pack_chunk(self, chunk: FlushChunk) -> None:
        """Stage any not-yet-packed entries into the chunk's pooled
        buffer. Incremental: the pump calls it once after claiming, and
        again after closing the chunk to stage slot late-joiners into the
        padding rows the batch already pays for."""
        if chunk.batch is None:
            chunk.batch = self.pool.acquire(chunk.capacity, chunk.g)
        n = len(chunk.entries)
        if chunk.packed < n:
            pack_into(chunk.batch,
                      [e.req for e in chunk.entries[chunk.packed:n]],
                      chunk.g, start=chunk.packed)
            chunk.packed = n

    def execute_chunk(self, chunk: FlushChunk) -> dict:
        """Fault-tolerant execute: pack (if needed), run the
        pipeline with retry/backoff around every attempt, guard the
        fetched outputs against NaN/+Inf corruption, and bisect a chunk
        whose retries exhaust so one poisoned request is quarantined as
        status="error" while its chunk-mates serve. The slow part —
        callers that care about concurrency run this OUTSIDE the session
        lock.

        Always returns per-entry results (rows [0, len(entries))) with
        parallel "error"/"attempts" lists — it NEVER raises for an
        executor failure; resolve_chunk turns error entries into explicit
        status="error" responses so no future can hang on a fault."""
        return self._execute_with_retry(chunk)

    def _execute_attempt(self, chunk: FlushChunk) -> dict:
        """ONE raw attempt: stage rows, run the pipeline, fetch to host.
        The staging buffer is kept on the chunk across attempts (rows are
        already packed; m_q scaling applies exactly once) and released by
        the retry wrapper, never here."""
        chunk.open = False
        self.pack_chunk(chunk)
        batch = chunk.batch
        if chunk.mq_scale < 1.0 and not chunk.mq_applied:
            np.maximum(batch["m_q"] * chunk.mq_scale, 1.0,
                       out=batch["m_q"])
            chunk.mq_applied = True
        if self.faults is not None:
            self.faults.on_attempt([e.req.request_id
                                    for e in chunk.entries])
        # fetched arrays are writable: the injector corrupts them in place
        out = self.fetch(self.rank_batch(batch, skip_neural=chunk.skip_neural))
        if self.faults is not None:
            self.faults.on_results(out, len(chunk.entries))
        return out

    def _guard_results(self, out: dict, n_real: int) -> None:
        """Corrupt-output guard: scores may legitimately be finite or
        -inf (filtered items) — a NaN or +Inf score, or a non-finite
        latency estimate, is silent numeric corruption and is treated
        exactly like a raised executor fault (retried, then bisected)."""
        s = out["scores"][:n_real]
        if (np.isnan(s).any() or np.isposinf(s).any()
                or not np.isfinite(out["lat"][:n_real]).all()):
            raise CorruptOutput(
                "non-finite scores/latency in fetched results")

    def _release_chunk(self, chunk: FlushChunk) -> None:
        if chunk.batch is not None:
            # results fetched (or the chunk abandoned) -> nothing still
            # reads the staging buffer
            self.pool.release(chunk.batch)
            chunk.batch = None

    def _subchunk(self, chunk: FlushChunk, entries: list[_Pending]
                  ) -> FlushChunk:
        """A bisection half: same bucket and degradation decision, its
        own pow2-padded capacity (a warmed shape) and fresh buffer."""
        return FlushChunk(
            g=chunk.g, entries=list(entries), degrades=chunk.degrades,
            skip_neural=chunk.skip_neural, mq_scale=chunk.mq_scale,
            capacity=padded_batch_rows(len(entries),
                                       self.scfg.batch_groups))

    def _execute_with_retry(self, chunk: FlushChunk) -> dict:
        pol = self.scfg.retry
        n = len(chunk.entries)
        max_attempts = max(1, pol.max_attempts)
        backoff = pol.backoff_ms
        last_err: Exception | None = None
        for attempt in range(1, max_attempts + 1):
            try:
                out = self._execute_attempt(chunk)
                self._guard_results(out, n)
            except Exception as e:           # noqa: BLE001 — the whole
                # point: ANY executor failure becomes an explicit outcome
                last_err = e
                with self.lock:
                    self.stats["faults"] += 1
                    self._consec_faults += 1
                if attempt < max_attempts:
                    with self.lock:
                        self.stats["retries"] += 1
                    self._sleep(min(backoff, pol.max_backoff_ms) / 1e3)
                    backoff *= pol.backoff_factor
                continue
            with self.lock:
                self._consec_faults = 0      # any success closes the breaker
            self._release_chunk(chunk)
            out = {k: v[:n] for k, v in out.items()}
            out["error"] = [None] * n
            out["attempts"] = [attempt] * n
            return out
        # Retries exhausted on this chunk.
        self._release_chunk(chunk)
        err = f"{type(last_err).__name__}: {last_err}"
        if n == 1:
            # Quarantine: bisection has isolated the fault to this single
            # request (or the chunk was solo to begin with) — resolve it
            # as an explicit error and let everything else keep serving.
            with self.lock:
                self.stats["quarantined"] += 1
            return {
                "scores": np.full((1, chunk.g), -np.inf, np.float32),
                "survivors": np.zeros((1, chunk.g), np.float32),
                "lat": np.zeros((1,), np.float32),
                "stage_counts": np.zeros((1, self.cfg.n_stages),
                                         np.float32),
                "error": [err],
                "attempts": [max_attempts],
            }
        # Bisect: each half retries solo, so one poison request cannot
        # take its chunk-mates down with it. Halves pack into the warmed
        # pow2 shape ladder — no new shapes under quarantine.
        mid = n // 2
        out_l = self._execute_with_retry(
            self._subchunk(chunk, chunk.entries[:mid]))
        out_r = self._execute_with_retry(
            self._subchunk(chunk, chunk.entries[mid:]))
        merged = {k: np.concatenate([out_l[k], out_r[k]])
                  for k in ("scores", "survivors", "lat", "stage_counts")}
        merged["error"] = out_l["error"] + out_r["error"]
        merged["attempts"] = out_l["attempts"] + out_r["attempts"]
        return merged

    def resolve_chunk(self, chunk: FlushChunk, results: dict,
                      now_ms: float, done_ms: float | None = None
                      ) -> list[RankResponse]:
        """Build responses and resolve the chunk's futures. now_ms is the
        flush start (wait_ms accounting); done_ms is service COMPLETION —
        deadline_missed is decided there, so a chunk that starts before
        its deadline but finishes after is correctly reported late.
        Explicit-clock callers that cannot know service time (step/flush)
        leave done_ms=None, collapsing completion onto the flush instant."""
        done = now_ms if done_ms is None else done_ms
        scores, surv = results["scores"], results["survivors"]
        lat, stage_counts = results["lat"], results["stage_counts"]
        errors = results.get("error") or [None] * len(chunk.entries)
        attempts = results.get("attempts") or [1] * len(chunk.entries)
        out = []
        with self.lock:
            for i, e in enumerate(chunk.entries):
                self.stats["inflight"] -= 1
                degraded = e.degraded + chunk.degrades
                missed = e.deadline_ms is not None and done > e.deadline_ms
                if errors[i] is not None:
                    # service failed after retries/quarantine: the future
                    # resolves with an explicit error — it never hangs,
                    # and no exception escapes the seam
                    resp = _error_response(
                        e.req, errors[i], attempts[i],
                        degraded=degraded, truncated=e.truncated,
                        deadline_missed=missed,
                        wait_ms=now_ms - e.submit_ms,
                        service_ms=done - now_ms)
                    e.future._resolve(resp)
                    self.stats["errors"] += 1
                    out.append(resp)
                    continue
                n = len(e.req.item_feats)       # numpy caps slices at g
                order = np.argsort(-scores[i][:n], kind="stable")
                resp = RankResponse(
                    request_id=e.req.request_id,
                    order=order,
                    scores=scores[i][:n],
                    survivors=surv[i][:n] > 0,
                    est_latency_ms=float(lat[i]),
                    stage_counts=[int(c) for c in stage_counts[i]],
                    status=STATUS_OK,
                    degraded=degraded,
                    truncated=e.truncated,
                    deadline_missed=missed,
                    wait_ms=now_ms - e.submit_ms,
                    service_ms=done - now_ms,
                    attempts=attempts[i],
                )
                e.future._resolve(resp)
                self.stats["completed"] += 1
                self.stats["degraded"] += bool(degraded)
                self.stats["deadline_missed"] += missed
                self.stats["truncated"] += e.truncated
                out.append(resp)
        return out

    def fail_chunk(self, chunk: FlushChunk, error: Exception,
                   now_ms: float, done_ms: float | None = None
                   ) -> list[RankResponse]:
        """Last-resort containment (pump supervision): an exception
        escaped the service seam OUTSIDE execute_chunk's own fault
        handling (a pack bug, a resolver bug). Resolve every still-
        unresolved future of the claimed chunk with status="error" so
        the crash cannot hang a caller, and release the staging buffer.
        Already-resolved entries are left untouched."""
        self._release_chunk(chunk)
        done = now_ms if done_ms is None else done_ms
        err = f"{type(error).__name__}: {error}"
        out = []
        with self.lock:
            for e in chunk.entries:
                if e.future.done():
                    continue
                self.stats["inflight"] -= 1
                missed = (e.deadline_ms is not None
                          and done > e.deadline_ms)
                resp = _error_response(
                    e.req, err, 1,
                    degraded=e.degraded + chunk.degrades,
                    truncated=e.truncated, deadline_missed=missed,
                    wait_ms=now_ms - e.submit_ms,
                    service_ms=done - now_ms)
                e.future._resolve(resp)
                self.stats["errors"] += 1
                out.append(resp)
        return out

    # -- failover seams (serving.router) -----------------------------------

    def takeover_pending(self) -> dict[int, list[_Pending]]:
        """Atomically pop EVERY queued entry, by bucket — the router's
        failover drain. When this replica's breaker trips open its backlog
        moves to survivors instead of stranding behind a broken executor;
        futures travel WITH their entries (each resolves on whichever
        replica serves it). Entries already claimed into a chunk
        (inflight) are not touched — the caller that claimed them still
        resolves or fails them here. Only entries move, never device
        tensors: a survivor packs them into its own buffers and copies
        them on its own stream. Counted under stats["drained"] so the
        per-replica snapshot identity stays closed:
          submitted + adopted = completed + shed + errors
                                + pending + inflight + drained
        (globally Σ adopted == Σ drained, so the router-wide identity
        reduces to the plain one)."""
        with self.lock:
            out: dict[int, list[_Pending]] = {}
            n = 0
            for g in self.buckets:
                if self._pending[g]:
                    out[g] = self._pending[g]
                    self._pending[g] = []
                    n += len(out[g])
            self.stats["drained"] += n
            return out

    def adopt_entries(self, g: int, entries: list[_Pending]) -> int:
        """Graft entries drained from a failed replica onto the FRONT of
        this replica's bucket-g queue: they are senior to anything queued
        locally, so FIFO order is preserved across the drain and adopted
        work is re-claimed through the normal claim_*/pack seams — same
        shapes (the warmed pow2 ladder), the same results. A bucket this
        replica does not serve falls back to the largest local bucket,
        exactly like local admission."""
        if not entries:
            return 0
        with self.lock:
            gg = g if g in self._pending else self.buckets[-1]
            self._pending[gg][:0] = entries
            self.stats["adopted"] += len(entries)
            return len(entries)

    def stats_export(self) -> dict:
        """One flat snapshot of the serving metrics surface: lifecycle
        counters, queue/breaker state, the TransferBufferPool's
        allocated/reused counters, and (when a FaultInjector is attached)
        the injected-fault counts — consumed by launch.serve's report,
        SessionPump.stats_export and ReplicaRouter.stats_export.

        The lifecycle counters, pending depth, and breaker state are read
        under ONE session-lock hold, so the snapshot cannot tear mid-read
        under a live pump: it always satisfies
          submitted + adopted = completed + shed + errors
                                + pending + inflight + drained.
        Pool and injector counters are snapshotted under their own locks
        (they advance independently of the lifecycle counters)."""
        with self.lock:
            out = dict(self.stats)
            out["name"] = self.name
            out["pending"] = self.pending
            out["degraded_active"] = self.degraded
            out["consec_faults"] = self._consec_faults
        pool = self.pool.snapshot()
        out["pool_allocated"] = pool["allocated"]
        out["pool_reused"] = pool["reused"]
        if self.faults is not None:
            out["injected"] = self.faults.snapshot()
        return out

    def shed_pending(self) -> int:
        """Resolve EVERY still-queued future with status="shed" (pump
        shutdown: outstanding work is refused, never left hanging).
        Returns the number of futures shed."""
        n = 0
        with self.lock:
            for g in self.buckets:
                for e in self._pending[g]:
                    e.future._resolve(_shed_response(e.req))
                    self.stats["shed"] += 1
                    n += 1
                self._pending[g].clear()
        return n
