"""Request batching for the cascade ranking server.

The operational system serves ~40k QPS across clusters (paper §4.1); the
unit of work is a *query group*: (query features, recalled item features,
M_q). The batcher pads item lists to a fixed group size and packs groups
into fixed-batch buckets so the scoring pipeline sees a small, warm set
of shapes (shape-bucketing: every shape is run once at warmup).

Requests are packed into numpy arrays, as in the reference. A session on a
CUDA device stages them in page-locked host memory (`TransferBufferPool`
with `pin=True`): the numpy arrays are views of pinned torch tensors, which
the session copies to the card without blocking the host.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class RankRequest:
    request_id: int
    q_feat: np.ndarray          # (d_q,)
    item_feats: np.ndarray      # (n_items, d_x)
    m_q: int                    # recalled-item count in the full index
    price: np.ndarray | None = None


@dataclasses.dataclass
class RankResponse:
    request_id: int
    order: np.ndarray           # ranked item indices (best first)
    scores: np.ndarray          # final-stage scores, -inf for filtered
    survivors: np.ndarray       # bool mask of items that passed all stages
    est_latency_ms: float       # Eq-16 latency model for this query
    stage_counts: list[int]
    # request-lifecycle metadata (serving.session) — every response carries
    # an explicit status instead of silently dropping or truncating work:
    status: str = "ok"          # "ok" | "shed" (admission-control rejection)
    #                             | "error" (service failed after retries —
    #                             the future resolves, never hangs)
    degraded: tuple[str, ...] = ()  # degradation modes applied to this request
    truncated: bool = False     # item list exceeded the LARGEST bucket
    deadline_missed: bool = False   # service COMPLETED after the deadline
    wait_ms: float = 0.0        # time spent queued before the flush start
    service_ms: float = 0.0     # flush start -> completion (0 when the
    # caller cannot know service time: explicit-clock step()/flush())
    error: str | None = None    # status="error": why service failed
    attempts: int = 1           # execute attempts spent on this request's
    # chunk (>1 means retries/bisection happened on its path)


def bucket_of(n_items: int, buckets: tuple[int, ...]) -> int:
    """Smallest declared bucket that fits n_items (the largest one when
    nothing fits — the request is then truncated). `buckets` sorted
    ascending."""
    for b in buckets:
        if n_items <= b:
            return b
    return buckets[-1]


def warmup_batch_sizes(batch_groups: int) -> list[int]:
    """Every batch-axis size a chunk can pack into: powers of two up to
    batch_groups — THE warmup ladder. Must stay in lockstep with
    padded_batch_rows below."""
    bs, b = [], 1
    while b < batch_groups:
        bs.append(b)
        b <<= 1
    bs.append(batch_groups)
    return bs


def padded_batch_rows(n_reqs: int, batch_groups: int) -> int:
    """The batch-axis size a chunk of n_reqs packs into: next power of two,
    capped at batch_groups — THE pow2 padding rule: a short chunk pays at
    most 2x the per-row compute of its real requests, and only
    log2(batch_groups) extra shapes exist. Padded rows are all-masked and
    never surfaced."""
    return min(batch_groups, 1 << (n_reqs - 1).bit_length())


def alloc_batch(b: int, g: int, d_x: int, d_q: int) -> dict:
    """A zeroed (b, g) staging batch — the layout pack_into fills."""
    return {"x": np.zeros((b, g, d_x), np.float32),
            "q": np.zeros((b, d_q), np.float32),
            "mask": np.zeros((b, g), np.float32),
            "m_q": np.zeros((b,), np.float32)}


class PinnedBatch(dict):
    """A staging batch whose numpy arrays are views of page-locked torch
    tensors (`pinned`, same keys). `copied` is recorded on the stream that
    copies them to the device; the pool waits for it before handing the
    buffer out again."""
    pinned: dict[str, torch.Tensor]
    copied: torch.cuda.Event


def alloc_pinned_batch(b: int, g: int, d_x: int, d_q: int) -> PinnedBatch:
    """alloc_batch's layout in page-locked host memory (needs a CUDA
    card)."""
    shapes = {"x": (b, g, d_x), "q": (b, d_q), "mask": (b, g), "m_q": (b,)}
    pinned = {k: torch.zeros(s, dtype=torch.float32, pin_memory=True)
              for k, s in shapes.items()}
    batch = PinnedBatch({k: t.numpy() for k, t in pinned.items()})
    batch.pinned = pinned
    batch.copied = torch.cuda.Event()
    return batch


def pack_into(batch: dict, reqs: list[RankRequest], g: int, *,
              start: int = 0) -> None:
    """Stage `reqs` into rows [start, start+len(reqs)) of an existing
    zeroed batch (alloc_batch / TransferBufferPool.acquire layout). Rows
    must not have been written since the batch was zeroed — incremental
    packing (the pump's slot late-join) only ever appends rows."""
    for i, r in enumerate(reqs, start=start):
        n = min(len(r.item_feats), g)
        batch["x"][i, :n] = r.item_feats[:n]
        batch["q"][i] = r.q_feat
        batch["mask"][i, :n] = 1.0
        batch["m_q"][i] = r.m_q


def pack_requests(reqs: list[RankRequest], g: int, batch_groups: int) -> dict:
    """Pad a chunk of requests into one (B, g) batch: B is the pow2
    padding of `padded_batch_rows`, padded rows are all-masked and never
    surfaced, items beyond g are truncated (surfaced as
    RankResponse.truncated). The packing RequestBatcher.drain yields, the
    same bytes as the session's pooled `pack_into`."""
    b = padded_batch_rows(len(reqs), batch_groups)
    d_x = reqs[0].item_feats.shape[-1]
    d_q = reqs[0].q_feat.shape[-1]
    batch = alloc_batch(b, g, d_x, d_q)
    pack_into(batch, reqs, g)
    return batch


class TransferBufferPool:
    """Reusable host staging buffers, one free list per (b, g) shape.

    The serving hot path packs every flush chunk into a (b, g) batch; with
    a handful of shape buckets and pow2 batch padding the shape set is
    small and repeats forever, so allocating fresh numpy arrays per flush
    is pure churn. The pool hands out preallocated buffers (zeroed on
    acquire, so packing results are bit-identical to a fresh alloc) and
    takes them back after the device results have been fetched. With
    `pin=True` (a session on a CUDA device) the buffers are page-locked
    (`PinnedBatch`), so the session's copies to the card are asynchronous
    DMA from them; page-locking is slow, which is why they are kept.

    acquire/release are thread-safe (the pump packs while submitters run);
    `allocated`/`reused` expose hot-path allocation behavior to tests: a
    warmed steady state must stop allocating entirely."""

    def __init__(self, d_x: int, d_q: int, *, max_free_per_shape: int = 4,
                 pin: bool = False):
        self.d_x = d_x
        self.d_q = d_q
        self.max_free_per_shape = max_free_per_shape
        self.pin = pin
        self._free: dict[tuple[int, int], list[dict]] = {}
        self._lock = threading.Lock()
        self.allocated = 0
        self.reused = 0

    def acquire(self, b: int, g: int) -> dict:
        """A zeroed (b, g) staging batch, reused when one is free."""
        with self._lock:
            free = self._free.get((b, g))
            batch = free.pop() if free else None
            # counters mutate under the pool lock: concurrent acquirers
            # (per-replica pumps behind one router) must never lose an
            # increment, and stats_export snapshots must not tear
            if batch is None:
                self.allocated += 1
            else:
                self.reused += 1
        if batch is None:
            alloc = alloc_pinned_batch if self.pin else alloc_batch
            return alloc(b, g, self.d_x, self.d_q)
        for v in batch.values():
            v[...] = 0.0
        return batch

    def snapshot(self) -> dict:
        """Consistent point-in-time read of the pool counters (taken under
        the pool lock — a live pump may be acquiring concurrently)."""
        with self._lock:
            return {"allocated": self.allocated, "reused": self.reused}

    def release(self, batch: dict) -> None:
        """Return a buffer once its device results have been fetched. A
        pinned buffer whose copies to the device may still be in flight
        (the pipeline raised after enqueueing them) is first waited for:
        the next acquire zeroes it."""
        if isinstance(batch, PinnedBatch):
            batch.copied.synchronize()
        key = (batch["mask"].shape[0], batch["mask"].shape[1])
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.max_free_per_shape:
                free.append(batch)


class RequestBatcher:
    """Pads and packs requests into (B, G) buckets (the CascadeServer
    shim's queue)."""

    def __init__(self, group_size: int = 64, batch_groups: int = 32,
                 group_buckets: tuple[int, ...] = (16, 64, 256)):
        self.group_size = group_size
        self.batch_groups = batch_groups
        self.buckets = sorted(group_buckets)
        self._queue: list[RankRequest] = []

    def submit(self, req: RankRequest) -> None:
        self._queue.append(req)

    def __len__(self) -> int:
        return len(self._queue)

    def _bucket(self, n_items: int) -> int:
        return bucket_of(n_items, self.buckets)

    def drain(self) -> Iterator[tuple[list[int], list[RankRequest], dict]]:
        """Yield (submit_seqs, requests, padded batch arrays) until the
        queue is empty. Batches are grouped per shape bucket, so they do
        NOT come out in submit order — submit_seqs carries each request's
        position in the submit stream so callers (CascadeServer.serve)
        can restore it. Items beyond the largest bucket are truncated;
        consumers surface this as RankResponse.truncated (a request is
        truncated exactly when len(item_feats) > the batch's G)."""
        by_bucket: dict[int, list[tuple[int, RankRequest]]] = {}
        for seq, r in enumerate(self._queue):
            by_bucket.setdefault(self._bucket(len(r.item_feats)),
                                 []).append((seq, r))
        self._queue.clear()
        for g, pairs in sorted(by_bucket.items()):
            for s in range(0, len(pairs), self.batch_groups):
                chunk = pairs[s:s + self.batch_groups]
                reqs = [r for _, r in chunk]
                yield [seq for seq, _ in chunk], reqs, self._pad(reqs, g)

    def _pad(self, reqs: list[RankRequest], g: int) -> dict:
        return pack_requests(reqs, g, self.batch_groups)

    def warmup(self, rank_fn, d_x: int, d_q: int) -> list[tuple[int, int]]:
        """Drive rank_fn once per serving shape, so that live requests
        meet no new shape: every (b, bucket) with b a power of two up to
        batch_groups — the exact shapes _pad can emit, drain-tail batches
        included. Returns the list of warmed shapes."""
        bs = warmup_batch_sizes(self.batch_groups)
        shapes = []
        for g in self.buckets:
            for b in bs:
                batch = {
                    "x": np.zeros((b, g, d_x), np.float32),
                    "q": np.zeros((b, d_q), np.float32),
                    "mask": np.ones((b, g), np.float32),
                    "m_q": np.full((b,), float(g), np.float32),
                }
                rank_fn(batch)
                shapes.append((b, g))
        return shapes
