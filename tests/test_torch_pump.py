"""The port's SessionPump on the CPU, the scenarios of tests/test_pump.py:
blocking and poll semantics of the futures, the pump serving blocking
submitters, close() shedding or draining (never a hung future), the slot
late-join riding a padding row with the same results as a solo serve (the
reference's session serves the same request beside it), its capacity,
transfer-pool reuse and zeroing (and a page-locked buffer waited for before
reuse), stats snapshots that never tear under a live pump, the locked
launch counters, and the wall-clock soak. Every wait has a timeout."""

import sys
import threading
import time

import numpy as np
import pytest

from repro.serving import session as JS
from repro_torch.kernels import _build, ops
from repro_torch.serving import batching as TB
from repro_torch.serving import session as TS
from repro_torch.serving.pump import SessionPump, run_wall_clock
from torch_parity import torch_lock_order_witness  # noqa: F401
from torch_parity import assert_margin, cascades, close

_JP, _TP, _JCFG, _TCFG = cascades()
WAIT_S = 30.0               # every blocking wait in this file is bounded


def _req(mod, i, n_items, seed=None):
    """tests/test_pump.py's `_req`, in the port's (or, with JB, the
    reference's) request type."""
    rng = np.random.default_rng(n_items if seed is None else seed)
    return mod.RankRequest(request_id=i,
                           q_feat=np.eye(8)[i % 8].astype(np.float32),
                           item_feats=rng.normal(size=(n_items, 24))
                           .astype(np.float32),
                           m_q=10 * n_items + 1)


def _session(*, buckets=(8,), batch_groups=2, **kw):
    defaults = dict(plan="filter", group_buckets=buckets,
                    batch_groups=batch_groups)
    defaults.update(kw)
    return TS.CascadeSession(_TP, _TCFG, scfg=TS.ServingConfig(**defaults),
                             device="cpu")


def test_future_blocking_and_poll_semantics():
    ses = _session()
    fut = ses.submit(_req(TB, 0, 4), now_ms=0.0)
    with pytest.raises(RuntimeError, match="still pending"):
        fut.result()
    assert not fut.wait(timeout=0.01)
    with pytest.raises(TimeoutError, match="unresolved"):
        fut.result(timeout=0.01)
    # a resolver thread unblocks a waiting consumer
    t = threading.Thread(target=lambda: (time.sleep(0.05), ses.flush(1.0)))
    t.start()
    resp = fut.result(timeout=WAIT_S)
    t.join(WAIT_S)
    assert not t.is_alive()
    assert resp.status == TS.STATUS_OK
    assert fut.wait(timeout=0.0)


def test_pump_serves_blocking_submitters():
    ses = _session(flush=TS.FlushPolicy(max_wait_ms=2.0))
    ses.warmup()
    with SessionPump(ses) as pump:
        futs = [pump.submit(_req(TB, i, 4)) for i in range(5)]
        resps = [f.result(timeout=WAIT_S) for f in futs]
    assert not pump.running
    assert [r.status for r in resps] == [TS.STATUS_OK] * 5
    assert [r.request_id for r in resps] == list(range(5))
    assert all(r.service_ms > 0 for r in resps)     # real measured service
    assert ses.stats["completed"] == 5
    assert pump.stats["served"] == 5 and pump.stats["cycles"] >= 1
    st = pump.stats_export()
    assert st["session"]["completed"] == 5 and st["running"] is False


def test_pump_close_sheds_outstanding_futures_never_hangs():
    # nothing can come due before close(): the wait ceiling is unreachable
    # and batch_groups=4 keeps 3 submits from triggering a flush-full
    ses = _session(batch_groups=4, flush=TS.FlushPolicy(max_wait_ms=60_000.0))
    pump = SessionPump(ses).start()
    futs = [pump.submit(_req(TB, i, 4)) for i in range(3)]
    assert not any(f.done() for f in futs)
    pump.close(timeout=WAIT_S)              # shutdown semantics: shed
    assert all(f.done() for f in futs)
    assert {f.result().status for f in futs} == {TS.STATUS_SHED}
    assert pump.stats["shutdown_shed"] == 3
    assert ses.stats["shed"] == 3
    with pytest.raises(RuntimeError, match="closed"):
        pump.submit(_req(TB, 9, 4))


def test_pump_close_drain_serves_outstanding_futures():
    ses = _session(flush=TS.FlushPolicy(max_wait_ms=60_000.0))
    ses.warmup()
    pump = SessionPump(ses).start()
    futs = [pump.submit(_req(TB, i, 4)) for i in range(3)]
    pump.close(drain=True, timeout=WAIT_S)  # serve the queue, then stop
    assert all(f.result().status == TS.STATUS_OK for f in futs)
    assert pump.stats["shutdown_shed"] == 0
    assert ses.stats["completed"] == 3


def test_slot_join_rides_padding_row_with_the_reference_results():
    assert_margin(_TP, _TCFG, [(3, np.eye(8)[3].astype(np.float32),
                                _req(TB, 3, 5).item_feats, 51)], (8,))
    ses = _session(buckets=(8,), batch_groups=4)
    ses.warmup()
    pump = SessionPump(ses)                 # not started: drive by hand
    for i in range(3):
        ses.submit(_req(TB, i, 4), now_ms=0.0)
    chunk = ses.claim_due(100.0)            # 3 entries -> capacity 4 (pow2)
    assert (chunk.g, len(chunk.entries), chunk.capacity) == (8, 3, 4)
    with ses.lock:
        chunk.open = True
        pump._open[chunk.g] = chunk
    ses.pack_chunk(chunk)                   # initial rows staged
    late = pump.submit(_req(TB, 3, 5))      # lands in the open chunk
    assert pump.stats["slot_joins"] == 1
    assert len(chunk.entries) == 4 and ses.pending == 0
    assert ses.stats["inflight"] == 4
    with ses.lock:
        chunk.open = False
        pump._open.pop(chunk.g)
    ses.pack_chunk(chunk)                   # stages ONLY the late row
    full = pump.submit(_req(TB, 4, 5))      # chunk closed -> queues normally
    assert pump.stats["slot_joins"] == 1 and ses.pending == 1
    resps = ses.resolve_chunk(chunk, ses.execute_chunk(chunk),
                              now_ms=100.0, done_ms=101.0)
    assert [r.request_id for r in resps] == [0, 1, 2, 3]
    assert late.done() and not full.done()
    # the slot-joined response equals the same request served alone by
    # the reference's session
    jses = JS.CascadeSession(_JP, _JCFG, scfg=JS.ServingConfig(
        plan="filter", group_buckets=(8,), batch_groups=4))
    f_ref = jses.submit(_req(JS, 3, 5), now_ms=0.0)
    jses.flush(0.0)
    got, want = late.result(), f_ref.result()
    close(got.scores, want.scores)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.survivors, want.survivors)
    assert got.stage_counts == want.stage_counts
    # ... and the port's own solo serve, bit for bit (zq and the scores
    # are summed per row in a fixed order: the padding-row ride changes
    # nothing)
    solo = _session(buckets=(8,), batch_groups=4)
    f_solo = solo.submit(_req(TB, 3, 5), now_ms=0.0)
    solo.flush(0.0)
    np.testing.assert_array_equal(got.scores, f_solo.result().scores)
    np.testing.assert_array_equal(got.order, f_solo.result().order)
    assert got.stage_counts == f_solo.result().stage_counts


def test_slot_join_respects_capacity():
    ses = _session(buckets=(8,), batch_groups=2)
    pump = SessionPump(ses)
    ses.submit(_req(TB, 0, 4), now_ms=0.0)
    ses.submit(_req(TB, 1, 4), now_ms=0.0)
    chunk = ses.claim_due(100.0)            # full chunk: capacity 2
    with ses.lock:
        chunk.open = True
        pump._open[chunk.g] = chunk
    pump.submit(_req(TB, 2, 4))             # no free padded row -> queues
    assert pump.stats["slot_joins"] == 0
    assert ses.pending == 1
    ses.resolve_chunk(chunk, ses.execute_chunk(chunk), now_ms=100.0)


def test_transfer_pool_reuses_buffers_on_the_flush_hot_path():
    """One (2, 8) buffer allocated once, then reused every round — the
    reference's counts (tests/test_pump.py) on the same schedule."""
    def rounds(mod, ses):
        ses.warmup()
        for round_ in range(6):
            futs = [ses.submit(_req(mod, i, 4, seed=round_ * 8 + i),
                               now_ms=round_ * 10.0) for i in range(2)]
            ses.step(round_ * 10.0 + 5.0)
            assert all(f.done() for f in futs)
        return ses.pool.snapshot()
    kw = dict(plan="filter", group_buckets=(8,), batch_groups=2)
    want = rounds(JS, JS.CascadeSession(_JP, _JCFG, scfg=JS.ServingConfig(
        flush=JS.FlushPolicy(max_wait_ms=1.0), **kw)))
    got = rounds(TB, _session(flush=TS.FlushPolicy(max_wait_ms=1.0)))
    assert got == want == {"allocated": 1, "reused": 5}


def test_transfer_pool_zeroes_reused_buffers():
    pool = TB.TransferBufferPool(d_x=6, d_q=4)
    assert not pool.pin
    buf = pool.acquire(2, 8)
    buf["x"][...] = 7.0
    buf["mask"][...] = 1.0
    buf["m_q"][...] = 3.0
    pool.release(buf)
    buf2 = pool.acquire(2, 8)
    assert buf2 is buf                      # same storage came back
    for v in buf2.values():
        assert (v == 0.0).all()             # ...zeroed, as if fresh
    other = pool.acquire(4, 8)              # distinct shapes never share
    assert other["x"].shape == (4, 8, 6)
    assert pool.allocated == 2 and pool.reused == 1


def test_pinned_buffer_waits_for_its_copies_before_reuse():
    """A page-locked staging buffer goes back to the free list only after
    the event recorded behind its copies to the device has completed (the
    pipeline may raise after enqueueing them): release() waits on it."""
    calls = []

    class Event:
        def synchronize(self):
            calls.append("synchronize")

    pool = TB.TransferBufferPool(d_x=6, d_q=4)
    batch = TB.PinnedBatch(TB.alloc_batch(2, 8, 6, 4))
    batch.copied = Event()
    pool.release(batch)
    assert calls == ["synchronize"]
    assert pool.acquire(2, 8) is batch and pool.reused == 1


def test_session_on_cpu_stages_pageable_buffers():
    ses = _session()
    assert not ses.pool.pin and ses.stream is None
    assert type(ses.pool.acquire(2, 8)) is dict


def test_stats_export_snapshot_never_tears_under_live_pump():
    ses = _session(buckets=(8,), batch_groups=4, max_queue=32,
                   flush=TS.FlushPolicy(max_wait_ms=1.0))
    ses.warmup()
    torn = []
    stop = threading.Event()

    def reporter():
        while not stop.is_set():
            s = ses.stats_export()
            lhs = s["submitted"] + s["adopted"]
            rhs = (s["completed"] + s["shed"] + s["errors"] + s["pending"]
                   + s["inflight"] + s["drained"])
            if lhs != rhs:
                torn.append(s)

    futs = []
    fut_lock = threading.Lock()

    def submitter(t):
        for i in range(30):
            f = pump.submit(_req(TB, t * 1000 + i, 4, seed=i))
            with fut_lock:
                futs.append(f)

    with SessionPump(ses) as pump:
        rep = threading.Thread(target=reporter)
        rep.start()
        subs = [threading.Thread(target=submitter, args=(t,))
                for t in range(3)]
        for t in subs:
            t.start()
        for t in subs:
            t.join(WAIT_S)
        for f in futs:
            f.wait(timeout=WAIT_S)
        stop.set()
        rep.join(WAIT_S)
    assert not rep.is_alive() and not any(t.is_alive() for t in subs)
    assert not torn, f"torn stats snapshot(s): {torn[:2]}"
    assert len(futs) == 90 and all(f.done() for f in futs)


def test_launch_counts_lose_no_increment_across_threads():
    """The wrappers count under one lock (`_build.count_launch`): many
    threads counting at once, with the interpreter switching threads as
    often as it can, lose no increment; launch_counts() and
    reset_launch_counts() read and reset under the same lock."""
    fn = ops.KERNELS["cascade_filter"]
    before = ops.launch_counts()
    n_threads, per_thread = 8, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(fn)
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    after = ops.launch_counts()
    assert after["cascade_filter"] == (before["cascade_filter"]
                                       + n_threads * per_thread)
    assert {k: v for k, v in after.items() if k != "cascade_filter"} \
        == {k: v for k, v in before.items() if k != "cascade_filter"}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.slow
def test_pump_soak_concurrent_submitters_zero_unresolved():
    ses = _session(buckets=(8, 16), batch_groups=4, max_queue=64,
                   flush=TS.FlushPolicy(max_wait_ms=2.0))
    shapes = ses.warmup()
    n_shapes = len(ses.shapes_seen)
    assert n_shapes == len(shapes)
    rng = np.random.default_rng(7)
    reqs = [_req(TB, i, int(rng.integers(2, 17)), seed=i)
            for i in range(80)]
    with SessionPump(ses) as pump:
        res = run_wall_clock(pump, reqs, qps=2000.0, deadline_ms=250.0,
                             n_threads=4, seed=7, result_timeout_s=WAIT_S)
    assert res.unresolved == 0
    assert all(f.done() for f in res.futures)
    assert {f.result().status for f in res.futures} <= {"ok", "shed"}
    assert res.completed + res.shed == len(reqs)
    assert res.completed == len(res.latency_ms)
    assert (res.latency_ms >= 0).all()
    assert ses.stats["submitted"] == len(reqs)
    assert ses.stats["completed"] == res.completed
    assert ses.stats["shed"] == res.shed + pump.stats["shutdown_shed"]
    assert len(ses.shapes_seen) == n_shapes     # no shape after warmup
    assert ses.pool.allocated <= len(shapes)
