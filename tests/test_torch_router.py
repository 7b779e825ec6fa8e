"""The port's ReplicaRouter against the reference on the CPU: every DES
scenario of tests/test_router.py (least-loaded placement, shedding and
degradation on the GLOBAL depth, failover drain with FIFO seniority,
failover disabled stranding the backlog, probe re-admission, every replica
failed) runs on both packages from the same numpy requests and params, and
their reports — queue depths, router and per-replica stats, every
response's status, flags, timings, order and survivors — must be equal;
scores and latency estimates within tolerance (tests/torch_parity.py). The
multi-replica DES (`run_open_loop_router`) is held to the reference the
same way, its chaos failover report is byte-identical across two runs, a
one-replica router is bit-identical to a bare session, and the wall-clock
soak runs one pump per replica."""

import dataclasses
import json
import types

import numpy as np
import pytest

from repro.serving import batching as JB
from repro.serving import faults as JF
from repro.serving import loadgen as JG
from repro.serving import router as JR
from repro.serving import session as JS
from repro_torch.launch import mesh as TM
from repro_torch.serving import batching as TB
from repro_torch.serving import faults as TF
from repro_torch.serving import loadgen as TG
from repro_torch.serving import pump as TP
from repro_torch.serving import router as TR
from repro_torch.serving import session as TS
from torch_parity import torch_lock_order_witness  # noqa: F401
from torch_parity import FakeTimer, assert_margin, cascades, close

_JP, _TP, _JCFG, _TCFG = cascades()


@dataclasses.dataclass
class Pkg:
    """One package's serving modules, params and session placement."""
    B: types.ModuleType
    S: types.ModuleType
    F: types.ModuleType
    R: types.ModuleType
    G: types.ModuleType
    params: dict
    cfg: object
    kw: dict                    # where sessions serve

    def session(self, **kw):
        return self.S.CascadeSession(self.params, self.cfg, **self.kw, **kw)

    def replicas(self, n, **kw):
        if self.kw:                 # the port: every replica on its device
            kw["devices"] = [self.kw["device"]] * n
        return self.R.make_replicas(self.params, self.cfg, n=n, **kw)

    def req(self, i, n_items, seed=None):
        """tests/test_router.py's `_req`, in this package's types."""
        rng = np.random.default_rng(n_items if seed is None else seed)
        return self.B.RankRequest(
            request_id=i,
            q_feat=np.eye(self.cfg.d_q)[i % self.cfg.d_q].astype(np.float32),
            item_feats=rng.normal(size=(n_items, self.cfg.d_x))
            .astype(np.float32),
            m_q=10 * n_items + 1)

    def scfg(self, **kw):
        """tests/test_router.py's `_scfg`."""
        d = dict(plan="filter", group_buckets=(8,), batch_groups=2,
                 flush=self.S.FlushPolicy(max_wait_ms=60_000.0))
        d.update(kw)
        return self.S.ServingConfig(**d)

    def fast_breaker(self):
        """One attempt per chunk, two consecutive failed attempts open the
        breaker, no degrade stage: pure failover."""
        return self.S.RetryPolicy(max_attempts=1, backoff_ms=0.01,
                                  breaker_degrade_after=None,
                                  breaker_open_after=2)

    def dead(self, seed):
        return self.F.FaultInjector(self.F.FaultConfig(transient_rate=1.0,
                                                       seed=seed))


JAX = Pkg(JB, JS, JF, JR, JG, _JP, _JCFG, {})
TORCH = Pkg(TB, TS, TF, TR, TG, _TP, _TCFG, {"device": "cpu"})


def _resp(r) -> dict:
    """A response's discrete fields (scores and latency apart)."""
    return {"request_id": r.request_id, "status": r.status,
            "degraded": list(r.degraded), "truncated": r.truncated,
            "deadline_missed": r.deadline_missed, "wait_ms": r.wait_ms,
            "service_ms": r.service_ms, "error": r.error,
            "attempts": r.attempts, "stage_counts": r.stage_counts,
            "order": r.order.tolist(), "survivors": r.survivors.tolist()}


def _same(jout, tout):
    """Two scenario outputs (report, responses) agree: reports equal,
    responses equal field for field, scores and latency within
    tolerance."""
    (jrep, jresps), (trep, tresps) = jout, tout
    assert jrep == trep
    assert [_resp(r) for r in jresps] == [_resp(r) for r in tresps]
    for a, b in zip(jresps, tresps):
        close(b.scores, a.scores)
        close(b.est_latency_ms, a.est_latency_ms)


def _identity(s):
    """The per-replica atomic-snapshot identity, drain/adopt legs included
    (pump-mode exports nest the session's counters under "session")."""
    s = s.get("session", s)
    return (s["submitted"] + s["adopted"]
            == s["completed"] + s["shed"] + s["errors"]
            + s["pending"] + s["inflight"] + s["drained"])


def test_requests_leave_the_filter_a_margin():
    """Every request the scenarios serve leaves the port's discrete
    decisions a margin, so orders and survivors compare exactly."""
    arrays = [(i, np.eye(8)[i % 8].astype(np.float32),
               np.random.default_rng(4 if s is None else s)
               .normal(size=(4, 24)).astype(np.float32), 41)
              for i, s in [(i, None) for i in range(8)] + [(3, 100)]]
    assert_margin(_TP, _TCFG, arrays, (8,))


# ---------------------------------------------------------------------------
# The DES scenarios of tests/test_router.py, each run on both packages
# ---------------------------------------------------------------------------

def placement(p: Pkg):
    rt = p.R.ReplicaRouter(p.replicas(2, scfg=p.scfg(batch_groups=8)))
    for i in range(6):
        rt.submit(p.req(i, 4), now_ms=0.0)
    # with equal service, least-loaded alternates: 3 queued on each replica
    rep = {"depths": [r.queue_depth() for r in rt.replicas],
           "routed": rt.stats["routed"], "global": rt.global_depth()}
    assert rep == {"depths": [3, 3], "routed": 6, "global": 6}
    rep["closed"] = rt.close()      # close sheds everything still queued
    assert rep["closed"] == 6
    return rep, []


def global_admission(p: Pkg):
    # max_queue=4 is the GLOBAL bound: each replica alone would accept 4
    rt = p.R.ReplicaRouter(p.replicas(2, scfg=p.scfg(batch_groups=8,
                                                     max_queue=4)))
    futs = [rt.submit(p.req(i, 4), now_ms=0.0) for i in range(4)]
    assert not any(f.done() for f in futs)
    depths = [r.queue_depth() for r in rt.replicas]
    assert depths == [2, 2]
    # locally under the bound (2 < 4), but the FLEET is at capacity
    fut = rt.submit(p.req(9, 4), now_ms=0.0)
    assert fut.done() and fut.result().status == p.S.STATUS_SHED
    rep = {"depths": depths, "stats": rt.stats_export()}
    rt.close()
    return rep, [fut.result()] + [f.result() for f in futs]


def global_degrade(p: Pkg):
    scfg = p.scfg(batch_groups=4, degrade=p.S.DegradePolicy(
        high_watermark=4, low_watermark=0))
    reps = p.replicas(2, scfg=scfg)
    rt = p.R.ReplicaRouter(reps)
    for i in range(6):
        rt.submit(p.req(i, 4), now_ms=0.0)
    depths = [r.queue_depth() for r in rt.replicas]
    assert depths == [3, 3]
    # each replica holds 3 < high_watermark locally, yet flushing serves
    # degraded: the watermark fired on the GLOBAL depth (6 >= 4)
    resps = reps[0].flush(10.0)
    assert all(p.S.DEGRADE_TIGHTEN_MQ in r.degraded for r in resps)
    # control: the same 3-deep queue WITHOUT the router's global hook does
    # not reach the watermark
    solo = p.session(scfg=scfg, pipeline_from=reps[0])
    for i in range(3):
        solo.submit(p.req(i, 4), now_ms=0.0)
    solo_resps = solo.flush(10.0)
    assert all(not r.degraded for r in solo_resps)
    rep = {"depths": depths, "stats": rt.stats_export(),
           "solo": solo.stats_export()}
    rt.close()
    return rep, resps + solo_resps


def _trip_breaker(p: Pkg, rep, now_ms=0.0):
    """Serve one chunk through the always-faulting executor: with
    max_attempts=1 the chunk bisects to per-request quarantine, racking up
    consecutive faults past breaker_open_after."""
    chunk = rep.claim_bucket(rep.buckets[0])
    assert chunk is not None
    resps = rep.resolve_chunk(chunk, rep.execute_chunk(chunk), now_ms)
    assert {r.status for r in resps} == {p.S.STATUS_ERROR}
    assert rep._breaker_open()
    return resps


def _failover_fixture(p: Pkg, failover):
    reps = p.replicas(2, scfg=p.scfg(retry=p.fast_breaker()),
                      faults=[p.dead(1), None])
    for r in reps:
        r._sleep = lambda s: None
    rt = p.R.ReplicaRouter(reps, p.R.RouterConfig(failover=failover,
                                                  probe_interval_ms=5.0))
    rt.warmup()
    # backlog lands on the DOOMED replica before its breaker trips (ids
    # 0..7), plus one locally-submitted junior request on the survivor
    futs = [reps[0].submit(p.req(i, 4), now_ms=0.0) for i in range(8)]
    local = reps[1].submit(p.req(100, 4), now_ms=0.0)
    return reps, rt, futs, local


def _shapes(p: Pkg, session) -> int:
    """The pipeline's warmed shapes: the reference's jit cache entries,
    the port's shape record."""
    return (session._rank._cache_size() if p is JAX
            else len(session.shapes_seen))


def failover_drain(p: Pkg):
    reps, rt, futs, local = _failover_fixture(p, failover=True)
    n_shapes = _shapes(p, reps[1])
    tripped = _trip_breaker(p, reps[0])     # ids 0,1 quarantine
    rt.tick(0.0)
    # the dead replica's backlog (ids 2..7) moved to the survivor — at the
    # FRONT, senior to the survivor's own queued request
    assert reps[0].pending == 0
    assert reps[1].stats["adopted"] == 6 and reps[0].stats["drained"] == 6
    assert rt.stats["failovers"] == 1 and rt.stats["drained"] == 6
    assert rt._failed_snapshot() == {0}
    resps = reps[1].flush(50.0)
    assert [r.request_id for r in resps] == [2, 3, 4, 5, 6, 7, 100]
    assert all(r.status == p.S.STATUS_OK for r in resps)
    assert all(f.done() for f in futs) and local.done()
    # adopted work is re-claimed through the warmed shapes
    assert _shapes(p, reps[1]) == n_shapes
    # adopted results equal the same request served alone on a fresh
    # session bit for bit (the drain changes placement, never compute), in
    # both packages: the port sums zq and the scores per row in a fixed
    # order, so the chunk's size does not reach a request's bits
    solo = p.session(scfg=p.scfg(), pipeline_from=reps[1])
    f_solo = solo.submit(p.req(3, 4), now_ms=0.0)
    solo.flush(0.0)
    np.testing.assert_array_equal(futs[3].result().scores,
                                  f_solo.result().scores)
    np.testing.assert_array_equal(futs[3].result().order,
                                  f_solo.result().order)
    st = rt.stats_export()
    assert all(_identity(s) for s in st["replicas"])
    g = st["global"]
    assert g["submitted"] == (g["completed"] + g["shed"] + g["errors"]
                              + g["pending"] + g["inflight"])
    rep = {"stats": st, "failed": sorted(rt._failed_snapshot())}
    rt.close()
    return rep, tripped + resps


def failover_disabled(p: Pkg):
    """Without the drain, a breaker-open replica's queue is stranded
    behind a broken executor."""
    reps, rt, futs, local = _failover_fixture(p, failover=False)
    tripped = _trip_breaker(p, reps[0])
    rt.tick(0.0)
    assert rt._failed_snapshot() == {0}
    assert reps[0].pending == 6         # stranded
    assert reps[1].stats["adopted"] == 0
    resps = reps[0].flush(50.0) + reps[1].flush(50.0)
    assert all(f.result().status == p.S.STATUS_ERROR for f in futs[2:])
    assert local.result().status == p.S.STATUS_OK
    rep = {"stats": rt.stats_export()}
    rt.close()
    return rep, tripped + resps


def probe_readmission(p: Pkg):
    reps, rt, futs, local = _failover_fixture(p, failover=True)
    tripped = _trip_breaker(p, reps[0])
    rt.tick(0.0)                     # drain + first probe (still faulting)
    assert rt._failed_snapshot() == {0}
    assert rt.stats["probes"] == 1
    assert reps[0]._breaker_open()
    rt.tick(2.0)                     # inside probe_interval_ms: no probe
    assert rt.stats["probes"] == 1
    # the executor recovers; the next due probe succeeds and resets the
    # breaker, and the tick after that re-admits the replica
    reps[0].faults = None
    rt.tick(10.0)
    assert rt.stats["probes"] == 2 and not reps[0]._breaker_open()
    rt.tick(11.0)
    assert rt._failed_snapshot() == set()
    assert rt.stats["recoveries"] == 1
    resps = reps[1].flush(20.0)
    rt.submit(p.req(200, 4), now_ms=20.0)
    assert reps[0].queue_depth() == 1    # re-admitted: takes placements
    rep = {"stats": rt.stats_export()}
    rt.close()
    return rep, tripped + resps


def all_failed(p: Pkg):
    """No survivors to drain to: the backlog stays put, every future still
    resolves explicitly and close() sheds the rest."""
    reps = p.replicas(2, scfg=p.scfg(retry=p.fast_breaker()),
                      faults=[p.dead(k + 1) for k in range(2)])
    for r in reps:
        r._sleep = lambda s: None
    rt = p.R.ReplicaRouter(reps)
    futs = [rt.submit(p.req(i, 4), now_ms=0.0) for i in range(8)]
    tripped = _trip_breaker(p, reps[0]) + _trip_breaker(p, reps[1])
    rt.tick(0.0)
    assert rt._failed_snapshot() == {0, 1}
    assert all(r.pending > 0 for r in reps)
    fut = rt.submit(p.req(9, 4), now_ms=0.0)
    assert fut.done() and fut.result().status == p.S.STATUS_SHED
    rep = {"closed": rt.close(), "stats": rt.stats_export()}
    assert all(f.done() for f in futs)
    return rep, tripped + [f.result() for f in futs] + [fut.result()]


SCENARIOS = [placement, global_admission, global_degrade, failover_drain,
             failover_disabled, probe_readmission, all_failed]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_router_scenario_matches_reference(scenario):
    _same(scenario(JAX), scenario(TORCH))


# ---------------------------------------------------------------------------
# The multi-replica DES (run_open_loop_router) side by side, and the
# determinism pins of tests/test_determinism.py
# ---------------------------------------------------------------------------

def _reqs(p: Pkg, n, seed=0):
    """tests/test_determinism.py's `_reqs`."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(2, 9))
        out.append(p.B.RankRequest(
            request_id=i,
            q_feat=np.eye(p.cfg.d_q)[i % p.cfg.d_q].astype(np.float32),
            item_feats=rng.normal(size=(k, p.cfg.d_x)).astype(np.float32),
            m_q=10 * k + 1))
    return out


def _det_scfg(p: Pkg, **kw):
    """tests/test_determinism.py's `_scfg`."""
    d = dict(plan="filter", group_buckets=(8,), batch_groups=2,
             max_queue=8, flush=p.S.FlushPolicy(max_wait_ms=5.0),
             degrade=p.S.DegradePolicy(high_watermark=6, low_watermark=2))
    d.update(kw)
    return p.S.ServingConfig(**d)


def _report(res, stats) -> str:
    return json.dumps({"summary": res.summary(), "stats": stats,
                       "statuses": [f.result().status
                                    for f in res.futures]},
                      sort_keys=True)


def router_chaos(p: Pkg):
    """2 replicas, replica 0's executor always faults with a backlog queued
    behind it (negative ids: the DES treats them like probes): the breaker
    trips, the backlog drains to the survivor."""
    reps = p.replicas(
        2, scfg=_det_scfg(p, max_queue=32, retry=p.S.RetryPolicy(
            max_attempts=1, backoff_ms=0.01, breaker_degrade_after=None,
            breaker_open_after=2)),
        faults=[p.dead(1), None])
    for r in reps:
        r._sleep = lambda s: None
    rt = p.R.ReplicaRouter(reps, p.R.RouterConfig(probe_interval_ms=5.0))
    backlog = []
    for i in range(8):
        r = _reqs(p, 1, seed=100 + i)[0]
        backlog.append(reps[0].submit(p.B.RankRequest(
            request_id=-1000 - i, q_feat=r.q_feat, item_feats=r.item_feats,
            m_q=r.m_q), now_ms=0.0))
    res = p.G.run_open_loop_router(rt, _reqs(p, 60, seed=2), qps=600.0,
                                   deadline_ms=80.0, seed=3,
                                   timer=FakeTimer())
    assert res.unresolved == 0
    assert all(f.done() for f in backlog)
    st = rt.stats_export()
    assert st["failovers"] >= 1 and st["drained"] > 0
    rt.close()
    blob = _report(res, st) + json.dumps([f.result().status
                                          for f in backlog])
    return blob, [f.result() for f in res.futures]


def test_router_chaos_report_byte_identical_and_matches_reference():
    blob, resps = router_chaos(TORCH)
    assert router_chaos(TORCH)[0] == blob
    _same(router_chaos(JAX), (blob, resps))


@pytest.mark.parametrize("qps", [600.0, 1200.0])
def test_router_des_two_replicas_matches_reference(qps):
    """Two healthy replicas under the DES, light and overloaded: shedding
    and degradation judge the fleet's depth, each replica its own virtual
    clock."""
    def run(p: Pkg):
        rt = p.R.ReplicaRouter(p.replicas(2, scfg=_det_scfg(p)))
        res = p.G.run_open_loop_router(rt, _reqs(p, 60, seed=2), qps=qps,
                                       deadline_ms=40.0, seed=3,
                                       timer=FakeTimer())
        assert res.unresolved == 0
        st = rt.stats_export()
        rt.close()
        return _report(res, st), [f.result() for f in res.futures]
    _same(run(JAX), run(TORCH))


def test_router_single_replica_bit_identical_to_bare_session():
    ses = TORCH.session(scfg=_det_scfg(TORCH))
    res_bare = TG.run_open_loop(ses, _reqs(TORCH, 60, seed=2), qps=1200.0,
                                deadline_ms=40.0, seed=3, timer=FakeTimer())
    rep = TORCH.session(scfg=_det_scfg(TORCH), name="replica0",
                        pipeline_from=ses)
    rt = TR.ReplicaRouter([rep])
    res_rt = TG.run_open_loop_router(rt, _reqs(TORCH, 60, seed=2),
                                     qps=1200.0, deadline_ms=40.0, seed=3,
                                     timer=FakeTimer())
    rt.close()
    assert (json.dumps(res_bare.summary(), sort_keys=True)
            == json.dumps(res_rt.summary(), sort_keys=True))
    assert len(res_bare.futures) == len(res_rt.futures) == 60
    for fa, fb in zip(res_bare.futures, res_rt.futures):
        ra, rb = fa.result(), fb.result()
        assert _resp(ra) == _resp(rb)
        np.testing.assert_array_equal(ra.scores, rb.scores)


# ---------------------------------------------------------------------------
# The port's own contracts: placement on devices and streams, refusals
# ---------------------------------------------------------------------------

def test_replicas_share_one_pipeline_and_refuse_a_mismatched_donor():
    reps = TORCH.replicas(3, scfg=TORCH.scfg())
    assert all(r._rank is reps[0]._rank for r in reps)
    assert all(r.shapes_seen is reps[0].shapes_seen for r in reps)
    assert [r.name for r in reps] == ["replica0", "replica1", "replica2"]
    assert all(r.stream is None for r in reps)      # CPU: no streams
    with pytest.raises(ValueError, match="pipeline_from"):
        TORCH.session(scfg=TORCH.scfg(plan="score"), pipeline_from=reps[0])
    with pytest.raises(ValueError, match="one entry per replica"):
        TORCH.replicas(2, scfg=TORCH.scfg(), faults=[None])
    with pytest.raises(ValueError, match="CUDA stream"):
        TORCH.session(stream=object())
    assert TM.replica_devices(3, "cpu") == [reps[0].device] * 3
    with pytest.raises(ValueError, match="kind"):
        TM.replica_devices(2, "tpu")


def test_cuda_router_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TM.replica_devices(2)
    with pytest.raises((AssertionError, RuntimeError)):
        TR.make_replicas(_TP, _TCFG, n=2)       # device defaults to cuda


# ---------------------------------------------------------------------------
# Wall-clock pump mode: the same router over live per-replica pumps
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_router_pump_soak_two_replicas_zero_unresolved():
    scfg = TORCH.scfg(group_buckets=(8, 16), batch_groups=4, max_queue=64,
                      flush=TS.FlushPolicy(max_wait_ms=2.0))
    reps = TORCH.replicas(2, scfg=scfg)
    rt = TR.ReplicaRouter(reps)
    rt.warmup()
    n_shapes = len(reps[0].shapes_seen)
    rng = np.random.default_rng(11)
    reqs = [TORCH.req(i, int(rng.integers(2, 17)), seed=i)
            for i in range(80)]
    rt.attach_pumps([TP.SessionPump(s, name=f"pump-{s.name}").start()
                     for s in reps])
    res = TP.run_wall_clock(rt, reqs, qps=2000.0, deadline_ms=250.0,
                            n_threads=4, seed=11, result_timeout_s=60.0)
    rt.close(timeout=30.0)
    assert not any(p._thread.is_alive() for p in rt.pumps)
    assert res.unresolved == 0
    assert all(f.done() for f in res.futures)
    assert res.completed + res.shed == len(reqs)
    st = rt.stats_export()
    assert all(_identity(s) for s in st["replicas"])
    g = st["global"]
    assert g["pending"] == 0 and g["inflight"] == 0
    assert g["submitted"] == g["completed"] + g["shed"] + g["errors"]
    assert rt.stats["routed"] == len(reqs)
    assert len(reps[0].shapes_seen) == n_shapes
    assert sum(s["session"]["submitted"] > 0 for s in st["replicas"]) == 2
