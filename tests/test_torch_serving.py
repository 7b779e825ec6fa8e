"""The port's serving slice against the reference on the CPU: batching,
the seeded fault injector, and the whole session under the virtual-clock
open-loop DES with an injected service clock (the pattern of
tests/test_determinism.py). On the same requests and params, every
response's status, order, survivors, flags, stage counts and timings, the
run summary and stats_export() must be equal; scores and latency
estimates within tolerance. Also the CascadeServer shim and its
RequestBatcher, and the launcher: its DES path, --pump, --replicas 2
--kill-replica and --faults."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro.core import losses as JLoss
from repro.launch import serve as JL
from repro.serving import batching as JB
from repro.serving import cascade_server as JCS
from repro.serving import faults as JF
from repro.serving import session as JS
from repro.serving.loadgen import run_open_loop as j_run
from repro_torch.core import losses as TLoss
from repro_torch.data import LogConfig, generate_log
from repro_torch.launch import serve as TL
from repro_torch.serving import batching as TB
from repro_torch.serving import cascade_server as TCS
from repro_torch.serving import faults as TF
from repro_torch.serving import session as TS
from repro_torch.serving.pump import SessionPump
from repro_torch.serving.loadgen import run_open_loop as t_run
from torch_parity import (FakeTimer, assert_margin, assert_same_serve,
                          cascades, close, requests, serving_arrays,
                          serving_config)

_JP, _TP, _JCFG, _TCFG = cascades()


def _log_arrays(n, seed=0):
    _, te = generate_log(LogConfig(n_queries=800, seed=0)).split(0.8)
    return [(r.request_id, r.q_feat, r.item_feats, r.m_q)
            for r in TL.make_requests(te, n, seed)]


def _serve_pair(arrays, qps, deadline_ms, *, seed=3, faults=None, **kw):
    jses = JS.CascadeSession(_JP, _JCFG, scfg=serving_config(JS, **kw),
                             faults=None if faults is None
                             else JF.FaultInjector(JF.FaultConfig(**faults)))
    tses = TS.CascadeSession(_TP, _TCFG, scfg=serving_config(TS, **kw), device="cpu",
                             faults=None if faults is None
                             else TF.FaultInjector(TF.FaultConfig(**faults)))
    for s in (jses, tses):
        s._sleep = lambda sec: None
    jres = j_run(jses, requests(JB, arrays), qps, deadline_ms=deadline_ms,
                 seed=seed, timer=FakeTimer())
    tres = t_run(tses, requests(TB, arrays), qps, deadline_ms=deadline_ms,
                 seed=seed, timer=FakeTimer())
    assert tres.unresolved == 0
    assert_same_serve(jres, tres, jses, tses)
    return tres, tses


# ---------------------------------------------------------------------------
# batching and faults: numpy modules, replayed side by side
# ---------------------------------------------------------------------------

def test_bucketing_and_padding_rules_match_reference():
    for bg in (1, 2, 5, 32, 33):
        assert TB.warmup_batch_sizes(bg) == JB.warmup_batch_sizes(bg)
        for k in range(1, bg + 1):
            assert TB.padded_batch_rows(k, bg) == JB.padded_batch_rows(k, bg)
    for k in (0, 1, 16, 17, 64, 255, 256, 1000):
        assert TB.bucket_of(k, (16, 64, 256)) == JB.bucket_of(k, (16, 64, 256))


def test_pack_and_pool_match_reference():
    arrays = serving_arrays(5, seed=1, lo=1, hi=20)
    jpool, tpool = JB.TransferBufferPool(24, 8), TB.TransferBufferPool(24, 8)
    for _ in range(3):
        jb, tb = jpool.acquire(8, 16), tpool.acquire(8, 16)
        JB.pack_into(jb, requests(JB, arrays[:3]), 16)
        TB.pack_into(tb, requests(TB, arrays[:3]), 16)
        TB.pack_into(tb, requests(TB, arrays[3:]), 16, start=3)
        JB.pack_into(jb, requests(JB, arrays[3:]), 16, start=3)
        for k in jb:
            assert jb[k].tobytes() == tb[k].tobytes()
        jpool.release(jb)
        tpool.release(tb)
    assert jpool.snapshot() == tpool.snapshot() == {"allocated": 1,
                                                    "reused": 2}


@pytest.mark.parametrize("cfg", [
    dict(transient_rate=0.3, latency_rate=0.2, corrupt_rate=0.4,
         poison_rate=0.1, seed=7),
    dict(poison_ids=(3, 11), seed=1)])
def test_fault_injector_replays_reference(cfg):
    sleeps = ([], [])
    inj = (JF.FaultInjector(JF.FaultConfig(**cfg), sleep=sleeps[0].append),
           TF.FaultInjector(TF.FaultConfig(**cfg), sleep=sleeps[1].append))
    outcomes = ([], [])
    for step in range(40):
        ids = list(range(step, step + 3))
        for k in (0, 1):
            try:
                inj[k].on_attempt(ids)
                res = {"scores": np.zeros((4, 8), np.float32)}
                inj[k].on_results(res, 3)
                outcomes[k].append(res["scores"].tobytes())
            except (JF.InjectedFault, TF.InjectedFault) as e:
                outcomes[k].append(f"{type(e).__name__}: {e}")
    assert outcomes[0] == outcomes[1]
    assert sleeps[0] == sleeps[1]
    assert inj[0].snapshot() == inj[1].snapshot()
    assert [inj[0].is_poisoned(i) for i in range(200)] \
        == [inj[1].is_poisoned(i) for i in range(200)]


# ---------------------------------------------------------------------------
# the session under the DES, side by side with the reference
# ---------------------------------------------------------------------------

def test_des_overload_sheds_and_degrades_like_reference():
    arrays = serving_arrays(60, seed=2)
    assert_margin(_TP, _TCFG, arrays, (8,))
    res, ses = _serve_pair(arrays, qps=1200.0, deadline_ms=40.0)
    assert res.shed > 0 and res.degraded > 0
    assert ses.stats_export()["degrade_enters"] > 0


@pytest.mark.parametrize("plan", ["filter", "score", "none"])
def test_des_launcher_profile_matches_reference(plan):
    """The launcher's serving profile and requests, under light load."""
    assert dataclasses.asdict(JL.build_serving_config(plan=plan)) \
        == dataclasses.asdict(TL.build_serving_config(plan=plan))
    arrays = _log_arrays(80, seed=0)
    assert_margin(_TP, _TCFG, arrays, (16, 64, 256), mq_scales=(1.0,))
    prof = dict(plan=plan, group_buckets=(16, 64, 256), batch_groups=32,
                max_queue=128, flush=dict(max_wait_ms=5.0),
                degrade=dict(high_watermark=96, low_watermark=32))
    res, _ = _serve_pair(arrays, qps=400.0, deadline_ms=130.0, seed=0,
                         **prof)
    assert res.completed == 80 and res.shed == 0


@pytest.mark.parametrize("faults,retry", [
    (dict(transient_rate=0.2, corrupt_rate=0.1, poison_rate=0.05, seed=5),
     dict(max_attempts=2, backoff_ms=0.01, breaker_degrade_after=None,
          breaker_open_after=None)),
    (dict(transient_rate=0.6, latency_rate=0.2, latency_spike_ms=3.0,
          seed=9),
     dict(max_attempts=2, backoff_ms=0.01, breaker_degrade_after=2,
          breaker_open_after=4)),
])
def test_fault_replay_matches_reference(faults, retry):
    arrays = serving_arrays(60, seed=2)
    assert_margin(_TP, _TCFG, arrays, (8,))
    res, ses = _serve_pair(arrays, qps=600.0, deadline_ms=40.0,
                           faults=faults, retry=retry)
    st = ses.stats_export()
    assert st["faults"] > 0 and st["retries"] > 0
    assert res.errors > 0 or st["breaker_shed"] > 0


def test_submit_then_flush_matches_reference():
    arrays = serving_arrays(9, seed=4, lo=1, hi=30)
    assert_margin(_TP, _TCFG, arrays, (8, 16))
    kw = dict(group_buckets=(8, 16), batch_groups=4, max_queue=None,
              degrade=dict(high_watermark=None))
    jses = JS.CascadeSession(_JP, _JCFG, scfg=serving_config(JS, **kw))
    tses = TS.CascadeSession(_TP, _TCFG, scfg=serving_config(TS, **kw), device="cpu")
    jf = [jses.submit(r, now_ms=0.0) for r in requests(JB, arrays)]
    tf = [tses.submit(r, now_ms=0.0) for r in requests(TB, arrays)]
    jout, tout = jses.flush(now_ms=1.0), tses.flush(now_ms=1.0)
    assert [r.request_id for r in jout] == [r.request_id for r in tout]
    for a, b in zip(jf, tf):
        assert a.result().truncated == b.result().truncated
        np.testing.assert_array_equal(a.result().order, b.result().order)
        close(b.result().scores, a.result().scores)
    assert jses.stats_export() == tses.stats_export()


# ---------------------------------------------------------------------------
# the session's own contracts
# ---------------------------------------------------------------------------

def test_warmup_runs_every_shape_and_manifest_matches_reference():
    kw = dict(group_buckets=(16, 64, 256), batch_groups=32)
    jses = JS.CascadeSession(_JP, _JCFG, scfg=serving_config(JS, **kw))
    tses = TS.CascadeSession(_TP, _TCFG, scfg=serving_config(TS, **kw), device="cpu")
    assert tses.warmup_manifest() == jses.warmup_manifest()
    shapes = tses.warmup()
    assert len(shapes) == 18
    assert tses.shapes_seen == {(False, b, g) for b, g in shapes}
    assert TL.compiled_count([tses]) == 18
    bad = dict(tses.warmup_manifest(), plan="score")
    with pytest.raises(ValueError, match="does not match"):
        tses.warm_restart(bad)
    with pytest.raises(ValueError, match="version"):
        tses.warm_restart(dict(tses.warmup_manifest(), version=2))


def test_unknown_plan_and_neural_stage_are_refused():
    """An unknown plan, a neural stage whose weights live on another
    device than the session's, and a neural stage of a family the port
    does not carry yet are refused."""
    with pytest.raises(ValueError, match="unknown pipeline plan"):
        TS.CascadeSession(_TP, _TCFG, scfg=serving_config(TS, plan="fused"),
                          device="cpu")
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="neural stage"):
        TS.CascadeSession(_TP, _TCFG, neural_stage=elsewhere, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        TL.build_neural("dbrx-132b", device="cpu")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        TS.CascadeSession(_TP, _TCFG)       # device defaults to "cuda"


# ---------------------------------------------------------------------------
# the launcher's DES path
# ---------------------------------------------------------------------------

def test_launcher_serves_on_cpu_and_reports(tmp_path, capsys):
    report = tmp_path / "serve.json"
    TL.main(["--device", "cpu", "--requests", "60", "--report",
             str(report)])
    out = capsys.readouterr().out
    assert "trained CLOES (L3, beta 5.0)" in out
    assert "recompiles after warmup: 0" in out
    assert "all futures resolved" in out
    rep = json.loads(report.read_text())
    assert rep["recompiles_after_warmup"] == 0
    st = rep["session_stats"]
    assert st["submitted"] == 60 == st["completed"] + st["shed"] \
        + st["errors"]
    assert rep["config"]["device"] == "cpu"


def test_launcher_profile_on_cpu(tmp_path, capsys):
    trace, report = tmp_path / "trace.json", tmp_path / "serve.json"
    TL.main(["--device", "cpu", "--requests", "30", "--plan", "score",
             "--profile", str(trace), "--report", str(report)])
    prof = json.loads(report.read_text())["profile"]
    assert trace.exists() and prof["device_busy_ms"] == 0.0
    assert prof["device_idle_share"] == 1.0
    assert any(op["name"] == "aten::sort" for op in prof["top_host_ops"])
    assert "profile: device busy" in capsys.readouterr().out


def test_launcher_params_npz(tmp_path, capsys):
    path = tmp_path / "cascade.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in
                      __import__("jax").device_get(_JP).items()})
    params = TL.load_params(str(path), _TCFG, device="cpu")
    for k in params:
        assert torch.equal(params[k], _TP[k])
    TL.main(["--device", "cpu", "--requests", "20", "--params", str(path)])
    assert str(path) in capsys.readouterr().out
    np.savez(path, w_x=np.zeros((2, 24)), w_q=np.zeros((2, 8)),
             b=np.zeros(2))
    with pytest.raises(SystemExit, match="do not fit"):
        TL.load_params(str(path), _TCFG, device="cpu")


# ---------------------------------------------------------------------------
# the CascadeServer shim and its RequestBatcher
# ---------------------------------------------------------------------------

def _batcher_req(mod, i, n_items, d_x=24, d_q=8, seed=None):
    """tests/test_serving_batching.py's `_req`."""
    rng = np.random.default_rng(n_items if seed is None else seed)
    return mod.RankRequest(request_id=i,
                           q_feat=np.eye(d_q)[i % d_q].astype(np.float32),
                           item_feats=rng.normal(size=(n_items, d_x))
                           .astype(np.float32),
                           m_q=10 * n_items + 1)


def test_batcher_drain_and_pack_requests_byte_equal_reference():
    sizes = [1, 3, 15, 16, 17, 63, 64, 65, 255, 256, 300, 4, 40, 200]
    jb = JB.RequestBatcher(batch_groups=8, group_buckets=(16, 64, 256))
    tb = TB.RequestBatcher(batch_groups=8, group_buckets=(16, 64, 256))
    for i, n in enumerate(sizes):
        jb.submit(_batcher_req(JB, i, n, d_x=6, d_q=4))
        tb.submit(_batcher_req(TB, i, n, d_x=6, d_q=4))
    assert len(tb) == len(sizes)
    jout, tout = list(jb.drain()), list(tb.drain())
    assert len(tb) == 0 and len(jout) == len(tout) == 3
    for (jseq, jreqs, jbatch), (tseq, treqs, tbatch) in zip(jout, tout):
        assert jseq == tseq
        assert [r.request_id for r in jreqs] == [r.request_id for r in treqs]
        assert set(jbatch) == set(tbatch)
        for k in jbatch:
            assert jbatch[k].shape == tbatch[k].shape
            assert jbatch[k].tobytes() == tbatch[k].tobytes()
    for n_reqs, g, bg in ((1, 16, 32), (3, 64, 32), (4, 8, 4), (7, 256, 8)):
        jr = [_batcher_req(JB, i, 3 * i + 1, seed=i) for i in range(n_reqs)]
        tr = [_batcher_req(TB, i, 3 * i + 1, seed=i) for i in range(n_reqs)]
        want, got = JB.pack_requests(jr, g, bg), TB.pack_requests(tr, g, bg)
        for k in want:
            assert want[k].tobytes() == got[k].tobytes(), (n_reqs, g, k)


def _servers(fused="filter", buckets=(8, 16), batch_groups=4):
    jsrv = JCS.CascadeServer(_JP, _JCFG, JLoss.LossConfig(), fused=fused,
                             batcher=JB.RequestBatcher(
                                 batch_groups=batch_groups,
                                 group_buckets=buckets))
    tsrv = TCS.CascadeServer(_TP, _TCFG, TLoss.LossConfig(), fused=fused,
                             batcher=TB.RequestBatcher(
                                 batch_groups=batch_groups,
                                 group_buckets=buckets), device="cpu")
    return jsrv, tsrv


@pytest.mark.parametrize("fused", ["filter", "score"])
def test_server_serves_in_submit_order_like_reference(fused):
    jsrv, tsrv = _servers(fused=fused)
    rng = np.random.default_rng(3)
    sizes = [12, 3, 16, 2, 9, 5, 11, 4, 7]
    seeds = [int(rng.integers(1 << 20)) for _ in sizes]
    arrays = [(i, np.eye(8)[i % 8].astype(np.float32),
               _batcher_req(TB, i, n, seed=sd).item_feats, 10 * n + 1)
              for i, (n, sd) in enumerate(zip(sizes, seeds))]
    assert_margin(_TP, _TCFG, arrays, (8, 16), mq_scales=(1.0,))
    for i, (n, sd) in enumerate(zip(sizes, seeds)):
        jsrv.submit(_batcher_req(JB, i, n, seed=sd))
        tsrv.submit(_batcher_req(TB, i, n, seed=sd))
    jout, tout = jsrv.serve(), tsrv.serve()
    assert [r.request_id for r in tout] == list(range(len(sizes)))
    for a, b, n in zip(jout, tout, sizes):
        assert len(b.scores) == n and b.status == "ok"
        np.testing.assert_array_equal(a.order, b.order)
        np.testing.assert_array_equal(a.survivors, b.survivors)
        assert a.stage_counts == b.stage_counts
        close(b.scores, a.scores)
        close(b.est_latency_ms, a.est_latency_ms)
    assert jsrv.session.stats_export() == tsrv.session.stats_export()


def test_server_rejects_unknown_fused_mode_at_construction():
    with pytest.raises(ValueError, match="unknown pipeline plan: 'scores'"):
        _servers(fused="scores")


@pytest.mark.parametrize("legacy, plan", [(True, "filter"), (False, "none")])
def test_use_fused_kernel_is_deprecated_but_aliases_the_plan(legacy, plan):
    with pytest.warns(DeprecationWarning, match="use_fused_kernel"):
        srv = TCS.CascadeServer(_TP, _TCFG, use_fused_kernel=legacy,
                                device="cpu")
    assert srv.fused == plan and srv.session.scfg.plan == plan
    assert srv.use_fused_kernel is legacy
    with pytest.warns(DeprecationWarning):
        srv2 = TCS.CascadeServer(_TP, _TCFG, use_fused_kernel=legacy,
                                 fused="score", device="cpu")
    assert srv2.fused == "score"
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("error")
        TCS.CascadeServer(_TP, _TCFG, fused=plan, device="cpu")


def test_server_warmup_runs_each_shape_once_no_new_shape_in_serve():
    jsrv, tsrv = _servers(buckets=(8, 16), batch_groups=4)
    assert tsrv.session.shapes_seen == set()
    shapes = tsrv.warmup()
    assert shapes == jsrv.warmup()
    assert sorted(shapes) == sorted((b, g) for g in (8, 16)
                                    for b in (1, 2, 4))
    assert tsrv.session.shapes_seen == {(False, b, g) for b, g in shapes}
    assert tsrv._rank is tsrv.session._rank
    out = tsrv.session.fetch(tsrv.rank_batch(
        TB.pack_requests([_batcher_req(TB, 0, 5)], 8, 4)))
    assert out["scores"].shape == (1, 8)
    for round_ in range(2):
        for i, n in enumerate([2, 8, 13, 16, 5]):
            tsrv.submit(_batcher_req(TB, i, n))
        assert len(tsrv.serve()) == 5
        assert tsrv.session.shapes_seen == {(False, b, g)
                                            for b, g in shapes}, round_


# ---------------------------------------------------------------------------
# the launcher's wall-clock, router and chaos paths; no card, no serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--pump"], ["--replicas", "2",
                                                "--kill-replica"],
                                   ["--faults", "0.2"],
                                   ["--pump", "--faults", "0.2"]],
                         ids=lambda f: " ".join(f))
def test_launcher_pump_router_and_faults_on_cpu(flags, tmp_path, capsys):
    report = tmp_path / "serve.json"
    TL.main(["--device", "cpu", "--requests", "40", "--report",
             str(report)] + flags)
    out = capsys.readouterr().out
    assert "all futures resolved" in out
    assert "recompiles after warmup: 0" in out
    rep = json.loads(report.read_text())
    st = rep["session_stats"]           # the fleet's, under a router
    assert st["submitted"] == st["completed"] + st["shed"] + st["errors"]
    assert rep["recompiles_after_warmup"] == 0
    summary = rep["wall_clock" if "--pump" in flags else "open_loop"]
    assert summary["unresolved"] == 0
    assert summary["completed"] + summary["shed"] + summary["errors"] == 40
    # a router's probes are submitted on top of the callers' requests
    assert st["submitted"] == 40 + rep.get("router_stats",
                                           {}).get("probes", 0)
    assert rep["config"]["mode"] == ("pump" if "--pump" in flags else "des")
    if "--pump" in flags:
        assert rep["pump_stats"]["cycles"] > 0
        assert rep["pump_stats"]["cycle_errors"] == 0
        assert rep["pump_stats"]["running"] is False
    if "--kill-replica" in flags:
        router = rep["router_stats"]
        assert router["failovers"] >= 1 and router["failed"] == [0]
        assert sum(r["drained"] for r in router["replicas"]) \
            == sum(r["adopted"] for r in router["replicas"])
        assert "replica0:" in out and "FORCED DEAD" in out
    if "--faults" in flags:
        assert "CHAOS MODE" in out
        assert sum(st["injected"].values()) > 0


def test_launcher_refuses_inconsistent_flags():
    with pytest.raises(SystemExit, match="--replicas >= 2"):
        TL.main(["--device", "cpu", "--kill-replica"])
    with pytest.raises(SystemExit, match="single-session"):
        TL.main(["--device", "cpu", "--pump", "--profile", "t.json"])


def test_cuda_pump_and_launcher_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        SessionPump(TS.CascadeSession(_TP, _TCFG))
    with pytest.raises((AssertionError, RuntimeError)):
        TCS.CascadeServer(_TP, _TCFG)           # device defaults to "cuda"
    for flags in (["--pump"], ["--replicas", "2"]):
        with pytest.raises((AssertionError, RuntimeError)):
            TL.main(["--requests", "5"] + flags)
