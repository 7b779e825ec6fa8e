"""The port's serving slice against the reference on the CPU: batching,
the seeded fault injector, and the whole session under the virtual-clock
open-loop DES with an injected service clock (the pattern of
tests/test_determinism.py). On the same requests and params, every
response's status, order, survivors, flags, stage counts and timings, the
run summary and stats_export() must be equal; scores and latency
estimates within tolerance. Also the launcher's DES path."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro.launch import serve as JL
from repro.serving import batching as JB
from repro.serving import faults as JF
from repro.serving import session as JS
from repro.serving.loadgen import run_open_loop as j_run
from repro_torch.data import LogConfig, generate_log
from repro_torch.launch import serve as TL
from repro_torch.serving import batching as TB
from repro_torch.serving import faults as TF
from repro_torch.serving import session as TS
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
