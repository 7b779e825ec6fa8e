"""The cascade's neural final stage in the port, on the CPU, against the
reference: `NeuralScorer` (tokenizer and scores) with the reference's
weights carried over, and the CascadeSession with a neural stage under the
virtual-clock DES with an injected service clock (the pattern of
tests/test_determinism.py) — statuses, flags (skip_neural included),
orders and accounting equal, scores within tolerance — plus the warmup
manifest's degraded pipeline and the launcher's `--neural`.

Tolerances: neural scores rtol 1e-4 / atol 1e-7 (two float32 layers and a
mean-pool, summed in another order; the scores are ~1e-2); the session's
scores and latencies as in tests/test_torch_serving.py (rtol 1e-5 /
atol 1e-6)."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.serving import batching as JB
from repro.serving import session as JS
from repro.serving.cascade_server import NeuralScorer as JNeural
from repro.serving.loadgen import run_open_loop as j_run
from repro_torch.launch import serve as TLS
from repro_torch.models import base as TMB
from repro_torch.models import zoo as TZ
from repro_torch.serving import batching as TB
from repro_torch.serving import session as TS
from repro_torch.serving.cascade_server import NeuralScorer as TNeural
from repro_torch.serving.loadgen import run_open_loop as t_run
from torch_parity import (FakeTimer, assert_margin, assert_same_serve,
                          cascades, close, dense_model, exact, n, requests,
                          serving_arrays, serving_config)

_JP, _TP, _JCFG, _TCFG = cascades()


def _scorers(arch="gemma3-27b", seed=3):
    """The reference's NeuralScorer and the port's with the same weights."""
    jcfg, tcfg, _, _ = dense_model(arch)
    js = JNeural.create(jcfg, jax.random.PRNGKey(seed))
    tp = TZ.params_from_numpy(jax.device_get(js.params), tcfg, device="cpu")
    return js, TNeural(cfg=tcfg, params=tp, head=exact(js.head))


_JN, _TN = _scorers()


@pytest.mark.parametrize("arch", ["gemma3-27b", "starcoder2-3b"])
@pytest.mark.parametrize("d_x", [24, 5])
def test_scorer_matches_reference(arch, d_x):
    js, ts = (_JN, _TN) if arch == "gemma3-27b" else _scorers(arch)
    feats = 1.5 * np.random.default_rng(d_x).normal(size=(37, d_x)).astype(
        np.float32)
    np.testing.assert_array_equal(n(ts.tokenize(torch.from_numpy(feats))),
                                  np.asarray(js.tokenize(feats)))
    close(ts.score(torch.from_numpy(feats)), js.score(feats), 1e-4, 1e-7)


def test_create_draws_on_the_device_from_a_seed():
    cfg = _TN.cfg
    a = TNeural.create(cfg, 7, device="cpu")
    b = TNeural.create(cfg, 7, device="cpu")
    assert a.device == torch.device("cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        TMB.tree_leaves(a.params), TMB.tree_leaves(b.params)))
    assert torch.equal(a.head, b.head)
    assert a.head.abs().max().item() < 0.02         # 0.002 * N(0, 1)
    assert np.isfinite(n(a.score(torch.randn(4, 24)))).all()


def _serve_pair(arrays, qps, deadline_ms, seed=3, **kw):
    jses = JS.CascadeSession(_JP, _JCFG, neural_stage=_JN,
                             scfg=serving_config(JS, **kw))
    tses = TS.CascadeSession(_TP, _TCFG, neural_stage=_TN,
                             scfg=serving_config(TS, **kw), device="cpu")
    jres = j_run(jses, requests(JB, arrays), qps, deadline_ms=deadline_ms,
                 seed=seed, timer=FakeTimer())
    tres = t_run(tses, requests(TB, arrays), qps, deadline_ms=deadline_ms,
                 seed=seed, timer=FakeTimer())
    assert tres.unresolved == 0
    assert_same_serve(jres, tres, jses, tses)
    return tres, tses


def test_session_with_neural_stage_matches_reference():
    arrays = serving_arrays(30, seed=5)
    assert_margin(_TP, _TCFG, arrays, (8,))
    res, ses = _serve_pair(arrays, qps=150.0, deadline_ms=None,
                           degrade=dict(high_watermark=None))
    assert res.completed == 30 and res.degraded == 0
    for f in res.futures:
        r = f.result()
        assert np.isfinite(r.scores[r.survivors]).all()
        assert np.isneginf(r.scores[~r.survivors]).all()
        assert r.est_latency_ms > 0


def test_skip_neural_degrade_matches_reference():
    arrays = serving_arrays(60, seed=2)
    assert_margin(_TP, _TCFG, arrays, (8,))
    res, ses = _serve_pair(arrays, qps=1200.0, deadline_ms=40.0)
    skipped = [f.result() for f in res.futures
               if "skip_neural" in f.result().degraded]
    assert skipped and res.shed > 0
    assert ses.stats_export()["degrade_enters"] > 0


def test_warmup_manifest_has_the_degraded_pipeline():
    kw = dict(group_buckets=(8, 16), batch_groups=4)
    jses = JS.CascadeSession(_JP, _JCFG, neural_stage=_JN,
                             scfg=serving_config(JS, **kw))
    tses = TS.CascadeSession(_TP, _TCFG, neural_stage=_TN,
                             scfg=serving_config(TS, **kw), device="cpu")
    manifest = tses.warmup_manifest()
    assert manifest == jses.warmup_manifest()
    assert manifest["degraded_pipeline"] is True
    shapes = tses.warmup()
    assert tses.shapes_seen == {(skip, b, g) for b, g in shapes
                                for skip in (False, True)}
    # a manifest without the degraded pipeline warms the normal one only
    cold = TS.CascadeSession(_TP, _TCFG, neural_stage=_TN,
                             scfg=serving_config(TS, **kw), device="cpu")
    cold.warm_restart(dict(manifest, degraded_pipeline=False))
    assert {skip for skip, _, _ in cold.shapes_seen} == {False}
    # no skip_neural degrade: one pipeline, as without a neural stage
    one = TS.CascadeSession(
        _TP, _TCFG, neural_stage=_TN, device="cpu",
        scfg=serving_config(TS, degrade=dict(high_watermark=6,
                                             skip_neural=False), **kw))
    assert one.warmup_manifest()["degraded_pipeline"] is False


def test_launcher_serves_with_neural_stage_on_cpu(tmp_path, capsys):
    report = tmp_path / "serve.json"
    TLS.main(["--device", "cpu", "--requests", "20", "--neural",
              "gemma3-27b", "--report", str(report)])
    out = capsys.readouterr().out
    assert "neural final stage: gemma3-smoke" in out
    assert "recompiles after warmup: 0" in out
    rep = json.loads(report.read_text())
    assert rep["config"]["neural"] == "gemma3-27b"
    st = rep["session_stats"]
    assert st["submitted"] == 20 == st["completed"] + st["shed"] \
        + st["errors"]
