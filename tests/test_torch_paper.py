"""The paper's evaluation on the port (`repro_torch.paper`), the examples
(`repro_torch.examples`) and the seeded init they start from
(`repro_torch.core.prng`), against the JAX reference on the CPU.

Tolerances:
  * `prng.split`, `random_bits` and `uniform` bit for bit; `normal` and
    `reference_init` within 3 float32 ulp (the log1p inside erfinv is
    numpy's here and XLA's own approximation there; measured, most draws
    equal);
  * a fit from the default init against the reference's default fit: the
    loss trajectory rtol/atol 1e-5, params rtol 1e-4 / atol 1e-5 (the
    bars of tests/test_torch_trainer.py);
  * the suites' numbers against the reference's helpers on the same
    params: AUC within 1e-4 absolute; cost, latency, expected counts and
    utilisation within 1e-4 relative (float32 sums in another order);
    the simulated session's outputs exactly on identical scores and
    latencies, and Fig 5's served / shed counts exactly on a fixed
    service clock (they depend on no float the packages compute apart).

The reference's suites (`benchmarks/`) and examples are imported from the
repository root as the oracle; the port imports none of them."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import cascade as JC
from repro.core import losses as JL
from repro.core import metrics as JM
from repro.core import trainer as JT
from repro.data import LogConfig as JLogConfig
from repro.data import generate_log as jgenerate_log
from repro.serving import loadgen as JLG
from repro.serving import router as JR
from repro.serving import session as JS
from repro.serving.batching import RankRequest as JRankRequest
from repro_torch.core import losses as TL
from repro_torch.core import metrics as TM
from repro_torch.core import prng
from repro_torch.core import trainer as TT
from repro_torch.data import LogConfig, generate_log
from repro_torch.paper import MODULES, common
from repro_torch.paper import fig3_uninstall as F3
from repro_torch.paper import fig4_user_experience as F4
from repro_torch.paper import fig5_peak_load as F5
from repro_torch.paper import table3_offline as T3
from repro_torch.paper import table4_importance as T4
from torch_parity import cascades, close, one_cpu_thread

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:          # the reference's suites, as oracle
    sys.path.insert(0, str(REPO))
from benchmarks import fig3_uninstall as JF3  # noqa: E402
from benchmarks import fig4_user_experience as JF4  # noqa: E402
from benchmarks import fig5_peak_load as JF5  # noqa: E402
from benchmarks import table4_importance as JT4  # noqa: E402

ULP = 3
TRAJ_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
AUC_TOL = 1e-4
REL_TOL = 1e-4
SMALL = dict(n_queries=240, items_per_query=32, seed=5)


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# The seeded init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_split_matches_jax_bit_for_bit(seed, n):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(prng.prng_key(seed), np.asarray(key))
    got = prng.split(prng.prng_key(seed), n)
    assert got.dtype == np.uint32
    assert np.array_equal(got, np.asarray(jax.random.split(key, n)))


@pytest.mark.parametrize("shape", [(3, 24), (1000,), (2, 3, 5)])
def test_bits_uniform_exact_and_normal_within_ulp(shape):
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        k = prng.prng_key(seed)
        assert np.array_equal(prng.random_bits(k, shape),
                              np.asarray(jax.random.bits(key, shape)))
        assert np.array_equal(prng.uniform(k, shape),
                              np.asarray(jax.random.uniform(key, shape)))
        got = prng.normal(k, shape)
        assert got.dtype == np.float32 and got.shape == shape
        assert _ulps(got, jax.random.normal(key, shape)).max() <= ULP


@pytest.mark.parametrize("t_stages", [1, 3, 8])
def test_reference_init_matches_jax_init_params(t_stages):
    jcfg = JC.CascadeConfig(t_stages, 24, 8, np.ones((t_stages, 24)),
                            np.ones(t_stages))
    for seed in (0, 42):
        want = jax.device_get(JC.init_params(jcfg, jax.random.PRNGKey(seed)))
        got = prng.reference_init(jcfg, seed)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32
            assert _ulps(got[k], want[k]).max() <= ULP, k
        assert not got["b"].any()


@pytest.fixture(scope="module")
def fit_logs():
    """(port train log, reference train log): 200 queries of 16 items."""
    cfg = dict(n_queries=200, items_per_query=16, seed=3)
    tr, _ = generate_log(LogConfig(**cfg)).split(0.8)
    jtr, _ = jgenerate_log(JLogConfig(**cfg)).split(0.8)
    return tr, jtr


@pytest.mark.parametrize("loss", ["l1", "l3"])
def test_default_init_fit_matches_reference_default_fit(fit_logs, loss):
    """No init_params on either side: the seed alone starts both fits at
    the same weights."""
    tr, jtr = fit_logs
    _, _, jcfg, tcfg = cascades(3)
    kw = dict(loss=loss, epochs=2, lr=0.05, batch_groups=16, log_every=1,
              seed=11)
    j_losses, t_losses = [], []
    jp = JT.fit(jtr, jcfg, JL.LossConfig(beta=2.0), JT.TrainConfig(**kw),
                callback=lambda s, v: j_losses.append(v))
    tp = TT.fit(tr, tcfg, TL.LossConfig(beta=2.0), TT.TrainConfig(**kw),
                callback=lambda s, v: t_losses.append(v), device="cpu")
    assert len(t_losses) == len(j_losses) == 20
    close(t_losses, j_losses, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for k, v in jax.device_get(jp).items():
        close(tp[k], v, rtol=PARAM_RTOL, atol=PARAM_ATOL)


# ---------------------------------------------------------------------------
# The suites against the reference's helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """(port split, reference split) of a 240 x 32 log; byte-identical."""
    split = generate_log(LogConfig(**SMALL)).split(0.8, seed=0)
    jsplit = jgenerate_log(JLogConfig(**SMALL)).split(0.8, seed=0)
    assert np.array_equal(split[1].x, jsplit[1].x)
    return split, jsplit


@pytest.fixture(scope="module")
def fitted(small):
    """A CLOES(beta=5) fit of the port on the CPU, and the same params,
    config and loss config in the reference's types."""
    split, _ = small
    with one_cpu_thread():
        params, cfg, lcfg = common.trained_cloes(split, "cpu", beta=5.0)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jcfg = cascades(3)[2]
    assert jcfg.masks == cfg.masks and jcfg.stage_times == cfg.stage_times
    jlcfg = JL.LossConfig(**dataclasses.asdict(lcfg))
    return (params, cfg, lcfg), (jparams, jcfg, jlcfg)


def _rel(got, want, tol=REL_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=0)


def test_simulate_session_exact_on_identical_inputs(small):
    _, (_, jte) = small
    rng = np.random.default_rng(0)
    scores = rng.normal(size=jte.x.shape[:2]).astype(np.float32)
    scores[rng.random(scores.shape) < 0.3] = -np.inf
    lat = rng.uniform(20, 250, jte.x.shape[0])
    for seed in (0, 4):
        assert TM.simulate_session(scores, jte.relevance, jte.price,
                                   jte.mask, lat, seed=seed) == \
            JM.simulate_session(scores, jte.relevance, jte.price, jte.mask,
                                lat, seed=seed)


def test_table4_online_metrics_match_reference(small, fitted):
    (_, te), (_, jte) = small
    (p, cfg, lcfg), (jp, jcfg, jlcfg) = fitted
    scores, lat = T4._online_inputs(p, cfg, lcfg, te)
    x, q, mask, m_q = (jnp.asarray(a, jnp.float32)
                       for a in (jte.x, jte.q, jte.mask, jte.m_q))
    res = JC.hard_cascade_filter(jp, jcfg, x, q, mask, m_q)
    keep = np.asarray(res["survivors"][..., -1]) > 0
    assert np.array_equal(np.isfinite(scores), keep)
    close(scores[keep], np.asarray(res["scores"])[keep])
    _rel(lat, JL.expected_latency_per_query(jp, jcfg, jlcfg, x, q, mask, m_q))
    want = JT4._online_metrics(jp, jcfg, jlcfg, jte)
    assert T4._online_metrics(p, cfg, lcfg, te) == want


def test_fig3_latencies_match_reference(small, fitted):
    (_, te), (_, jte) = small
    (p, cfg, lcfg), (jp, jcfg, jlcfg) = fitted
    idx = np.random.default_rng(1).choice(te.x.shape[0], 20, replace=False)
    _rel(F3._latency(p, cfg, lcfg, te, idx),
         JF3._latency(jp, jcfg, jlcfg, jte, idx))
    _rel(F3._two_stage_latency(te, idx), JF3._two_stage_latency(jte, idx),
         tol=1e-12)


def test_fig4_per_query_matches_reference(small, fitted):
    (_, te), (_, jte) = small
    (p, cfg, lcfg), (jp, jcfg, jlcfg) = fitted
    counts, lat, sess = F4._per_query(p, cfg, lcfg, te)
    jcounts, jlat, jsess = JF4._per_query(jp, jcfg, jlcfg, jte)
    _rel(counts, jcounts)
    _rel(lat, jlat)
    assert sess == jsess


def test_fig5_costs_match_reference(small, fitted):
    (_, te), (_, jte) = small
    (p, cfg, _), (jp, jcfg, _) = fitted
    _rel(F5._cost_per_query(p, cfg, te), JF5._cost_per_query(jp, jcfg, jte))
    assert F5._two_stage_cost(te) == JF5._two_stage_cost(jte)


def _j_reqs(jte, n, seed):
    picks = np.random.default_rng(seed).integers(0, jte.x.shape[0], n)
    return [JRankRequest(request_id=i, q_feat=jte.q[qi].astype(np.float32),
                         item_feats=jte.x[qi].astype(np.float32),
                         m_q=int(jte.m_q[qi]))
            for i, qi in enumerate(picks)]


@pytest.mark.parametrize("us_chunk", [
    2000.0, pytest.param(9000.0, marks=pytest.mark.slow)])
def test_fig5_des_counts_match_reference_on_fixed_clock(small, fitted,
                                                        us_chunk):
    """The session sweep and the 1- / 2-replica router sweep, each chunk
    costing `us_chunk` on both sides: served and shed counts equal."""
    (_, te), (_, jte) = small
    (p, cfg, lcfg), (jp, jcfg, jlcfg) = fitted
    g, bg = te.x.shape[1], F5.BATCH_GROUPS
    cap_qps = bg / (us_chunk / 1e6)
    sweep = F5.session_sweep(p, cfg, lcfg, te, "cpu", cap_qps,
                             timer=lambda: F5.FixedTimer(us_chunk / 1e6))
    for mult in F5.LOAD_MULTS:
        ses = JS.CascadeSession(jp, jcfg, jlcfg, scfg=JS.ServingConfig(
            plan="filter", group_buckets=(g,), batch_groups=bg,
            max_queue=4 * bg, flush=JS.FlushPolicy(max_wait_ms=5.0),
            degrade=JS.DegradePolicy(high_watermark=2 * bg,
                                     low_watermark=bg // 2)))
        ses.warmup()
        want = JLG.run_open_loop(ses, _j_reqs(jte, F5.SWEEP_REQUESTS, 17),
                                 mult * cap_qps, deadline_ms=None, seed=3,
                                 timer=F5.FixedTimer(us_chunk / 1e6))
        got = sweep[mult]
        assert (got.completed, got.shed, got.degraded, got.unresolved) == \
            (want.completed, want.shed, want.degraded, want.unresolved)
    for n in (1, 2):
        got, gstats = F5.router_run(p, cfg, lcfg, te, "cpu", n,
                                    F5.ROUTER_MULT * cap_qps,
                                    timer=F5.FixedTimer(us_chunk / 1e6))
        scfg = JS.ServingConfig(
            plan="filter", group_buckets=(g,), batch_groups=bg,
            max_queue=4 * bg * n, flush=JS.FlushPolicy(max_wait_ms=5.0),
            degrade=JS.DegradePolicy(high_watermark=None))
        rt = JR.ReplicaRouter(JR.make_replicas(jp, jcfg, jlcfg, n,
                                               scfg=scfg))
        rt.warmup()
        want = JLG.run_open_loop_router(
            rt, _j_reqs(jte, F5.ROUTER_REQUESTS, 29),
            F5.ROUTER_MULT * cap_qps, seed=5,
            timer=F5.FixedTimer(us_chunk / 1e6))
        assert (got.completed, got.shed, got.unresolved) == \
            (want.completed, want.shed, want.unresolved)
        assert gstats["submitted"] == F5.ROUTER_REQUESTS


def test_fig5_fixed_clock_sweeps_repeat(small, fitted):
    """Fig 5's claimed session sweep runs on the calibrated fixed clock:
    two sweeps from the same seed shed the same requests at every load
    (on the real clock they need not, the machine's load moving between
    them)."""
    (_, te), _ = small
    p, cfg, lcfg = fitted[0]
    us_chunk = 2000.0
    cap_qps = F5.BATCH_GROUPS / (us_chunk / 1e6)
    a, b = (F5.session_sweep(p, cfg, lcfg, te, "cpu", cap_qps,
                             timer=lambda: F5.FixedTimer(us_chunk / 1e6))
            for _ in range(2))
    assert {m: (r.shed, r.completed, r.degraded) for m, r in a.items()} \
        == {m: (r.shed, r.completed, r.degraded) for m, r in b.items()}
    assert a[4.0].shed > 0


def _reference_table3(jsplit):
    """The reference's Table 3 (benchmarks/table3_offline.run) on jsplit,
    recomposed from repro.core: {algo: (train AUC, test AUC, cost)}."""
    tr, te = jsplit
    l1 = JT.TrainConfig(loss="l1", epochs=6, lr=0.01)
    out = {}
    cfg = JB.single_stage_all_features()
    p = JT.fit(tr, cfg, JL.LossConfig(), l1)
    r = JT.evaluate(p, cfg, te)
    base = r["expected_cost_per_item"]
    out["single_stage_all"] = (JT.evaluate(p, cfg, tr)["auc"], r["auc"], 1.0)
    cfg = JB.single_stage_simple_features()
    p = JT.fit(tr, cfg, JL.LossConfig(), l1)
    r = JT.evaluate(p, cfg, te)
    out["single_stage_simple"] = (JT.evaluate(p, cfg, tr)["auc"], r["auc"],
                                  r["expected_cost_per_item"] / base)
    ts = JB.fit_two_stage(tr, tcfg=l1)
    r = JB.eval_two_stage(ts, te)
    out["two_stage_6000"] = (JB.eval_two_stage(ts, tr)["auc"], r["auc"],
                             r["expected_cost_per_item"] / base)
    p, cfg = JB.fit_soft_cascade(tr, tcfg=l1)
    r = JT.evaluate(p, cfg, te)
    out["soft_cascade_L1"] = (JT.evaluate(p, cfg, tr)["auc"], r["auc"],
                              r["expected_cost_per_item"] / base)
    for beta in (1.0, 10.0):
        p, cfg = JB.fit_cloes(tr, lcfg=JL.LossConfig(beta=beta),
                              tcfg=JT.TrainConfig(loss="l3", epochs=6,
                                                  lr=0.01))
        r = JT.evaluate(p, cfg, te)
        out[f"CLOES_beta{int(beta)}"] = (JT.evaluate(p, cfg, tr)["auc"],
                                         r["auc"],
                                         r["expected_cost_per_item"] / base)
    return out


def test_table3_rows_match_reference(small):
    """Six default-init fits per package on the same log: the rows agree."""
    split, jsplit = small
    with one_cpu_thread():
        rows = T3.rows(split, "cpu")
    want = _reference_table3(jsplit)
    assert [r["algo"] for r in rows] == list(want)
    for r in rows:
        w_tr, w_te, w_cost = want[r["algo"]]
        assert abs(r["train_auc"] - w_tr) <= AUC_TOL, r["algo"]
        assert abs(r["test_auc"] - w_te) <= AUC_TOL, r["algo"]
        _rel(r["cost"], w_cost)
    assert len(T3.claims(rows)) == 4


@pytest.mark.slow
def test_all_suites_claims_hold_at_ci_scale_on_cpu():
    """The reference's five suites' claims, on the port at the reference's
    benchmark scale (1,200 x 64), on the CPU."""
    split = common.bench_split("ci")
    assert split[0].n_instances + split[1].n_instances == 39028
    import importlib
    with one_cpu_thread():
        for name, module in MODULES.items():
            run = importlib.import_module(f"repro_torch.paper.{module}").run
            res = common.run_suite(name, run, split, "cpu")
            assert res.claims and not res.failed, (name, res.claims)
    common.clear_fits()


def test_table3_claims_detect_a_violation():
    rows = [{"algo": a, "train_auc": 0.8, "test_auc": auc, "cost": cost}
            for a, auc, cost in (("single_stage_all", 0.85, 1.0),
                                 ("single_stage_simple", 0.7, 0.02),
                                 ("two_stage_6000", 0.9, 0.3),
                                 ("soft_cascade_L1", 0.8, 0.4),
                                 ("CLOES_beta1", 0.8, 0.1),
                                 ("CLOES_beta10", 0.7, 0.2))]
    held = {n: h for n, h, _ in T3.claims(rows)}
    assert held == {"single_stage_all_best_test_auc": False,
                    "single_stage_simple_cheapest": True,
                    "cloes_beta1_dominates_two_stage": False,
                    "cloes_beta10_cheaper_than_beta1": False}


# ---------------------------------------------------------------------------
# The examples and the command lines
# ---------------------------------------------------------------------------

def test_quickstart_rows_match_reference():
    from repro_torch.examples import quickstart
    with one_cpu_thread():
        rows = quickstart.main(["--device", "cpu", "--queries", "200",
                                "--epochs", "2"])
    tr, te = jgenerate_log(JLogConfig(n_queries=200, seed=0)).split(0.8)
    cfg = JB.single_stage_all_features()
    p = JT.fit(tr, cfg, JL.LossConfig(),
               JT.TrainConfig(loss="l1", epochs=2, lr=0.01))
    r = JT.evaluate(p, cfg, te)
    base = r["expected_cost_per_item"]
    assert abs(rows["single_all"]["auc"] - r["auc"]) <= AUC_TOL
    for beta in (1.0, 10.0):
        p, ccfg = JB.fit_cloes(tr, lcfg=JL.LossConfig(beta=beta),
                               tcfg=JT.TrainConfig(loss="l3", epochs=2,
                                                   lr=0.01))
        r = JT.evaluate(p, ccfg, te, JL.LossConfig(beta=beta))
        got = rows[f"cloes_beta{beta:g}"]
        assert abs(got["auc"] - r["auc"]) <= AUC_TOL
        _rel(got["cost"], r["expected_cost_per_item"] / base)
        _rel(got["p95_latency"], r["p95_expected_latency"])


def test_train_ranker_runs_on_cpu():
    from repro_torch.examples import train_ranker
    out = train_ranker.main(["--device", "cpu", "--steps", "4", "--batch",
                             "8", "--queries", "120"])
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["accuracy"] <= 1.0


@pytest.mark.parametrize("extra", [
    pytest.param([], id="des"),
    pytest.param(["--pump"], id="pump", marks=pytest.mark.slow),
    pytest.param(["--chaos", "--replicas", "2"], id="chaos-replicas",
                 marks=pytest.mark.slow)])
def test_cascade_serving_runs_on_cpu(extra):
    from repro_torch.examples import cascade_serving
    out = cascade_serving.main(["--device", "cpu", "--requests", "24",
                                "--queries", "120", *extra])
    res = out["result"]
    assert all(f.done() for f in res.futures)
    assert len(res.futures) == 24
    if "--replicas" in extra:
        g = out["router"]["global"]
        assert g["submitted"] == g["completed"] + g["shed"] + g["errors"]
        assert out["chaos"] is not None


@pytest.mark.parametrize("module", ["repro_torch.paper",
                                    "repro_torch.paper.table3_offline",
                                    "repro_torch.examples.quickstart"])
def test_entry_points_refuse_to_run_without_a_card(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", module], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "table3/" not in out.stdout and "AUC" not in out.stdout


def test_paper_and_examples_import_no_reference():
    forbidden = re.compile(r"^\s*(from|import)\s+(jax|repro|benchmarks)"
                           r"(\.|\s|$)", re.MULTILINE)
    port = REPO / "src" / "repro_torch"
    files = sorted((port / "paper").glob("*.py")) + \
        sorted((port / "examples").glob("*.py"))
    # 8 of paper/, 5 of examples/ (multi_pod_dryrun.py since the pod dry run)
    assert len(files) == 13
    for f in files:
        assert not forbidden.search(f.read_text()), f


def test_trained_cloes_is_cached_per_split_device_and_arguments(small):
    split, _ = small
    with one_cpu_thread():
        a = common.trained_cloes(split, "cpu", beta=5.0)
        b = common.trained_cloes(split, torch.device("cpu"), beta=5.0)
    assert a is b
    assert common.SCALES["ci"] == LogConfig(n_queries=1200,
                                            items_per_query=64, seed=42)
    assert common.SCALES["paper"] == LogConfig(n_queries=61500,
                                               items_per_query=64, seed=42)
