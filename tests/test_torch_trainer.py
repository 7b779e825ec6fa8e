"""The port's trainer (`repro_torch.core.trainer`), baselines, metrics and
training launcher against the JAX reference on the CPU.

Both packages fit the same log (the synthetic log is byte-identical) from
the same initial weights — the reference's `jax.random` init, handed to the
port's `fit(init_params=...)` — and visit the same minibatches (the host
permutations are the same numpy stream).

Tolerances: loss trajectories rtol/atol 1e-5 and final params rtol 1e-4 /
atol 1e-5 — the reference's own bar between its loop and scan engines
(tests/test_train_engine.py); float32 sums are taken in another order each
step, and 20 momentum steps carry the difference forward. Offline metrics
of the same params: rtol/atol 1e-6.
"""

import dataclasses
import hashlib

import jax
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
from repro_torch.core import baselines as TB
from repro_torch.core import losses as TL
from repro_torch.core import metrics as TM
from repro_torch.core import trainer as TT
from repro_torch.data import LogConfig, generate_log
from repro_torch.launch import train as TLT
from torch_parity import cascades, close, n

TRAJ_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def logs():
    """(port log, reference log): 200 queries of 16 items, 80/20 split."""
    cfg = dict(n_queries=200, items_per_query=16, seed=3)
    tr, te = generate_log(LogConfig(**cfg)).split(0.8)
    jtr, jte = jgenerate_log(JLogConfig(**cfg)).split(0.8)
    assert np.array_equal(tr.x, jtr.x) and np.array_equal(te.m_q, jte.m_q)
    return (tr, te), (jtr, jte)


@pytest.fixture(scope="module")
def cascade():
    _, _, jcfg, tcfg = cascades(3)
    return jcfg, tcfg


def _jax_init(jcfg, seed=0):
    return jax.device_get(JC.init_params(jcfg, jax.random.PRNGKey(seed)))


def _fit_both(logs, cascade, loss, engine, lcfg_kw=None, **tcfg_kw):
    (tr, _), (jtr, _) = logs
    jcfg, tcfg = cascade
    lcfg_kw = lcfg_kw or {"beta": 2.0}
    kw = dict(loss=loss, epochs=2, lr=0.05, batch_groups=16, log_every=1,
              engine=engine, **tcfg_kw)
    j_losses, t_losses = [], []
    jp = JT.fit(jtr, jcfg, JL.LossConfig(**lcfg_kw), JT.TrainConfig(**kw),
                callback=lambda s, v: j_losses.append((s, v)))
    tp = TT.fit(tr, tcfg, TL.LossConfig(**lcfg_kw), TT.TrainConfig(**kw),
                callback=lambda s, v: t_losses.append((s, v)),
                init_params=_jax_init(jcfg), device="cpu")
    return (jax.device_get(jp), j_losses), (tp, t_losses)


def _assert_fits_agree(j, t_):
    (jp, j_losses), (tp, t_losses) = j, t_
    assert [s for s, _ in t_losses] == [s for s, _ in j_losses]
    assert len(t_losses) == 20                   # 160 groups / 16, 2 epochs
    close([v for _, v in t_losses], [v for _, v in j_losses],
          rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert set(tp) == set(jp)
    for k in jp:
        close(tp[k], jp[k], rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.mark.parametrize("engine", ["loop", "scan"])
@pytest.mark.parametrize("loss", ["l1", "l3"])
def test_fit_matches_reference(logs, cascade, loss, engine):
    _assert_fits_agree(*_fit_both(logs, cascade, loss, engine))


def test_fit_l3_cost_mask_positives_paper_latency_matches_reference(
        logs, cascade):
    _assert_fits_agree(*_fit_both(
        logs, cascade, "l3", "scan",
        lcfg_kw={"beta": 5.0, "cost_mask_positives": True,
                 "latency_convention": "paper"}))


def test_scan_engine_matches_loop_engine(logs, cascade):
    (tr, _), _ = logs
    jcfg, tcfg = cascade
    out = {}
    for engine in ("loop", "scan"):
        losses = []
        p = TT.fit(tr, tcfg, TL.LossConfig(beta=2.0),
                   TT.TrainConfig(loss="l3", epochs=2, lr=0.05,
                                  batch_groups=16, log_every=1,
                                  engine=engine),
                   callback=lambda s, v: losses.append(v),
                   init_params=_jax_init(jcfg), device="cpu")
        out[engine] = (p, losses)
    close(out["scan"][1], out["loop"][1], rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for k in out["loop"][0]:
        close(out["scan"][0][k], out["loop"][0][k], rtol=PARAM_RTOL,
              atol=PARAM_ATOL)


def test_fit_is_deterministic_and_seeded_init_is_used(logs, cascade):
    (tr, _), _ = logs
    _, tcfg = cascade
    tc = TT.TrainConfig(loss="l3", epochs=1, lr=0.05, batch_groups=16)
    a = TT.fit(tr, tcfg, TL.LossConfig(), tc, device="cpu")
    b = TT.fit(tr, tcfg, TL.LossConfig(), tc, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k]) and not a[k].requires_grad


def test_loss_scale_tracks_unscaled_fit(logs, cascade):
    """The reference claims power-of-two loss scales leave the trajectory
    bitwise equal and its own test of that fails (ROADMAP Queue 3); the
    port holds the scaled fit to the unscaled one within 1e-6."""
    (tr, _), _ = logs
    _, tcfg = cascade
    base = TT.TrainConfig(loss="l3", epochs=2, lr=0.01, batch_groups=16)
    p1 = TT.fit(tr, tcfg, TL.LossConfig(beta=2.0), base, device="cpu")
    p2 = TT.fit(tr, tcfg, TL.LossConfig(beta=2.0),
                dataclasses.replace(base, loss_scale=1024.0), device="cpu")
    for k in p1:
        close(p2[k], p1[k], rtol=1e-6, atol=1e-7)


def test_bf16_fit_matches_reference_and_tracks_f32(logs, cascade):
    _assert_fits_agree(*_fit_both(logs, cascade, "l3", "scan",
                                  precision="bf16"))
    # bf16 storage, f32 accumulation: the reference's bar for a short fit
    (tr, _), _ = logs
    _, tcfg = cascade
    base = TT.TrainConfig(loss="l3", epochs=2, lr=0.01, batch_groups=16)
    p32 = TT.fit(tr, tcfg, TL.LossConfig(beta=2.0), base, device="cpu")
    p16 = TT.fit(tr, tcfg, TL.LossConfig(beta=2.0),
                 dataclasses.replace(base, precision="bf16"), device="cpu")
    for k in p32:
        assert torch.isfinite(p16[k]).all()
        close(p16[k], p32[k], rtol=0, atol=2e-3)


def test_engine_pack_matches_reference(logs):
    (tr, _), (jtr, _) = logs
    lcfg = dict(beta=2.0, eps_purchase=3.0, mu_price=2.0,
                cost_mask_positives=True)
    for precision in ("f32", "bf16"):
        ji, jg = JT._engine_pack(jtr, JL.LossConfig(**lcfg), precision)
        ti, tg = TT._engine_pack(tr, TL.LossConfig(**lcfg), precision,
                                 device="cpu")
        assert ti.dtype == (torch.bfloat16 if precision == "bf16"
                            else torch.float32)
        close(ti.float(), np.asarray(ji, np.float32), rtol=1e-6)
        close(tg, jg, rtol=1e-6)
        tb = TT._engine_unpack(ti, tg, 24, 8)
        jb = JT._engine_unpack(ji, jg, 24, 8)
        assert tb.keys() == jb.keys()
        assert all(v.dtype == torch.float32 for v in tb.values())
        for k in jb:
            close(tb[k], jb[k], rtol=1e-6)


def test_trainer_refuses_what_it_does_not_run(logs, cascade):
    (tr, _), _ = logs
    _, tcfg = cascade
    with pytest.raises(ValueError, match="unknown trainer engine"):
        TT.fit(tr, tcfg, TL.LossConfig(), TT.TrainConfig(engine="bogus"),
               device="cpu")
    with pytest.raises(ValueError, match="unknown engine precision"):
        TT._engine_pack(tr, TL.LossConfig(), "fp8", device="cpu")
    for kw in [{"precision": "bf16"}, {"loss_scale": 128.0}]:
        with pytest.raises(ValueError, match="scan-engine features"):
            TT.fit(tr, tcfg, TL.LossConfig(),
                   TT.TrainConfig(engine="loop", epochs=1, **kw),
                   device="cpu")


def test_epoch_plan_matches_reference(logs):
    (tr, _), (jtr, _) = logs
    for args in [(120, 32), (128, 32), (20, 32)]:
        assert TT.epoch_steps(*args) == JT.epoch_steps(*args)
    for seed in range(3):
        assert np.array_equal(TT._epoch_perm(160, 16, seed),
                              JT._epoch_perm(160, 16, seed))
    got = list(TT.batches(tr, 32, seed=1, device="cpu"))
    want = list(JT.batches(jtr, 32, seed=1))
    assert len(got) == len(want) == 5
    for g_, w_ in zip(got, want):
        assert g_.keys() == w_.keys()
        for k in w_:
            close(g_[k], w_[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# evaluate, metrics, baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("convention", ["entering", "paper"])
def test_evaluate_matches_reference(logs, convention):
    (_, te), (_, jte) = logs
    jp, tp, jcfg, tcfg = cascades(3, scale=0.3, seed=5)
    kw = dict(beta=2.0, latency_convention=convention)
    got = TT.evaluate(tp, tcfg, te, TL.LossConfig(**kw))
    want = JT.evaluate(jp, jcfg, jte, JL.LossConfig(**kw))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_metrics_module_matches_reference():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(12, 20))
    scores[:, 5] = scores[:, 4]                  # ties get average ranks
    labels = (rng.random((12, 20)) < 0.3).astype(np.float64)
    mask = (rng.random((12, 20)) < 0.9).astype(np.float64)
    assert TM.auc(scores, labels, mask) == JM.auc(scores, labels, mask)
    assert TM.group_auc(scores, labels, mask) == JM.group_auc(scores, labels,
                                                              mask)
    assert TM.cost_ratio(3.0, 4.0) == JM.cost_ratio(3.0, 4.0)
    kept = rng.integers(0, 400, 12)
    m_q = rng.integers(50, 5000, 12)
    assert TM.result_size_stats(kept, m_q) == JM.result_size_stats(kept, m_q)
    lat = rng.uniform(50, 200, 12)
    rel = rng.normal(size=(12, 20))
    price = np.exp(rng.normal(3, 1, (12, 20)))
    assert (TM.simulate_session(scores, rel, price, mask, lat, seed=3)
            == JM.simulate_session(scores, rel, price, mask, lat, seed=3))


def _single_stage_init(jcfg_fn, seed=0):
    return _jax_init(jcfg_fn(), seed)


@pytest.mark.parametrize("which", ["soft_cascade", "cloes", "two_stage"])
def test_baselines_match_reference(logs, which):
    (tr, te), (jtr, jte) = logs
    tc = dict(epochs=2, lr=0.05, batch_groups=16)
    if which == "two_stage":
        init = _single_stage_init(JB.single_stage_all_features)
        want = JB.eval_two_stage(
            JB.fit_two_stage(jtr, stage1_keep=600,
                             tcfg=JT.TrainConfig(loss="l1", **tc)), jte)
        got = TB.eval_two_stage(
            TB.fit_two_stage(tr, stage1_keep=600,
                             tcfg=TT.TrainConfig(loss="l1", **tc),
                             init_params=init, device="cpu"), te)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
        return
    jfit, tfit, loss = {"soft_cascade": (JB.fit_soft_cascade,
                                         TB.fit_soft_cascade, "l1"),
                        "cloes": (JB.fit_cloes, TB.fit_cloes, "l3")}[which]
    jp, jcfg = jfit(jtr, tcfg=JT.TrainConfig(loss=loss, **tc))
    tp, tcfg = tfit(tr, tcfg=TT.TrainConfig(loss=loss, **tc),
                    init_params=_jax_init(jcfg), device="cpu")
    assert tcfg.masks == jcfg.masks and tcfg.stage_times == jcfg.stage_times
    for k in jp:
        close(tp[k], jax.device_get(jp[k]), rtol=PARAM_RTOL,
              atol=PARAM_ATOL)


def test_single_stage_configs_match_reference():
    for name in ("single_stage_all_features", "single_stage_simple_features"):
        got, want = getattr(TB, name)(), getattr(JB, name)()
        assert got.masks == want.masks and got.stage_times == want.stage_times


# ---------------------------------------------------------------------------
# the training launcher
# ---------------------------------------------------------------------------

def test_train_launcher_on_cpu(capsys):
    out = TLT.main(["--device", "cpu", "--queries", "200", "--epochs", "1"])
    text = capsys.readouterr().out
    line = next(s for s in text.splitlines() if "params sha256=" in s)
    assert len(line.split("sha256=")[1]) == 64
    assert "[eval:train] auc=" in text and "[eval:test] auc=" in text
    assert set(out) == {"train", "test"}
    assert 0.5 < out["test"]["auc"] <= 1.0


def test_params_digest_follows_the_bytes():
    p = {"w_x": torch.zeros(3, 24), "w_q": torch.zeros(3, 8),
         "b": torch.zeros(3)}
    h = hashlib.sha256()
    for k in ("b", "w_q", "w_x"):
        a = n(p[k])
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    assert TLT.params_digest(p) == h.hexdigest()
    p["b"][1] = 1e-30
    assert TLT.params_digest(p) != h.hexdigest()
