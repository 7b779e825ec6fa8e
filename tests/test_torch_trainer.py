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

Also the data-parallel fit (a world of one equal to `fit` bit for bit; two
gloo ranks' first step within 1e-5 of the reference's per-shard step), the
launcher's crash seam and resume (the uninterrupted run's digest), the same
under torchrun on two gloo ranks (with a dividing and a non-dividing
--batch-groups: rank 0 alone writes the checkpoints), and the LM target
(`--layers` cuts depth only): Adam against the reference's on the same gradients (rtol 1e-6,
the same float32 operations), and `zoo.train_step` for every dense smoke
config (losses rtol 1e-5; the first step's gradients, through Adam's
first moment, within 1e-3 of each leaf's largest — the forward's logits
are held to 2e-4, tests/test_torch_models.py).
"""

import dataclasses
import hashlib
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.flatten_util import ravel_pytree
from torch.distributed.device_mesh import DeviceMesh

import repro.checkpoint as JCK
from repro.core import baselines as JB
from repro.core import cascade as JC
from repro.core import losses as JL
from repro.core import metrics as JM
from repro.core import trainer as JT
from repro.data import LogConfig as JLogConfig
from repro.data import generate_log as jgenerate_log
from repro.models import zoo as JZ
from repro.optim import adam as jadam
from repro_torch import configs as TCFG
from repro_torch.core import baselines as TB
from repro_torch.core import losses as TL
from repro_torch.core import metrics as TM
from repro_torch.core import trainer as TT
from repro_torch.data import LogConfig, generate_log
from repro_torch.launch import train as TLT
from repro_torch.launch.mesh import data_parallel_mesh
from repro_torch.models import base as TMB
from repro_torch.models import zoo as TZ
from repro_torch.optim import adam as tadam
from torch_parity import (DENSE_ARCHS, cascades, close, dense_model, n,
                          one_cpu_thread)

JSGD = importlib.import_module("repro.optim.sgd")
REPO = Path(__file__).resolve().parents[1]

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


def _launch_train(*flags, timeout=120) -> subprocess.CompletedProcess:
    """The launcher in a subprocess, on the CPU threads torch picks: the
    fit itself takes its steps on one thread on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--queries", "300", "--epochs", "4", "--batch-groups", "16", *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _digest(out: str) -> str:
    return next(s for s in out.split() if s.startswith("sha256="))


@pytest.mark.parametrize("case", range(4))
def test_train_launcher_crash_and_resume_reproduce_the_digest(tmp_path, case):
    """The restart smoke of scripts/ci.sh on the port: killed after epoch
    2 (exit code 9, a SIGKILL stand-in), resumed from its checkpoint, the
    run prints the params sha256 of the uninterrupted run, which has no
    checkpoint dir (as scripts/ci.sh takes REF_DIGEST). No thread pin in
    the environment: a fit on the CPU pins itself to one thread, so every
    one of the cases reproduces the digest (at 8 threads without that
    pin, 2 of 32 runs did not)."""
    full = _launch_train()
    assert full.returncode == 0, full.stderr
    ckpt = str(tmp_path / "ckpt")
    crash = _launch_train("--checkpoint-dir", ckpt, "--crash-after-epoch", "2")
    assert crash.returncode == TT.CRASH_EXIT_CODE == 9, crash.stderr
    assert "params sha256=" not in crash.stdout
    resumed = _launch_train("--checkpoint-dir", ckpt, "--resume")
    assert resumed.returncode == 0, resumed.stderr
    assert "(restored_epoch=2 epochs_run=2)" in resumed.stdout
    assert _digest(resumed.stdout) == _digest(full.stdout)
    # ... and the same digest in every case
    assert _RESUME_DIGESTS.setdefault("digest", _digest(full.stdout)) \
        == _digest(full.stdout)


_RESUME_DIGESTS: dict[str, str] = {}


def test_train_launcher_save_writes_a_checkpoint(tmp_path, capsys):
    path = tmp_path / "cascade"
    TLT.main(["--device", "cpu", "--queries", "200", "--epochs", "1",
              "--save", str(path)])
    assert f"[ckpt] saved to {path}" in capsys.readouterr().out
    tree = JCK.load_pytree(path)          # the reference reads it
    assert set(tree) == {"params", "lcfg"}
    assert tree["lcfg"] == dataclasses.asdict(TL.LossConfig(beta=5.0))
    assert {k: v.shape for k, v in tree["params"].items()} == \
        {"b": (3,), "w_q": (3, 8), "w_x": (3, 24)}


# ---------------------------------------------------------------------------
# data parallelism over a torch.distributed mesh
# ---------------------------------------------------------------------------

_DP_LOG = dict(n_queries=16, items_per_query=16, seed=3)
_DP_TCFG = dict(loss="l3", lr=0.05, batch_groups=16, log_every=1)


def _dp_fit(mesh, epochs, **kw):
    losses = []
    p, _ = TB.fit_cloes(generate_log(LogConfig(**_DP_LOG)),
                        lcfg=TL.LossConfig(beta=2.0),
                        tcfg=TT.TrainConfig(epochs=epochs, **_DP_TCFG),
                        callback=lambda s, v: losses.append(v), mesh=mesh,
                        device="cpu", **kw)
    return p, losses


def test_data_parallel_world_of_one_equals_fit(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        assert data_parallel_mesh(16, "cpu") is None    # a world of one
        mesh = DeviceMesh("cpu", [0], mesh_dim_names=("data",))
        with one_cpu_thread():
            ref, ref_losses = _dp_fit(None, 3)
            got, losses = _dp_fit(mesh, 3)
    finally:
        dist.destroy_process_group()
    assert losses == ref_losses
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_data_parallel_refusals(logs, cascade):
    assert data_parallel_mesh(16, "cpu") is None        # no process group

    class _Mesh:                        # what fit reads of a 3-rank mesh
        def size(self):
            return 3
    (tr, _), _ = logs
    _, tcfg = cascade
    with pytest.raises(ValueError, match="must divide by the data-axis"):
        TT.fit(tr, tcfg, TL.LossConfig(),
               TT.TrainConfig(batch_groups=16, epochs=1), mesh=_Mesh(),
               device="cpu")
    with pytest.raises(ValueError, match="no data-parallel path"):
        TT.fit(tr, tcfg, TL.LossConfig(),
               TT.TrainConfig(engine="loop", epochs=1), mesh=_Mesh(),
               device="cpu")


def _dp_worker(rank, world, tmp, init):
    """One rank of test_data_parallel_two_ranks: (a) one step (16 groups,
    one minibatch an epoch) from the reference's init, checkpointing into
    a directory of its own; (b) resumed from rank 0's directory to 2
    epochs; (c) 2 epochs uninterrupted. Writes what it saw to
    rank{rank}.npz."""
    torch.set_num_threads(1)            # as one_cpu_thread: p2r == p2
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world)
    try:
        assert data_parallel_mesh(15, "cpu") is None    # 2 does not divide
        mesh = data_parallel_mesh(16, "cpu")
        p1, l1 = _dp_fit(mesh, 1, init_params=init,
                         checkpoint_dir=f"{tmp}/ckpt{rank}")
        info: dict = {}
        p2r, _ = _dp_fit(mesh, 2, init_params=init,
                         checkpoint_dir=f"{tmp}/ckpt0", resume=True,
                         train_info=info)
        p2, _ = _dp_fit(mesh, 2, init_params=init)
        np.savez(f"{tmp}/rank{rank}.npz", loss=np.array(l1),
                 restored=info["restored_epoch"],
                 resumed_equal=all(torch.equal(p2r[k], p2[k]) for k in p2),
                 **{k: v.numpy() for k, v in p1.items()})
    finally:
        dist.destroy_process_group()


def test_data_parallel_two_ranks_match_the_reference_per_shard_step(
        tmp_path):
    """Two gloo ranks: every rank ends the first step with the same params,
    which are the reference's per-shard-normalized step — loss_l3's
    gradient on each contiguous half of the minibatch, their mean, one
    momentum_sgd update — within 1e-5. Only rank 0 writes checkpoints,
    every rank resumes from them, bit-identically."""
    _, _, jcfg, _ = cascades(3)
    init = jax.device_get(JC.init_params(jcfg, jax.random.PRNGKey(0)))
    mp.spawn(_dp_worker, args=(2, str(tmp_path), init), nprocs=2, join=True)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    lcfg = JL.LossConfig(beta=2.0)
    item, group = JT._engine_pack(
        jgenerate_log(JLogConfig(**_DP_LOG)), lcfg)
    idx = JT._epoch_perm(16, 16, 0)[0]
    theta, unravel = ravel_pytree(init)
    losses, grads = [], []
    for half in (idx[:8], idx[8:]):
        batch = JT._engine_unpack(item[half], group[half], 24, 8)
        loss, g = jax.value_and_grad(
            lambda th: JL.LOSSES["l3"](unravel(th), jcfg, lcfg, batch))(theta)
        losses.append(loss)
        grads.append(g)
    opt = JSGD.momentum_sgd(0.05, 0.9)
    upd, _ = opt.update((grads[0] + grads[1]) / 2, opt.init(theta), theta)
    want = jax.device_get(unravel(JSGD.apply_updates(theta, upd)))
    for r, out in enumerate(got):
        close(out["loss"], [(losses[0] + losses[1]) / 2], rtol=1e-5,
              atol=1e-5)
        for k in want:
            close(out[k], want[k], rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(out[k], got[0][k])
        assert int(out["restored"]) == 1 and bool(out["resumed_equal"])
    assert not list((tmp_path / "ckpt1").glob("step_*"))   # rank 1 wrote none
    assert [p.name for p in sorted((tmp_path / "ckpt0").glob("*.json"))] \
        == ["step_00000001.json", "step_00000002.json"]


# launch.train's main under torchrun, printing what each rank returned
_TORCHRUN_MAIN = (
    "import os, sys; from repro_torch.launch import train; "
    "out = train.main(sys.argv[1:]); "
    "print(f'[rank {os.environ[\"RANK\"]}] returned {sorted(out)}')")


def _torchrun_train(ckpt, batch_groups, *flags, timeout=120):
    """`launch.train.main` under `torchrun --standalone` with two gloo ranks
    on one CPU thread each (localhost rendezvous on a free port)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--no-python", sys.executable, "-c",
         _TORCHRUN_MAIN, "--device", "cpu", "--queries", "300", "--epochs", "4",
         "--batch-groups", str(batch_groups), "--checkpoint-dir", str(ckpt),
         *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("batch_groups,ways", [(16, 2), (7, 1)])
def test_train_launcher_under_torchrun_crash_and_resume(tmp_path,
                                                        batch_groups, ways):
    """`launch.train` under torchrun: each rank joins the group from the
    environment, rank 0 alone prints and writes the checkpoints, the crash
    seam exits 9 once rank 0's save is committed, and `--resume` on every
    rank reproduces the uninterrupted run's digest. 16 groups divide over
    the 2 ranks; 7 do not, so rank 0 alone trains on the plain path (the
    digest of a single process) while rank 1 returns at once, writing
    nothing."""
    ckpt = tmp_path / "ckpt"
    crash = _torchrun_train(ckpt, batch_groups, "--crash-after-epoch", "2")
    assert crash.returncode != 0 and "exitcode  : 9" in crash.stderr, \
        crash.stderr[-2000:]
    assert "params sha256=" not in crash.stdout
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "step_00000001.json", "step_00000001.npz",
        "step_00000002.json", "step_00000002.npz"]
    resumed = _torchrun_train(ckpt, batch_groups, "--resume")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert resumed.stdout.count("params sha256=") == 1      # rank 0 prints
    assert f"{ways}-way data parallel" in resumed.stdout
    assert "(restored_epoch=2 epochs_run=2)" in resumed.stdout
    rank1 = "['test', 'train']" if ways == 2 else "[]"
    assert f"[rank 1] returned {rank1}" in resumed.stdout
    assert sorted(p.name for p in ckpt.glob("*.json")) == [
        "step_00000002.json", "step_00000003.json", "step_00000004.json"]
    if ways == 1:
        full = _launch_train("--batch-groups", str(batch_groups))
    else:
        full = _torchrun_train(tmp_path / "full", batch_groups)
    assert full.returncode == 0, full.stderr[-2000:]
    assert _digest(resumed.stdout) == _digest(full.stdout)


# ---------------------------------------------------------------------------
# the LM target: Adam, zoo.lm_loss / train_step, the launcher
# ---------------------------------------------------------------------------

def test_adam_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "n": {"b": rng.normal(size=(5,)).astype(np.float32)}}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = TMB.tree_map(torch.from_numpy, tree)
    for wd in (0.0, 0.1):
        jo, to = jadam(1e-2, weight_decay=wd), tadam(1e-2, weight_decay=wd)
        js, ts = jo.init(jp), to.init(tp)
        assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
        for i in range(4):
            g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
                 "n": {"b": (10.0 ** -i * rng.normal(size=(5,)))
                       .astype(np.float32)}}
            ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                               jp)
            tu, ts = to.update(TMB.tree_map(torch.from_numpy, g), ts, tp)
            for jt, tt in ((ju, tu), (js["m"], ts["m"]), (js["v"], ts["v"])):
                for a, b in zip(jax.tree_util.tree_leaves(jt),
                                TMB.tree_leaves(tt)):
                    close(b, a, rtol=1e-6, atol=1e-9)
        assert int(ts["step"]) == int(js["step"]) == 4


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_lm_train_step_matches_reference(arch):
    jcfg, tcfg, jp, tp = dense_model(arch)
    jo, to = jadam(1e-3), tadam(1e-3)
    js, ts = jo.init(jp), to.init(tp)
    step = jax.jit(lambda p, o, b: JZ.train_step(p, o, b, jcfg, jo.update))
    rng = np.random.default_rng(0)
    for i in range(3):
        tb = TLT.lm_batch(tcfg, rng, 2, 24, "cpu")
        jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
        jp, js, jl = step(jp, js, jb)
        tp, ts, tl = TZ.train_step(tp, ts, tb, tcfg, to.update)
        close(tl, jl, rtol=1e-5, atol=1e-5)
        if i == 0:          # m = (1 - b1) g: the gradients
            jm = jax.tree_util.tree_leaves(jax.device_get(js["m"]))
            tm = list(TMB.tree_leaves(ts["m"]))
            assert len(jm) == len(tm)
            for a, b in zip(jm, tm):
                close(b, a, rtol=0, atol=1e-3 * float(np.abs(a).max()))
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
    assert all(torch.isfinite(p).all() for p in TMB.tree_leaves(tp))


def test_train_launcher_lm_target_on_cpu(capsys):
    losses = TLT.main(["--target", "lm", "--arch", "yi-34b", "--smoke",
                       "--steps", "3", "--seq", "16", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "[train] yi-smoke" in out and "final loss" in out
    losses = TLT.main(["--target", "lm", "--arch", "seamless-m4t-large-v2",
                       "--smoke", "--steps", "2", "--seq", "16", "--device",
                       "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert ("[train] seamless-smoke: 2 layers + 2 encoder layers"
            in capsys.readouterr().out)


def test_train_launcher_lm_layers_cuts_depth_only(capsys):
    """`--layers N` trains the config's first N layers at its widths: the
    launcher's losses are those of the same Adam steps on the config with
    n_layers = N, the weights drawn in float32 from the seed."""
    losses = TLT.main(["--target", "lm", "--arch", "qwen3-8b", "--smoke",
                       "--layers", "1", "--steps", "2", "--seq", "16",
                       "--device", "cpu"])
    cfg = dataclasses.replace(TCFG.get_smoke("qwen3-8b"), n_layers=1,
                              dtype=torch.float32)
    params = TMB.materialize(TZ.templates(cfg),
                             torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in TMB.tree_leaves(params))
    assert f"1 layers, {n_params / 1e6:.1f}M params" in capsys.readouterr().out
    opt = tadam(0.01)
    state, rng, want = opt.init(params), np.random.default_rng(0), []
    for _ in range(2):
        batch = TLT.lm_batch(cfg, rng, 4, 16, "cpu")
        params, state, loss = TZ.train_step(params, state, batch, cfg,
                                            opt.update)
        want.append(float(loss))
    assert losses == want
