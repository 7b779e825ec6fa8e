"""The port's checkpoint layer (`repro_torch.checkpoint`), its filesystem
fault injector, the trainer's resume and the session's warm restart —
every case of tests/test_checkpoint.py run on the port — and the two
packages side by side: the same tree gives the same manifest, each
package loads (and resumes from, and warm-restarts on) the other's files,
and the two fs-fault injectors mangle the same bytes for the same seed.

Tolerances: a resumed fit is held BIT-identical to the uninterrupted one
within a package (on one CPU thread, torch_parity.one_cpu_thread); across packages the fit bars of test_torch_trainer.py
(losses 1e-5, params rtol 1e-4 / atol 1e-5), since the two frameworks sum
in different orders. Discrete serving outputs exactly where there is
margin (torch_parity.assert_margin)."""

import dataclasses
import importlib
import io as _io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as JCK
from repro.core import baselines as JB
from repro.core import cascade as JC
from repro.core import trainer as JT
from repro.data import LogConfig as JLogConfig
from repro.data import generate_log as jgenerate_log
from repro.launch import serve as JSV
from repro.serving import batching as JBT
from repro.serving import faults as JF
from repro.serving import session as JS
from repro.serving.loadgen import run_open_loop as j_run
from repro_torch.checkpoint import (CheckpointCorrupt, CheckpointError,
                                    CheckpointStore, load_pytree,
                                    save_pytree)
from repro_torch.core import baselines as TB
from repro_torch.core import cascade as TC
from repro_torch.core import losses as TL
from repro_torch.core import prng
from repro_torch.core import trainer as TT
from repro_torch.data import LogConfig, generate_log
from repro_torch.data import features as F
from repro_torch.launch import serve as TSV
from repro_torch.serving import batching as TBT
from repro_torch.serving import session as TS
from repro_torch.serving.faults import FsFaultConfig, FsFaultInjector
from repro_torch.serving.loadgen import run_open_loop as t_run
from torch_parity import torch_lock_order_witness  # noqa: F401
from torch_parity import (FakeTimer, assert_margin, assert_same_serve,
                          cascades, close, one_cpu_thread, requests,
                          serving_arrays, serving_config)

CKIO = importlib.import_module("repro_torch.checkpoint.io")
JCKIO = importlib.import_module("repro.checkpoint.io")
TRAJ_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


def _bits(a) -> np.ndarray:
    """A bf16 torch tensor or ml_dtypes array as its uint16 bit pattern."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


# ---------------------------------------------------------------------------
# Exact round trip.
# ---------------------------------------------------------------------------

def test_roundtrip_preserves_structure_and_scalars(tmp_path):
    tree = {
        "list": [1, 2.5, "s", None, True],
        "tup": (np.arange(3, dtype=np.float32), {"k": 7}),
        "nested": {"empty_list": [], "empty_dict": {}},
        "scalar": 3,
    }
    save_pytree(tmp_path / "ck", tree)
    out = load_pytree(tmp_path / "ck")
    assert isinstance(out["list"], list)
    assert out["list"] == [1, 2.5, "s", None, True]
    assert isinstance(out["tup"], tuple)
    assert isinstance(out["tup"][1], dict) and out["tup"][1]["k"] == 7
    assert type(out["scalar"]) is int and out["scalar"] == 3
    assert type(out["list"][4]) is bool
    assert out["nested"] == {"empty_list": [], "empty_dict": {}}
    np.testing.assert_array_equal(out["tup"][0],
                                  np.arange(3, dtype=np.float32))


def test_roundtrip_dtypes_exact(tmp_path):
    bf16 = torch.tensor([1.5, -2.25, 3.0, -0.0], dtype=torch.bfloat16)
    tree = {
        "f32": np.linspace(0, 1, 7, dtype=np.float32),
        "f64": np.linspace(0, 1, 5, dtype=np.float64),
        "i32": np.arange(4, dtype=np.int32),
        "bf16": bf16,
        "bf16_2d": torch.randn(3, 5).to(torch.bfloat16)[:, ::2],  # strided
        "bf16_0d": torch.tensor(-7.5, dtype=torch.bfloat16),
        "t32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "zero_d": np.float32(2.5),
        "rng_key": prng.prng_key(3),
    }
    save_pytree(tmp_path / "ck", tree)
    out = load_pytree(tmp_path / "ck")
    assert out["f32"].dtype == np.float32
    assert out["f64"].dtype == np.float64
    assert out["i32"].dtype == np.int32
    # bf16 comes back as a torch bf16 tensor with the exact bit patterns
    # (numpy has no bfloat16 without ml_dtypes)
    for k in ("bf16", "bf16_2d", "bf16_0d"):
        assert isinstance(out[k], torch.Tensor)
        assert out[k].dtype == torch.bfloat16
        assert out[k].shape == tree[k].shape
        np.testing.assert_array_equal(_bits(out[k]),
                                      _bits(tree[k].contiguous()))
    assert isinstance(out["t32"], np.ndarray)
    np.testing.assert_array_equal(out["t32"], tree["t32"].numpy())
    assert out["zero_d"].shape == () and float(out["zero_d"]) == 2.5
    np.testing.assert_array_equal(out["rng_key"],
                                  np.asarray(jax.random.PRNGKey(3)))


def test_noncontiguous_and_rejected_leaves(tmp_path):
    arr = np.arange(12).reshape(3, 4)[:, ::2]          # strided view
    ten = torch.arange(12.0).reshape(3, 4).T           # transposed tensor
    save_pytree(tmp_path / "ck", {"a": arr, "t": ten})
    out = load_pytree(tmp_path / "ck")
    np.testing.assert_array_equal(out["a"], arr)
    np.testing.assert_array_equal(out["t"], ten.numpy())
    with pytest.raises(TypeError, match="keys must be strings"):
        save_pytree(tmp_path / "bad", {1: np.zeros(2)})
    with pytest.raises(TypeError, match="unsupported checkpoint leaf"):
        save_pytree(tmp_path / "bad", {"f": object()})
    # a non-native numpy dtype (ml_dtypes' bf16) is refused, not stored as
    # bits this reader could not restore
    with pytest.raises(TypeError, match="leaf dtype bfloat16"):
        save_pytree(tmp_path / "bad", {"b": np.zeros(2, jnp.bfloat16)})
    # a stored dtype this reader cannot rebuild is an error, not raw bits
    save_pytree(tmp_path / "x", {"w": np.zeros(2, np.uint8)})
    man = json.loads((tmp_path / "x.json").read_text())
    man["arrays"][0]["xdtype"] = "float8_e4m3fn"
    (tmp_path / "x.json").write_text(json.dumps(man))
    with pytest.raises(CheckpointError, match="bfloat16 only"):
        load_pytree(tmp_path / "x")


# ---------------------------------------------------------------------------
# Crash-safe commit protocol.
# ---------------------------------------------------------------------------

def test_crash_in_rename_window_leaves_last_good(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path, keep=3)
    store.save(1, {"w": np.full(4, 1.0)}, meta={"epoch": 1})

    def boom(src, dst):
        raise OSError("simulated crash before rename")
    monkeypatch.setattr(CKIO.os, "replace", boom)
    with pytest.raises(OSError, match="simulated crash"):
        store.save(2, {"w": np.full(4, 2.0)}, meta={"epoch": 2})
    monkeypatch.undo()

    store2 = CheckpointStore(tmp_path, keep=3)
    assert store2.steps() == [1]
    step, tree, meta = store2.load_latest()
    assert step == 1 and meta == {"epoch": 1}
    np.testing.assert_array_equal(tree["w"], np.full(4, 1.0))
    assert list(tmp_path.glob("*.tmp.*"))
    store2.save(3, {"w": np.full(4, 3.0)})
    assert not list(tmp_path.glob("*.tmp.*"))


def test_manifest_is_the_commit_point(tmp_path):
    store = CheckpointStore(tmp_path, keep=3)
    store.save(1, {"w": np.ones(3)})
    (tmp_path / "step_00000002.npz").write_bytes(b"orphan arrays")
    assert store.steps() == [1]
    with pytest.raises(FileNotFoundError):
        load_pytree(tmp_path / "step_00000002")
    (tmp_path / "step_00000001.npz").unlink()
    with pytest.raises(CheckpointCorrupt, match="torn checkpoint"):
        load_pytree(tmp_path / "step_00000001")


def test_checksum_rejects_bitflip_and_load_latest_falls_back(tmp_path):
    store = CheckpointStore(tmp_path, keep=3)
    store.save(1, {"w": np.full(8, 1.0)}, meta={"epoch": 1})
    store.save(2, {"w": np.full(8, 2.0)}, meta={"epoch": 2})
    p = tmp_path / "step_00000002.npz"
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    p.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorrupt):
        store.load(2)
    step, tree, meta = store.load_latest()
    assert step == 1 and meta == {"epoch": 1}
    np.testing.assert_array_equal(tree["w"], np.full(8, 1.0))
    assert store.errors and store.errors[0][0] == 2


def test_truncated_arrays_file_detected(tmp_path):
    save_pytree(tmp_path / "ck", {"w": np.arange(64, dtype=np.float64)})
    p = tmp_path / "ck.npz"
    p.write_bytes(p.read_bytes()[:-20])
    with pytest.raises(CheckpointCorrupt, match="truncated"):
        load_pytree(tmp_path / "ck")


def test_crc_catches_flip_npz_cannot(tmp_path):
    """A data flip with npz's own member crc repaired and the length kept:
    only the manifest's per-array checksum catches it."""
    save_pytree(tmp_path / "ck", {"w": np.zeros(4, np.uint8)})
    man = json.loads((tmp_path / "ck.json").read_text())
    buf = _io.BytesIO()
    np.savez(buf, a0=np.array([1, 0, 0, 0], np.uint8))
    forged = buf.getvalue()
    assert len(forged) == man["npz_bytes"]
    (tmp_path / "ck.npz").write_bytes(forged)
    with pytest.raises(CheckpointCorrupt, match="checksum"):
        load_pytree(tmp_path / "ck")


def test_retention_gc_keeps_exactly_n(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in range(1, 6):
        store.save(s, {"w": np.full(2, float(s))})
    assert store.steps() == [4, 5]
    assert len(list(tmp_path.iterdir())) == 4
    assert store.latest_step() == 5
    step, tree, _ = store.load_latest()
    assert step == 5
    np.testing.assert_array_equal(tree["w"], np.full(2, 5.0))
    with pytest.raises(ValueError, match="keep must be >= 1"):
        CheckpointStore(tmp_path, keep=0)


# ---------------------------------------------------------------------------
# Seeded filesystem chaos: correct-or-fallback, never silently wrong.
# ---------------------------------------------------------------------------

def test_fs_fault_injector_discipline():
    inj = FsFaultInjector(FsFaultConfig(torn_write_rate=0.5,
                                        truncate_rate=0.25,
                                        bitflip_rate=0.25, seed=3))
    payload = bytes(range(256))
    outs = [inj.on_write("p", payload) for _ in range(50)]
    torn = [o for o in outs if len(o) < len(payload)]
    assert torn and all(payload.startswith(o) for o in torn)
    inj.enabled = False
    assert inj.on_read("p", payload) == payload
    inj.enabled = True
    assert inj.snapshot()["torn_write"] == len(torn)
    inj2 = FsFaultInjector(FsFaultConfig(torn_write_rate=0.5,
                                         truncate_rate=0.25,
                                         bitflip_rate=0.25, seed=3))
    assert [inj2.on_write("p", payload) for _ in range(50)] == outs


@pytest.mark.parametrize("cfg", [
    dict(torn_write_rate=0.5, truncate_rate=0.25, bitflip_rate=0.25, seed=3),
    dict(torn_write_rate=0.2, truncate_rate=0.6, bitflip_rate=0.6, seed=11),
], ids=["seed3", "seed11"])
def test_fs_fault_injector_replays_reference(cfg):
    """Same seed and payloads: the same mangled bytes and stats as the
    reference's injector (the same default_rng draw order)."""
    ti = FsFaultInjector(FsFaultConfig(**cfg))
    ji = JF.FsFaultInjector(JF.FsFaultConfig(**cfg))
    rng = np.random.default_rng(0)
    for i in range(60):
        payload = rng.bytes(int(rng.integers(0, 300)))
        hook = "on_write" if i % 3 else "on_read"
        assert getattr(ti, hook)("p", payload) == \
            getattr(ji, hook)("p", payload)
    assert ti.snapshot() == ji.snapshot()
    assert sum(ti.snapshot().values()) > 0


def test_store_under_torn_write_chaos_never_silently_wrong(tmp_path):
    inj = FsFaultInjector(FsFaultConfig(torn_write_rate=0.4, seed=7))
    store = CheckpointStore(tmp_path / "chaos", keep=10, fs_faults=inj)
    for s in range(1, 16):
        store.save(s, {"w": torch.full((4,), float(s))}, meta={"s": s})
    inj.enabled = False
    assert inj.snapshot()["torn_write"] > 0
    res = store.load_latest()
    assert res is not None
    step, tree, meta = res
    np.testing.assert_array_equal(tree["w"], np.full(4, float(step)))
    assert meta == {"s": step}


def test_store_under_read_chaos_never_silently_wrong(tmp_path):
    store = CheckpointStore(tmp_path / "c2", keep=10)
    for s in range(1, 6):
        store.save(s, {"w": np.full(4, float(s))}, meta={"s": s})
    inj = FsFaultInjector(FsFaultConfig(truncate_rate=0.3, bitflip_rate=0.3,
                                        seed=11))
    reader = CheckpointStore(tmp_path / "c2", keep=10, fs_faults=inj)
    for _ in range(10):
        reader.errors.clear()
        res = reader.load_latest()
        if res is None:
            continue                    # every step faulted this pass: fine
        step, tree, meta = res
        np.testing.assert_array_equal(tree["w"], np.full(4, float(step)))
        assert meta == {"s": step}


# ---------------------------------------------------------------------------
# Training resume: bit-identical kill-and-resume trajectory.
# ---------------------------------------------------------------------------

_FIT_LOG = dict(n_queries=120, items_per_query=16, seed=5)


def _tiny_fit(tmp_path=None, *, epochs, resume=False, tcfg_kw=None,
              losses=None, **fit_kw):
    log = generate_log(LogConfig(**_FIT_LOG))
    tcfg = TT.TrainConfig(loss="l3", epochs=epochs, batch_groups=8,
                          seed=3, **(tcfg_kw or {}))
    cb = (lambda step, loss: losses.append((step, loss))) \
        if losses is not None else None
    return TB.fit_cloes(log, tcfg=tcfg, callback=cb,
                        checkpoint_dir=None if tmp_path is None else
                        str(tmp_path), resume=resume, device="cpu", **fit_kw)


def test_resume_is_bit_identical(tmp_path):
    base_losses: list = []
    params_full, _ = _tiny_fit(epochs=4, losses=base_losses,
                               tcfg_kw={"log_every": 1})
    _tiny_fit(tmp_path, epochs=2, tcfg_kw={"checkpoint_every": 1})
    resumed_losses: list = []
    info: dict = {}
    params_res, _ = _tiny_fit(tmp_path, epochs=4, resume=True,
                              losses=resumed_losses,
                              tcfg_kw={"checkpoint_every": 1,
                                       "log_every": 1},
                              train_info=info)
    assert info["restored_epoch"] == 2 and info["epochs_run"] == 2
    for k in params_full:
        assert torch.equal(params_full[k], params_res[k]), k
    base = dict(base_losses)
    assert len(resumed_losses) == 30
    for step, loss in resumed_losses:
        assert base[step] == loss       # float equality, on purpose


def test_resume_falls_back_past_corrupt_newest(tmp_path):
    _tiny_fit(tmp_path, epochs=3, tcfg_kw={"checkpoint_every": 1})
    newest = sorted(tmp_path.glob("step_*.npz"))[-1]
    newest.write_bytes(newest.read_bytes()[:-40])
    info: dict = {}
    _tiny_fit(tmp_path, epochs=4, resume=True,
              tcfg_kw={"checkpoint_every": 1}, train_info=info)
    assert info["restored_epoch"] == 2


def test_resume_rejects_config_mismatch(tmp_path):
    _tiny_fit(tmp_path, epochs=2, tcfg_kw={"checkpoint_every": 1})
    with pytest.raises(ValueError, match="different training config"):
        _tiny_fit(tmp_path, epochs=4, resume=True,
                  tcfg_kw={"checkpoint_every": 1, "lr": 0.123})


def test_loop_engine_rejects_checkpointing(tmp_path):
    with pytest.raises(ValueError, match="scan-engine feature"):
        _tiny_fit(tmp_path, epochs=1, tcfg_kw={"engine": "loop"})


def test_resume_past_end_returns_restored_params(tmp_path):
    params_a, _ = _tiny_fit(tmp_path, epochs=2,
                            tcfg_kw={"checkpoint_every": 1})
    info: dict = {}
    params_b, _ = _tiny_fit(tmp_path, epochs=2, resume=True,
                            tcfg_kw={"checkpoint_every": 1},
                            train_info=info)
    assert info["epochs_run"] == 0
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k])


def test_restored_checkpoint_wins_over_init_params(tmp_path):
    params_a, cfg = _tiny_fit(tmp_path, epochs=2)
    init = {k: np.full(tuple(v.shape), 0.5, np.float32)
            for k, v in params_a.items()}
    params_b, _ = _tiny_fit(tmp_path, epochs=2, resume=True,
                            init_params=init)
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k])


# ---------------------------------------------------------------------------
# The trainer's checkpoints across packages.
# ---------------------------------------------------------------------------

def test_prng_key_matches_jax():
    for seed in (0, 3, 12345, 2**31 - 1, -1, -5):
        np.testing.assert_array_equal(prng.prng_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))
        assert prng.prng_key(seed).dtype == np.uint32


def _both_fits(tmp_path, epochs, writer, resumer=None, losses=None):
    """An L3 fit of the reference's init on both packages' logs: `writer`
    ('jax' | 'torch') fits `epochs` epochs into tmp_path; with `resumer`,
    that package then resumes to 4. Returns the last fit's params as numpy.

    16 groups a minibatch (7 steps an epoch), as test_torch_trainer's
    fits: at 8 the two packages' UNINTERRUPTED 60-step fits already part
    by 2.5e-4 in the loss (float32 sums in another order, carried forward
    by momentum at lr 0.05), past the bars with or without a resume."""
    jlog = jgenerate_log(JLogConfig(**_FIT_LOG))
    tlog = generate_log(LogConfig(**_FIT_LOG))
    kw = dict(loss="l3", batch_groups=16, seed=3, log_every=1,
              checkpoint_every=1)
    _, _, jcfg, _ = cascades(3)             # fit_cloes's configuration
    init = jax.device_get(JC.init_params(jcfg, jax.random.PRNGKey(3)))
    cb = None if losses is None else (lambda s, v: losses.append((s, v)))

    def run(pkg, n, resume):
        if pkg == "jax":
            p, _ = JB.fit_cloes(jlog, tcfg=JT.TrainConfig(epochs=n, **kw),
                                callback=cb if resume or n == 4 else None,
                                checkpoint_dir=str(tmp_path), resume=resume)
            return {k: np.asarray(v) for k, v in jax.device_get(p).items()}
        p, _ = TB.fit_cloes(tlog, tcfg=TT.TrainConfig(epochs=n, **kw),
                            callback=cb if resume or n == 4 else None,
                            checkpoint_dir=str(tmp_path), resume=resume,
                            init_params=init, device="cpu")
        return {k: v.numpy() for k, v in p.items()}

    out = run(writer, epochs, False)
    return out if resumer is None else run(resumer, 4, True)


@pytest.mark.parametrize("writer,resumer", [("jax", "torch"),
                                            ("torch", "jax")])
def test_each_package_resumes_the_others_checkpoint(tmp_path, writer,
                                                    resumer):
    """Killed at epoch 2 by one package, resumed to 4 by the other: within
    the fit bars of the reference's uninterrupted 4-epoch fit (both start
    from the reference's init, the port through init_params)."""
    full_losses: list = []
    full = _both_fits(tmp_path / "full", 4, "jax", losses=full_losses)
    res_losses: list = []
    resumed = _both_fits(tmp_path / "ck", 2, writer, resumer,
                         losses=res_losses)
    assert [s for s, _ in res_losses] == list(range(14, 28))
    base = dict(full_losses)
    close([v for _, v in res_losses], [base[s] for s, _ in res_losses],
          rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for k in full:
        close(resumed[k], full[k], rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_trainer_state_tree_is_the_references(tmp_path):
    """The port's trainer checkpoint has the reference's structure,
    dtypes, shapes and meta: {"theta", "opt_state": {"step", "mu"},
    "epoch", "rng_key"}, step a 0-d int32."""
    _both_fits(tmp_path / "j", 1, "jax")
    _both_fits(tmp_path / "t", 1, "torch")
    mj = json.loads((tmp_path / "j" / "step_00000001.json").read_text())
    mt = json.loads((tmp_path / "t" / "step_00000001.json").read_text())
    assert mt["spec"] == mj["spec"] and mt["meta"] == mj["meta"]
    for a, b in zip(mt["arrays"], mj["arrays"]):
        assert {k: a[k] for k in ("dtype", "xdtype", "shape")} == \
            {k: b[k] for k in ("dtype", "xdtype", "shape")}
    state = load_pytree(tmp_path / "t" / "step_00000001")
    assert state["opt_state"]["step"].shape == ()
    assert state["opt_state"]["step"].dtype == np.int32
    assert int(state["opt_state"]["step"]) == 7 and state["epoch"] == 1
    jstate = JCK.load_pytree(tmp_path / "t" / "step_00000001")
    np.testing.assert_array_equal(jstate["rng_key"],
                                  np.asarray(jax.random.PRNGKey(3)))


# ---------------------------------------------------------------------------
# The same files in both packages.
# ---------------------------------------------------------------------------

def _numpy_tree():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(3, 5)).astype(np.float32),
            "b": [np.arange(4, dtype=np.int32), np.float64(2.5)],
            "t": (1, "s", None, {"k": np.zeros((0, 2), np.float32)}),
            "key": np.asarray(jax.random.PRNGKey(7))}


def test_manifests_equal_across_packages(tmp_path):
    tree = _numpy_tree()
    bits = np.random.default_rng(1).integers(0, 2**15, (4, 3)) \
        .astype(np.uint16)
    jtree = dict(tree, bf16=jnp.asarray(bits.view(jnp.bfloat16)))
    ttree = dict(tree, bf16=torch.from_numpy(bits.view(np.int16))
                 .view(torch.bfloat16))
    JCK.save_pytree(tmp_path / "j", jtree, meta={"m": 1})
    save_pytree(tmp_path / "t", ttree, meta={"m": 1})
    mj = json.loads((tmp_path / "j.json").read_text())
    mt = json.loads((tmp_path / "t.json").read_text())
    assert mt == mj                 # spec, dtypes, shapes, crc32s, length
    assert mt["arrays"][-1]["xdtype"] == "bfloat16"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_loads_the_others_files(tmp_path, writer):
    bits = np.array([0x3FC0, 0xC010, 0x0001, 0x7F80, 0x8000], np.uint16)
    tree = _numpy_tree()
    if writer == "jax":
        JCK.save_pytree(tmp_path / "ck",
                        dict(tree, bf16=jnp.asarray(bits.view(jnp.bfloat16))))
        out = load_pytree(tmp_path / "ck")
        assert isinstance(out["bf16"], torch.Tensor)
        assert out["bf16"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(out["bf16"]), bits)
    else:
        save_pytree(tmp_path / "ck", dict(
            tree, bf16=torch.from_numpy(bits.view(np.int16))
            .view(torch.bfloat16)))
        out = JCK.load_pytree(tmp_path / "ck")
        assert out["bf16"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(out["bf16"]), bits)
    assert isinstance(out["b"], list) and isinstance(out["t"], tuple)
    assert out["t"][:3] == (1, "s", None)
    for k in ("w", "key"):
        np.testing.assert_array_equal(out[k], tree[k])
        assert out[k].dtype == tree[k].dtype
    np.testing.assert_array_equal(out["b"][0], tree["b"][0])
    assert out["b"][1].shape == () and out["b"][1].dtype == np.float64
    assert out["t"][3]["k"].shape == (0, 2)


def test_reader_rejects_what_the_reference_rejects(tmp_path):
    """Both readers refuse the same corrupt files the same way."""
    save_pytree(tmp_path / "ck", {"w": np.arange(16, dtype=np.float32)})
    p = tmp_path / "ck.npz"
    good = p.read_bytes()
    mid = len(good) // 2                # inside the array's data
    for bad, why in [(good[:-8], "truncated"),
                     (good[:mid] + bytes([good[mid] ^ 1]) + good[mid + 1:],
                      None)]:
        p.write_bytes(bad)
        for load in (load_pytree, JCK.load_pytree):
            with pytest.raises((CheckpointCorrupt, JCKIO.CheckpointCorrupt),
                               match=why):
                load(tmp_path / "ck")
    p.write_bytes(good)
    man = json.loads((tmp_path / "ck.json").read_text())
    (tmp_path / "ck.json").write_text(json.dumps(dict(man, version=2)))
    for load in (load_pytree, JCK.load_pytree):
        with pytest.raises((CheckpointError, JCKIO.CheckpointError),
                           match="newer than this reader"):
            load(tmp_path / "ck")


# ---------------------------------------------------------------------------
# Serving warm restart: manifest round trip, no new shape.
# ---------------------------------------------------------------------------

def _serving_session(params, cfg):
    return TS.CascadeSession(params, cfg, TL.LossConfig(),
                             scfg=TS.ServingConfig(plan="filter",
                                                   group_buckets=(8,),
                                                   batch_groups=2),
                             device="cpu")


def _cascade_cfg():
    masks = F.default_stage_masks(3)
    return TC.CascadeConfig(3, F.N_FEATURES, F.N_QUERY_BUCKETS, masks,
                            F.stage_costs(masks))


def test_warm_restart_replays_manifest_with_zero_new_compiles(tmp_path):
    cfg = _cascade_cfg()
    params = TC.params_from_numpy(prng.reference_init(cfg, 0, scale=0.3),
                                  device="cpu")
    ses = _serving_session(params, cfg)
    shapes = ses.warmup()
    manifest = ses.warmup_manifest()
    assert manifest == json.loads(json.dumps(manifest))
    save_pytree(tmp_path / "m", {"manifest": manifest})
    restored = load_pytree(tmp_path / "m")["manifest"]

    ses2 = _serving_session(params, cfg)
    assert ses2.warm_restart(restored) == shapes
    seen = TSV.compiled_count([ses2])
    assert seen == len(shapes)
    for b, g in shapes:
        ses2.rank_batch({
            "x": np.random.default_rng(0).normal(
                size=(b, g, cfg.d_x)).astype(np.float32),
            "q": np.zeros((b, cfg.d_q), np.float32),
            "mask": np.ones((b, g), np.float32),
            "m_q": np.full((b,), float(g), np.float32)})
    assert TSV.compiled_count([ses2]) == seen


def test_warm_restart_rejects_mismatched_manifest():
    cfg = _cascade_cfg()
    params = TC.params_from_numpy(prng.reference_init(cfg, 0, scale=0.3),
                                  device="cpu")
    ses = _serving_session(params, cfg)
    man = ses.warmup_manifest()
    with pytest.raises(ValueError, match="shape surface"):
        ses.warm_restart(dict(man, batch_groups=64))
    with pytest.raises(ValueError, match="manifest version"):
        ses.warm_restart(dict(man, version=99))


_JP, _TP, _JCFG, _TCFG = cascades()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_serving_state_restores_across_packages(tmp_path, writer):
    """Serving state written by either package's launcher restores in the
    other (params bit for bit, configs, manifest) and, warm-restarted on
    its manifest, serves the same requests as the writer's own restore:
    the DES reports equal field for field, rankings exact (every request
    leaves its decisions a margin)."""
    scfg = dict(group_buckets=(8, 16), batch_groups=4, max_queue=64)
    jses = JS.CascadeSession(_JP, _JCFG, scfg=serving_config(JS, **scfg))
    tses = TS.CascadeSession(_TP, _TCFG, scfg=serving_config(TS, **scfg),
                             device="cpu")
    (JSV if writer == "jax" else TSV).save_serving_state(
        str(tmp_path), jses if writer == "jax" else tses)
    assert json.loads((tmp_path / "warmup_manifest.json").read_text()) \
        == tses.warmup_manifest() == jses.warmup_manifest()
    jp, jcfg, jlcfg, jman = JSV.load_serving_state(str(tmp_path))
    tp, tcfg, tlcfg, tman = TSV.load_serving_state(str(tmp_path),
                                                   device="cpu")
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(np.asarray(jp[k]),
                                      np.asarray(jax.device_get(_JP[k])))
    assert tcfg == _TCFG and jcfg.masks == _JCFG.masks
    assert tman == jman
    assert dataclasses.asdict(tlcfg) == dataclasses.asdict(jlcfg)
    arrays = serving_arrays(24, seed=4, lo=2, hi=15)
    assert_margin(tp, tcfg, arrays, scfg["group_buckets"])
    j2 = JS.CascadeSession(jp, jcfg, jlcfg, scfg=serving_config(JS, **scfg))
    t2 = TS.CascadeSession(tp, tcfg, tlcfg, scfg=serving_config(TS, **scfg),
                           device="cpu")
    assert t2.warm_restart(tman) == j2.warm_restart(jman)
    warmed = TSV.compiled_count([t2])
    for s in (j2, t2):
        s._sleep = lambda sec: None
    jres = j_run(j2, requests(JBT, arrays), 300.0, deadline_ms=50.0,
                 seed=2, timer=FakeTimer())
    tres = t_run(t2, requests(TBT, arrays), 300.0, deadline_ms=50.0,
                 seed=2, timer=FakeTimer())
    assert tres.completed == 24 and tres.unresolved == 0
    assert_same_serve(jres, tres, j2, t2)
    assert TSV.compiled_count([t2]) == warmed
