"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same inputs, made with numpy from a seed, go to the JAX reference and to
the port on the CPU.

Tolerances: continuous outputs (lp, counts, scores, latencies) at
rtol 1e-5 / atol 1e-6 — float32 sums taken in another order; the
reference is not bitwise-consistent with itself on this JAX either.
Discrete outputs (n_keep, survivors, orders, statuses) exactly, after
asserting that the inputs leave every decision a margin
(repro_torch.kernels.cascade_filter.ref.assert_decision_margin)."""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
import repro_torch.configs as TCFG
from repro.core import cascade as JC
from repro.data import features as JF
from repro.models import base as JMB
from repro.models import zoo as JZ
from repro_torch.core import cascade as TC
from repro_torch.analysis.witness import install_witness
from repro_torch.core import pipeline as TPIPE
from repro_torch.launch.train import ENC_FRAMES
from repro_torch.models import zoo as TZ
from repro_torch.serving import batching as TB
from repro_torch.kernels.cascade_filter.ref import assert_decision_margin
from repro_torch.kernels.cascade_score.ref import cascade_score_batched_ref

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def torch_lock_order_witness():
    """The port's serving tests run under its runtime lock-order witness
    (repro_torch.analysis.witness), as the reference's run under its own
    (tests/conftest.py): every lock a port serving class constructs, and
    `_build`'s build and launch locks, are wrapped in a recording proxy,
    and an acquisition order that closes a cycle fails the test at
    teardown even when the unlucky interleaving never happened. Autouse
    in each test file that imports it (test_torch_serving, _pump,
    _router, _checkpoint)."""
    witness, uninstall = install_witness()
    try:
        yield witness
        witness.assert_clean()
    finally:
        uninstall()


@contextlib.contextmanager
def one_cpu_thread():
    """Run the block on one CPU thread. torch's multi-threaded CPU kernels
    are not run-to-run deterministic: in about 1 of 40 fresh processes the
    first fit differs in the last bits from the same fit run again (on one
    thread 48 of 48 runs agreed), and the embedding backward differs
    between any two runs. A test that holds two CPU runs bit-equal pins
    the port's arithmetic, not torch's threading."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def exact(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor of the same dtype, bit for
    bit (bfloat16 crosses as its uint16 bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def n(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol)


def cascades(t_stages=3, scale=0.3, seed=0):
    """(JAX params, port params, JAX cfg, port cfg): the reference's
    seeded init carried to the port as numpy arrays."""
    masks = JF.default_stage_masks(t_stages)
    times = JF.stage_costs(masks)
    jcfg = JC.CascadeConfig(t_stages, JF.N_FEATURES, JF.N_QUERY_BUCKETS,
                            masks, times)
    tcfg = TC.CascadeConfig(t_stages, JF.N_FEATURES, JF.N_QUERY_BUCKETS,
                            masks, times)
    jp = JC.init_params(jcfg, jax.random.PRNGKey(seed), scale=scale)
    tp = TC.params_from_numpy(jax.device_get(jp), device="cpu")
    return jp, tp, jcfg, tcfg


def filter_case(b, g, d, t_stages, seed):
    """Kernel inputs as tests/test_kernels.py draws them, in numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, g, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=(t_stages, d))).astype(np.float32)
    zq = rng.normal(size=(b, t_stages)).astype(np.float32)
    mask = (rng.random((b, g)) < 0.85).astype(np.float32)
    m_q = rng.integers(1, 4 * g + 2, b).astype(np.float32)
    return x, w, zq, mask, m_q


def loss_case(b, g, d, t_stages, seed, dead_group=True):
    """Packed K4/K5 inputs as tests/test_cascade_loss.py draws them, in
    numpy: (xc (B, G, d+4), w (T, d), zq (B, T)); group 0 fully masked
    when dead_group. The weights are scaled by 0.3, as filter_case's are:
    with unit weights some logits pass 11, where 1 - exp(lp) of a negative
    item is a few hundred float32 ulps of 1 and the NLL gradient's
    ppc / (1 - ppc) turns one ulp of exp — which the two frameworks' exp
    do not agree on — into 0.4% (measured at G=130, d=24, T=1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, g, d)).astype(np.float32)
    y = rng.integers(0, 2, (b, g)).astype(np.float32)
    mask = (rng.random((b, g)) < 0.85).astype(np.float32)
    if dead_group:
        mask[0] = 0.0
    wgt = rng.uniform(0.5, 3.0, (b, g)).astype(np.float32) * mask
    cost_w = rng.uniform(0.0, 50.0, (b, g)).astype(np.float32) * mask
    xc = np.concatenate([x, y[..., None], mask[..., None], wgt[..., None],
                         cost_w[..., None]], axis=-1)
    w = (0.3 * rng.normal(size=(t_stages, d))).astype(np.float32)
    zq = rng.normal(size=(b, t_stages)).astype(np.float32)
    return xc, w, zq


def at_offset(a: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `a` whose storage starts 4 bytes past a 16-byte
    boundary: the input that sends the CUDA kernels down their scalar
    paths (chip_smoke.py runs the same cases on the card)."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


def with_margin(make, seed, tries=20):
    """make(seed) -> (x, w, zq, mask, m_q); the first seed from `seed` on
    whose inputs the filter's discrete decisions have margin."""
    for s in range(seed, seed + tries):
        case = make(s)
        x, w, zq, mask, m_q = map(t, case)
        try:
            assert_decision_margin(cascade_score_batched_ref(x, w, zq),
                                   mask, m_q)
            return case
        except AssertionError:
            continue
    raise AssertionError(f"no seed in [{seed}, {seed + tries}) has margin")


# ---------------------------------------------------------------------------
# the serving session under the DES, side by side with the reference
# ---------------------------------------------------------------------------

class FakeTimer:
    """perf_counter stand-in: advances a fixed dt per call, so measured
    'service time' is deterministic — the one wall-clock input the DES has."""

    def __init__(self, dt_s=0.004):
        self.t, self.dt = 0.0, dt_s

    def __call__(self):
        self.t += self.dt
        return self.t


def serving_arrays(n, seed=0, lo=2, hi=9):
    """n requests as plain arrays (id, q_feat, item_feats, m_q)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(lo, hi))
        out.append((i, np.eye(8)[i % 8].astype(np.float32),
                    rng.normal(size=(k, 24)).astype(np.float32), 10 * k + 1))
    return out


def requests(mod, arrays):
    """RankRequests of module `mod` (the reference's or the port's
    batching) from serving_arrays."""
    return [mod.RankRequest(request_id=i, q_feat=q, item_feats=x, m_q=m)
            for i, q, x, m in arrays]


def serving_config(mod, **kw):
    """A ServingConfig of session module `mod` (the reference's or the
    port's) from plain values."""
    d = dict(plan="filter", group_buckets=(8,), batch_groups=2, max_queue=8,
             flush=dict(max_wait_ms=5.0),
             degrade=dict(high_watermark=6, low_watermark=2))
    d.update(kw)
    return mod.ServingConfig(
        **{k: v for k, v in d.items()
           if k not in ("flush", "degrade", "retry")},
        flush=mod.FlushPolicy(**d["flush"]),
        degrade=mod.DegradePolicy(**d["degrade"]),
        retry=mod.RetryPolicy(**d.get("retry", {})))


def assert_margin(tp, tcfg, arrays, buckets, mq_scales=(1.0, 0.5)):
    """Every request, alone in its bucket, leaves the port's filter
    decisions a margin at every m_q the session may serve it with."""
    buckets = tuple(sorted(buckets))
    for i, q, x, m in arrays:
        for g in {TB.bucket_of(len(x), buckets), buckets[0]}:
            batch = TB.alloc_batch(1, g, 24, 8)
            TB.pack_into(batch, requests(TB, [(i, q, x, m)]), g)
            for s in mq_scales:
                m_q = t(np.maximum(batch["m_q"] * s, 1.0) if s < 1
                        else batch["m_q"])
                lp = TPIPE.run_cascade(tp, tcfg, t(batch["x"]),
                                       t(batch["q"]), t(batch["mask"]),
                                       m_q)["lp"]
                assert_decision_margin(lp, t(batch["mask"]), m_q)


def assert_same_serve(jres, tres, jses, tses):
    """Two DES runs agree: summary and stats equal, every response's
    status, flags, timings, order and survivors equal, scores and latency
    estimates within tolerance."""
    assert (json.dumps(jres.summary(), sort_keys=True)
            == json.dumps(tres.summary(), sort_keys=True))
    assert jses.stats_export() == tses.stats_export()
    assert len(jres.futures) == len(tres.futures)
    for jf, tf in zip(jres.futures, tres.futures):
        a, b = jf.result(), tf.result()
        for field in ("request_id", "status", "degraded", "truncated",
                      "deadline_missed", "wait_ms", "service_ms", "error",
                      "attempts", "stage_counts"):
            assert getattr(a, field) == getattr(b, field), \
                (field, a.request_id)
        np.testing.assert_array_equal(a.order, b.order)
        np.testing.assert_array_equal(a.survivors, b.survivors)
        close(b.scores, a.scores)
        close(b.est_latency_ms, a.est_latency_ms)


# ---------------------------------------------------------------------------
# the model zoo: the reference's smoke models carried to the port
# ---------------------------------------------------------------------------

DENSE_ARCHS = ["gemma3-27b", "qwen3-8b", "yi-34b", "starcoder2-3b",
               "pixtral-12b"]
MOE_ARCHS = ["dbrx-132b", "arctic-480b"]
SSM_ARCHS = ["rwkv6-1.6b", "zamba2-1.2b"]      # the ssm and hybrid families
ENCDEC_ARCHS = ["seamless-m4t-large-v2"]
PORTED_ARCHS = DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS + ENCDEC_ARCHS


def dense_model(arch, dtype="float32", seed=1):
    """(JAX cfg, port cfg, JAX params, port params) of the arch's smoke
    variant in `dtype`: the reference's `materialize` from PRNGKey(seed),
    carried over bit for bit by `zoo.params_from_numpy`."""
    jcfg = dataclasses.replace(JCFG.get_smoke(arch), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(TCFG.get_smoke(arch),
                               dtype=getattr(torch, dtype))
    jp = JMB.materialize(JZ.templates(jcfg), jax.random.PRNGKey(seed),
                         dtype=jcfg.dtype)
    tp = TZ.params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def flat_arrays(tree, prefix="") -> dict:
    """A nested dict of arrays as {"a/b/c": numpy array} (a tree crossing
    to a subprocess or a rank in an npz file)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_arrays(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def perturbed_model(arch, impl="scan", vocab=None, seed=1, noise=0.1,
                    layers=0):
    """(JAX cfg, JAX params) of the arch's smoke config in float32 (its
    ssm_impl `impl`, its vocabulary `vocab` and its first `layers` layers
    where given) from the reference's `materialize`, every leaf the
    templates initialise to zeros or ones perturbed by noise * N(0, 1)
    numpy draws, so that the LoRA, bonus, shift and norm paths are not
    trivial."""
    jcfg = dataclasses.replace(JCFG.get_smoke(arch), dtype=jnp.float32,
                               ssm_impl=impl)
    if vocab:
        jcfg = dataclasses.replace(jcfg, vocab=vocab)
    if layers:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
    tmpl = JZ.templates(jcfg)
    jp = JMB.materialize(tmpl, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)

    def perturb(t, a):
        a = np.asarray(a)
        if t.init in ("zeros", "ones"):
            a = a + noise * rng.normal(size=a.shape).astype(np.float32)
        return jnp.asarray(a, jnp.float32)

    return jcfg, jax.tree_util.tree_map(perturb, tmpl, jp)


def token_batch(cfg, b, s, seed=0):
    """A (JAX batch, port batch) pair of s random tokens per row, plus the
    frontend stub embeddings of a vlm config (its frontend positions) or
    of an encdec one (ENC_FRAMES encoder frames), drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}
    if cfg.frontend_positions:
        frames = (ENC_FRAMES if cfg.arch_type == "encdec"
                  else cfg.frontend_positions)
        fe = (0.1 * rng.normal(size=(b, frames,
                                     cfg.d_model))).astype(np.float32)
        jb["frontend"], tb["frontend"] = jnp.asarray(fe), torch.from_numpy(fe)
    return jb, tb
