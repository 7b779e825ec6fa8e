"""The port's objectives (`repro_torch.core.losses`), the fused L3 op's
gradient routing and the optimizers, against the JAX reference on the CPU.

Bars (ROADMAP "How the port is checked"): loss values 1e-6 relative, param
grads rtol/atol 1e-5, against `repro.core.losses` on the same numpy batch
and the same initial weights. Within the port the fused L3 (K4/K5's plain
versions: the forward's values, the closed-form backward) equals the
unfused score-then-reduce graph (autograd through K1/K3's plain versions)
to the same bars, as the reference's own fused and unfused paths do
(tests/test_cascade_loss.py).

Ties at the NLL clamp (lp_T == -1e-7 exactly): the jnp.minimum / torch.minimum
paths pass half the tangent, the Pallas kernel and the closed forms all of
it. The cross-package tests keep lp_T away from the clamp; one test builds
an exact tie and pins each port path to the reference path it ports.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as JL
from repro.data import features as JF
from repro.kernels.cascade_loss.kernel import cascade_loss_bwd as jloss_bwd
from repro_torch.core import losses as TL
from repro_torch.kernels import ops as TK
from repro_torch.kernels.cascade_loss.kernel import LOG_P_CLAMP, pack_items
from repro_torch.kernels.cascade_loss.ref import (cascade_loss_bwd_ref,
                                                  cascade_loss_ref)
from torch_parity import cascades, close, loss_case, t

# the modules: each package's optim/__init__ re-exports a function `sgd`
JO = importlib.import_module("repro.optim.sgd")
TO = importlib.import_module("repro_torch.optim.sgd")
VAL_RTOL, GRAD_TOL = 1e-6, 1e-5


def _raw_batch(seed=0, b=8, g=16):
    """tests/test_cascade_loss.py's raw batch, in numpy."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(b, g, JF.N_FEATURES)).astype(np.float32),
        "q": np.eye(JF.N_QUERY_BUCKETS, dtype=np.float32)[
            rng.integers(0, 8, b)],
        "y": rng.integers(0, 2, (b, g)).astype(np.float32),
        "mask": (rng.random((b, g)) < 0.9).astype(np.float32),
        "behavior": rng.integers(0, 3, (b, g)).astype(np.int32),
        "price": np.exp(rng.normal(3, 1, (b, g))).astype(np.float32),
        "m_q": rng.integers(50, 5000, b).astype(np.float32),
    }


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) if v.dtype.kind == "i" else t(v)
            for k, v in batch.items()}


def _torch_value_and_grad(fn, params, *args, **kw):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss = fn(leaves, *args, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _assert_same(v_got, g_got, v_want, g_want):
    v_got, v_want = float(v_got), float(v_want)
    assert np.isfinite(v_got)
    assert abs(v_got - v_want) <= VAL_RTOL * max(1.0, abs(v_want)), \
        (v_got, v_want)
    for k in g_want:
        close(g_got[k], g_want[k], rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.fixture(scope="module")
def cascade():
    return cascades(3, scale=0.3)


def _lcfg(module, **kw):
    return module.LossConfig(beta=2.0, eps_purchase=3.0, mu_price=2.0, **kw)


# ---------------------------------------------------------------------------
# Objectives against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["l1", "l2", "l3"])
@pytest.mark.parametrize("cost_mask_positives", [False, True])
@pytest.mark.parametrize("convention", ["entering", "paper"])
def test_losses_match_reference(cascade, loss, cost_mask_positives,
                                convention):
    jp, tp, jcfg, tcfg = cascade
    kw = dict(cost_mask_positives=cost_mask_positives,
              latency_convention=convention)
    batch = _raw_batch()
    v_j, g_j = jax.value_and_grad(JL.LOSSES[loss])(
        jp, jcfg, _lcfg(JL, **kw), _jax_batch(batch))
    v_t, g_t = _torch_value_and_grad(TL.LOSSES[loss], tp, tcfg,
                                     _lcfg(TL, **kw), _torch_batch(batch))
    _assert_same(v_t, g_t, v_j, g_j)


def test_l3_fully_padded_groups_match_reference(cascade):
    jp, tp, jcfg, tcfg = cascade
    batch = _raw_batch(seed=3)
    batch["mask"][:3] = 0.0
    v_j, g_j = jax.value_and_grad(JL.loss_l3)(jp, jcfg, _lcfg(JL),
                                              _jax_batch(batch))
    v_t, g_t = _torch_value_and_grad(TL.loss_l3, tp, tcfg, _lcfg(TL),
                                     _torch_batch(batch))
    _assert_same(v_t, g_t, v_j, g_j)


@pytest.mark.parametrize("cost_mask_positives", [False, True])
@pytest.mark.parametrize("convention", ["entering", "paper"])
def test_fused_l3_matches_unfused(cascade, cost_mask_positives, convention):
    _, tp, _, tcfg = cascade
    lcfg = _lcfg(TL, cost_mask_positives=cost_mask_positives,
                 latency_convention=convention)
    batch = _torch_batch(_raw_batch())
    v_f, g_f = _torch_value_and_grad(TL.loss_l3, tp, tcfg, lcfg, batch)
    v_u, g_u = _torch_value_and_grad(TL.loss_l3, tp, tcfg, lcfg, batch,
                                     score_fn=TK.cascade_score_batched)
    _assert_same(v_f, g_f, v_u, g_u)


@pytest.mark.parametrize("loss", ["l1", "l2", "l3"])
def test_engine_batch_matches_raw(cascade, loss):
    """The engine columns (wgt/cost_w/mn/n_o_eff + the packed xc) and the
    raw-batch derivation give the same value and grads."""
    _, tp, _, tcfg = cascade
    lcfg = _lcfg(TL)
    raw = _torch_batch(_raw_batch())
    mn = raw["m_q"] / torch.clamp_min(raw["mask"].sum(-1), 1.0)
    wgt = TL.importance_weights(raw["behavior"], raw["price"], lcfg)
    cost_w = raw["mask"] * mn[:, None]
    engine = {
        "x": raw["x"], "q": raw["q"], "y": raw["y"], "mask": raw["mask"],
        "m_q": raw["m_q"], "wgt": wgt, "cost_w": cost_w, "mn": mn,
        "n_o_eff": torch.clamp_max(raw["m_q"], lcfg.n_o),
        "xc": pack_items(raw["x"], raw["y"], raw["mask"], wgt, cost_w),
    }
    v_r, g_r = _torch_value_and_grad(TL.LOSSES[loss], tp, tcfg, lcfg, raw)
    v_e, g_e = _torch_value_and_grad(TL.LOSSES[loss], tp, tcfg, lcfg, engine)
    _assert_same(v_e, g_e, v_r, g_r)


def test_term_apis_match_reference(cascade):
    jp, tp, jcfg, tcfg = cascade
    lcfg_j, lcfg_t = _lcfg(JL), _lcfg(TL)
    b = _raw_batch(seed=4)
    jb, tb = _jax_batch(b), _torch_batch(b)
    close(TL.importance_weights(tb["behavior"], tb["price"], lcfg_t),
          JL.importance_weights(jb["behavior"], jb["price"], lcfg_j))
    close(TL.weighted_nll(tp, tcfg, lcfg_t, tb["x"], tb["q"], tb["y"],
                          tb["mask"], tb["behavior"], tb["price"]),
          JL.weighted_nll(jp, jcfg, lcfg_j, jb["x"], jb["q"], jb["y"],
                          jb["mask"], jb["behavior"], jb["price"]))
    for y in (None, "y"):
        close(TL.expected_cost(tp, tcfg, tb["x"], tb["q"], tb["mask"],
                               y and tb[y], tb["m_q"]),
              JL.expected_cost(jp, jcfg, jb["x"], jb["q"], jb["mask"],
                               y and jb[y], jb["m_q"]))
    close(TL.expected_cost(tp, tcfg, tb["x"], tb["q"], tb["mask"]),
          JL.expected_cost(jp, jcfg, jb["x"], jb["q"], jb["mask"]))
    close(TL.expected_latency_per_query(tp, tcfg, lcfg_t, tb["x"], tb["q"],
                                        tb["mask"], tb["m_q"]),
          JL.expected_latency_per_query(jp, jcfg, lcfg_j, jb["x"], jb["q"],
                                        jb["mask"], jb["m_q"]))
    close(TL.l2_penalty(tp, lcfg_t), JL.l2_penalty(jp, lcfg_j))


def test_smooth_hinge_matches_jax_softplus_past_torch_threshold():
    """softplus as logaddexp: above F.softplus's threshold (gamma*u > 20)
    the values and gradients still equal jax.nn.softplus's."""
    z = np.array([-2000.0, -450.0, -50.0, 0.0, 150.0, 900.0], np.float32)
    zt = t(z).requires_grad_(True)
    got = TL.smooth_hinge(zt, 200.0, 0.05)
    got.sum().backward()
    fn = lambda a: JL.smooth_hinge(a, 200.0, 0.05)
    close(got, fn(jnp.asarray(z)), rtol=1e-6)
    close(zt.grad, jax.grad(lambda a: fn(a).sum())(jnp.asarray(z)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The fused op's gradient routing, stream by stream
# ---------------------------------------------------------------------------

def _streams(seed):
    b, g, t_, d = 4, 16, 3, 24
    xc, w, zq = loss_case(b, g, d, t_, seed=seed, dead_group=False)
    rng = np.random.default_rng(seed + 1)
    cot = [rng.normal(size=(b,)), rng.normal(size=(t_,)),
           rng.normal(size=(b, t_))]
    return xc, w, zq, [c.astype(np.float32) for c in cot]


def _autograd_grads(fn, xc, w, zq, cot):
    w_, zq_, zqp_ = (t(a).requires_grad_(True) for a in (w, zq, zq))
    outs = fn(t(xc), w_, zq_, zqp_)
    sum((o * t(c)).sum() for o, c in zip(outs, cot)).backward()
    return w_.grad, zq_.grad, zqp_.grad


@pytest.mark.parametrize("stream", ["nll", "cost", "counts", "all"])
@pytest.mark.parametrize("path", ["plain_forward", "op"])
def test_fused_loss_streams_match_closed_form(stream, path):
    """Autograd through the plain forward (routing built in algebraically)
    and the op's backward each equal the closed form, one cotangent stream
    at a time; the counts stream leaves w_eff and zq exactly zero."""
    xc, w, zq, cot = _streams(seed=9)
    keep = {"nll": 0, "cost": 1, "counts": 2}.get(stream)
    if keep is not None:
        cot = [c if i == keep else np.zeros_like(c)
               for i, c in enumerate(cot)]
    fn = cascade_loss_ref if path == "plain_forward" else TK.cascade_loss_fused
    dw, dzq, dzqp = _autograd_grads(fn, xc, w, zq, cot)
    _, dw_c, dzq_c, dzqp_c = cascade_loss_bwd_ref(*map(t, (xc, w, zq, *cot)))
    for a, r in ((dw, dw_c), (dzq, dzq_c), (dzqp, dzqp_c)):
        close(a, r, rtol=1e-4, atol=1e-5)
    if stream == "counts":
        assert float(dw.abs().max()) == 0.0
        assert float(dzq.abs().max()) == 0.0
        assert float(dzqp.abs().max()) > 0.0
    if stream in ("nll", "cost"):
        assert float(dzqp.abs().max()) == 0.0


def test_fused_op_without_zq_pen_adds_both_streams_in_zq():
    xc, w, zq, cot = _streams(seed=17)
    w_, zq_ = t(w).requires_grad_(True), t(zq).requires_grad_(True)
    outs = TK.cascade_loss_fused(t(xc), w_, zq_)
    sum((o * t(c)).sum() for o, c in zip(outs, cot)).backward()
    _, dw_c, dzq_c, dzqp_c = cascade_loss_bwd_ref(*map(t, (xc, w, zq, *cot)))
    close(w_.grad, dw_c)
    close(zq_.grad, dzq_c + dzqp_c)


def test_zq_pen_is_value_inert():
    xc, w, zq = loss_case(3, 8, 24, 3, seed=21)
    plain = cascade_loss_ref(t(xc), t(w), t(zq))
    routed = cascade_loss_ref(t(xc), t(w), t(zq), t(zq))
    for a, r in zip(routed, plain):
        assert torch.equal(a, r)


# Found by search: with zero features the logits are these biases exactly,
# and lp_T = log sigma(16.118097) + log sigma(29.3795) is float32(-1e-7)
# exactly in both frameworks.
TIE_ZQ = np.array([[16.118097, 29.3795]], np.float32)


def test_exact_tie_at_the_clamp_each_path_keeps_its_rule():
    d = 4
    x = np.zeros((1, 2, d), np.float32)
    y = np.array([[0.0, 1.0]], np.float32)
    ones = np.ones((1, 2), np.float32)
    xc = np.concatenate([x, y[..., None], ones[..., None],
                         ones[..., None], ones[..., None]], axis=-1)
    w = np.zeros((2, d), np.float32)
    zq = TIE_ZQ
    lp_t = torch.cumsum(torch.nn.functional.logsigmoid(t(zq)), -1)[0, -1]
    lp_j = jnp.cumsum(jax.nn.log_sigmoid(jnp.asarray(zq)), -1)[0, -1]
    assert float(lp_t) == float(lp_j) == float(np.float32(LOG_P_CLAMP))
    cot = [np.ones(1, np.float32), np.zeros(2, np.float32),
           np.zeros((1, 2), np.float32)]
    # K5's plain version against the interpreted Pallas kernel: all of it
    got = cascade_loss_bwd_ref(*map(t, (xc, w, zq, *cot)))
    want = jloss_bwd(*map(jnp.asarray, (xc, w, zq, *cot)), d_x=d,
                     interpret=True)
    for a, r in zip(got, want):
        close(a, r, rtol=1e-5, atol=1e-6)
    assert float(got[2].abs().max()) > 0.0
    # nll_from_lp: half of it, as the reference's jnp.minimum passes
    lp = np.array([[[-0.5, LOG_P_CLAMP]]], np.float32)
    yy, mm = np.array([[0.0]], np.float32), np.ones((1, 1), np.float32)
    lpt = t(lp).requires_grad_(True)
    TL.nll_from_lp(lpt, t(yy), t(mm)).backward()
    g_j = jax.grad(lambda a: JL.nll_from_lp(a, jnp.asarray(yy),
                                            jnp.asarray(mm)))(jnp.asarray(lp))
    close(lpt.grad, g_j, rtol=1e-6)
    # ... which is half of the whole tangent of -log(1 - p) there
    x = torch.tensor(LOG_P_CLAMP, requires_grad=True)
    (-torch.log1p(-torch.exp(x))).backward()
    assert float(lpt.grad[0, 0, 1]) == 0.5 * float(x.grad)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w_x": rng.normal(size=(3, 5)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


@pytest.mark.parametrize("opt", ["sgd", "momentum_sgd", "momentum_sgd_cosine"])
def test_optimizers_match_reference(opt):
    make = {"sgd": lambda m, lr: m.sgd(lr),
            "momentum_sgd": lambda m, lr: m.momentum_sgd(lr, 0.9),
            "momentum_sgd_cosine": lambda m, lr: m.momentum_sgd(
                m.cosine_schedule(0.1, 6, warmup=2), 0.9)}[opt]
    jopt, topt = make(JO, 0.05), make(TO, 0.05)
    p0 = _params()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: t(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(6):
        g = _params(seed=step + 1)
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update({k: t(v) for k, v in g.items()}, ts, tp)
        jp, tp = JO.apply_updates(jp, ju), TO.apply_updates(tp, tu)
        for k in p0:
            close(tp[k], jp[k], rtol=1e-6, atol=1e-7)
    assert ts["step"] == int(js["step"]) == 6


def test_cosine_schedule_matches_reference():
    j, s = JO.cosine_schedule(0.3, 20, warmup=4), TO.cosine_schedule(0.3, 20,
                                                                      warmup=4)
    for step in range(0, 25, 3):
        assert abs(float(s(step)) - float(j(step))) <= 1e-7


def test_momentum_sgd_on_a_raveled_vector():
    opt = TO.momentum_sgd(0.1, 0.5)
    th = torch.ones(4)
    state = opt.init(th)
    u, state = opt.update(torch.full((4,), 2.0), state)
    u, state = opt.update(torch.full((4,), 2.0), state)
    assert torch.allclose(u, torch.full((4,), -0.1 * 3.0))
    assert torch.allclose(TO.apply_updates(th, u), torch.full((4,), 0.7))
