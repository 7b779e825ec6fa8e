"""The port's single-group scorer (K6, `kernels.ops.cascade_score`, with its
backward) and feature-major scorer (K7, `kernels.ops.cascade_score_fm`)
on the CPU, against the reference's Pallas kernels in interpret mode and
its XLA references, on the same numpy inputs; gradients through the op,
alone and under torch.func.vmap against jax.vmap; and `fit` training L3
through the vmapped op against the reference's fit through its own. The
CUDA kernels are held to these plain versions on the card by
chip_smoke.py.

Tolerances: forward values rtol/atol 1e-5 in float32 and 3e-2 with
bfloat16 inputs (the reference's bars, tests/test_kernels.py); the
backward's outputs rtol 1e-4 / atol 5e-5 (the reference's bar between its
kernel and autodiff, tests/test_train_engine.py: sums over up to 512 items
in another order); gradients of a loss through the op 1e-5; fits as in
tests/test_torch_trainer.py (trajectory 1e-5, params rtol 1e-4 / atol
1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cascade as JC
from repro.core import losses as JL
from repro.core import trainer as JT
from repro.data import LogConfig as JLogConfig
from repro.data import generate_log as jgenerate_log
from repro.kernels import ops as JK
from repro.kernels.cascade_score.kernel import cascade_score_bwd as jscore_bwd
from repro_torch.core import losses as TL
from repro_torch.core import trainer as TT
from repro_torch.data import LogConfig, generate_log
from repro_torch.kernels import ops as TK
from repro_torch.kernels.cascade_score import kernel as score_kernel
from repro_torch.kernels.cascade_score.ref import cascade_score_bwd_ref
from torch_parity import cascades, close, exact, n, t

BWD_RTOL, BWD_ATOL = 1e-4, 5e-5
GRAD_TOL = 1e-5
TRAJ_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
# bfloat16 inputs exercise only the up-cast on top of the float32 math;
# they ride the full tier-1 run (slow), as the reference's own do.
_BF16 = pytest.param(jnp.bfloat16, marks=pytest.mark.slow, id="bf16")


def _case(n_items, d, t_stages, seed):
    """x (N, d), w (T, d) at 0.3 scale, zq (T,), float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_items, d)).astype(np.float32),
            (0.3 * rng.normal(size=(t_stages, d))).astype(np.float32),
            rng.normal(size=(t_stages,)).astype(np.float32))


def _both(arrays, dtype):
    """The arrays as JAX arrays of `dtype` and as the same values, bit for
    bit, in torch."""
    j = [jnp.asarray(a, dtype) for a in arrays]
    return j, [exact(a) for a in j]


# ---------------------------------------------------------------------------
# K6 forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items", [1, 7, 512, 1000])
@pytest.mark.parametrize("d,t_stages", [(24, 3), (8, 1), (40, 5)])
@pytest.mark.parametrize("dtype", [pytest.param(jnp.float32, id="f32"),
                                   _BF16])
def test_score_plain_matches_reference_kernel(n_items, d, t_stages, dtype):
    (jx, jw, jz), (x, w, zq) = _both(
        _case(n_items, d, t_stages, seed=n_items * 131 + d), dtype)
    got = TK.cascade_score(x, w, zq)
    assert tuple(got.shape) == (n_items, t_stages)
    assert got.dtype == torch.float32
    want = JK.cascade_score(jx, jw, jz, interpret=True)
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    close(got, want, rtol=tol, atol=tol)
    close(got, JK.cascade_score_ref(jx, jw, jz), rtol=tol, atol=tol)


def test_score_is_cumulative():
    """Output column j is column j-1 plus a non-positive increment."""
    x, w, _ = _case(256, 24, 4, seed=0)
    out = n(TK.cascade_score(t(x), t(w), torch.zeros(4)))
    assert (np.diff(out, axis=1) <= 1e-6).all()


def test_score_zero_rows_stay_inert():
    x, w, zq = _case(16, 24, 3, seed=1)
    x[5:] = 0.0
    got = n(TK.cascade_score(t(x), t(w), t(zq)))
    want = np.cumsum(-np.log1p(np.exp(-zq)), axis=-1)       # log sigma(zq)
    np.testing.assert_allclose(got[5:], np.broadcast_to(want, (11, 3)),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K6 backward: the closed form, and gradients through the op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items,d,t_stages", [(7, 5, 1), (64, 24, 3),
                                                (130, 24, 3), (512, 40, 8)])
def test_score_bwd_plain_matches_reference_kernel(n_items, d, t_stages):
    rng = np.random.default_rng(n_items + d + t_stages)
    x, w, zq, g = (rng.normal(size=s).astype(np.float32) for s in
                   ((n_items, d), (t_stages, d), (t_stages,),
                    (n_items, t_stages)))
    got = cascade_score_bwd_ref(t(x), t(w), t(zq), t(g))
    want = jscore_bwd(*map(jnp.asarray, (x, w, zq, g)), interpret=True)
    for name, a, b in zip(("dx", "dw_eff", "dzq"), got, want):
        assert a.dtype == torch.float32, name
        close(a, b, rtol=BWD_RTOL, atol=BWD_ATOL)


def test_grads_through_op_match_reference():
    """(lp ** 2).sum() differentiated through the port's op (its closed-form
    backward) against jax.grad through the reference's op with both Pallas
    kernels interpreted; the x gradient too."""
    rng = np.random.default_rng(1)
    x, w, zq = (rng.normal(size=s).astype(np.float32)
                for s in ((50, 24), (3, 24), (3,)))
    want = jax.grad(lambda *a: (JK.cascade_score(*a, interpret=True) ** 2)
                    .sum(), (0, 1, 2))(*map(jnp.asarray, (x, w, zq)))
    args = [t(a).requires_grad_(True) for a in (x, w, zq)]
    (TK.cascade_score(*args) ** 2).sum().backward()
    for a, b in zip(args, want):
        close(a.grad, b, rtol=GRAD_TOL, atol=GRAD_TOL)


def _vmap_loss_case():
    rng = np.random.default_rng(2)
    return (rng.normal(size=(4, 16, 24)).astype(np.float32),
            rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(3, 24)).astype(np.float32))


def _port_vmap_grads(xb, zb, w):
    """d/d(w, zq) of sum(vmap(op)(x, zq)) in the port."""
    wt, zt = t(w).requires_grad_(True), t(zb).requires_grad_(True)
    lp = torch.func.vmap(lambda xx, zz: TK.cascade_score(xx, wt, zz))(
        t(xb), zt)
    lp.sum().backward()
    return lp, wt.grad, zt.grad


@pytest.mark.slow           # interpret-mode vmap compile is the cost here
def test_vmap_grads_match_reference_vmap():
    """The losses vmap the scorer over query groups: torch.func.vmap plus
    backward against jax.vmap plus jax.grad, both kernels interpreted."""
    xb, zb, w = _vmap_loss_case()

    def loss(w_, zb_):
        return jax.vmap(lambda xx, zz: JK.cascade_score(
            xx, w_, zz, interpret=True))(jnp.asarray(xb), zb_).sum()

    want = jax.grad(loss, (0, 1))(jnp.asarray(w), jnp.asarray(zb))
    _, gw, gz = _port_vmap_grads(xb, zb, w)
    close(gw, want[0], rtol=GRAD_TOL, atol=GRAD_TOL)
    close(gz, want[1], rtol=GRAD_TOL, atol=GRAD_TOL)


def test_vmap_runs_one_call_per_group_each_way(monkeypatch):
    """Under vmap the op runs once per group forward and backward (one K6
    launch each on the card); counted here through the plain versions."""
    calls = {"cascade_score_ref": 0, "cascade_score_bwd_ref": 0}

    def counted(name):
        fn = getattr(TK, name)

        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    for name in calls:
        monkeypatch.setattr(TK, name, counted(name))
    _port_vmap_grads(*_vmap_loss_case())
    assert calls == {"cascade_score_ref": 4, "cascade_score_bwd_ref": 4}


def test_vmap_matches_batched_op():
    """The vmapped single-group op against the port's batched op: the same
    function. Values to 1e-6 and gradients to ROADMAP's 1e-5 (per-group
    sums added by autograd vs one einsum over the batch), not bit for bit
    (ROADMAP Queue 3: the reference's own paths are not bitwise equal)."""
    xb, zb, w = _vmap_loss_case()
    lp, gw, gz = _port_vmap_grads(xb, zb, w)
    wt, zt = t(w).requires_grad_(True), t(zb).requires_grad_(True)
    want = TK.cascade_score_batched(t(xb), wt, zt)
    want.sum().backward()
    close(lp, want, rtol=1e-6, atol=1e-6)
    close(gw, wt.grad, rtol=GRAD_TOL, atol=GRAD_TOL)
    close(gz, zt.grad, rtol=GRAD_TOL, atol=GRAD_TOL)


# ---------------------------------------------------------------------------
# K7: the feature-major scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items,d,t_stages", [(1000, 24, 3), (512, 8, 1),
                                                (2048, 40, 5)])
@pytest.mark.parametrize("dtype", [pytest.param(jnp.float32, id="f32"),
                                   _BF16])
def test_score_fm_plain_matches_reference_kernel(n_items, d, t_stages, dtype):
    (jx, jw, jz), (x, w, zq) = _both(
        _case(n_items, d, t_stages, seed=n_items + d), dtype)
    got = TK.cascade_score_fm(x.T.contiguous(), w, zq)
    assert tuple(got.shape) == (n_items, t_stages)
    want = JK.cascade_score_fm(jx.T, jw, jz, interpret=True)
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    close(got, want, rtol=tol, atol=tol)
    close(got, TK.cascade_score(x, w, zq), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,args", [
    ("cascade_score", lambda x, w, zq: (x[None], w, zq)),
    ("cascade_score", lambda x, w, zq: (x, w, zq[None])),
    ("cascade_score_fm", lambda x, w, zq: (x.T, w[0], zq)),
    ("cascade_score_fm", lambda x, w, zq: (x.T[None], w, zq[None])),
])
def test_rank_errors_match_reference(op, args):
    arrs = _case(8, 24, 3, seed=5)
    with pytest.raises(ValueError) as want:
        getattr(JK, op)(*args(*map(jnp.asarray, arrs)))
    with pytest.raises(ValueError) as got:
        getattr(TK, op)(*args(*map(t, arrs)))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fn,nargs", [(score_kernel.cascade_score, 3),
                                     (score_kernel.cascade_score_bwd, 4),
                                     (score_kernel.cascade_score_fm, 3)])
def test_cuda_wrappers_refuse_cpu_tensors(fn, nargs):
    before = fn.launches
    x, w, zq = map(t, _case(8, 24, 3, seed=6))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*(x, w, zq, torch.zeros(8, 3))[:nargs])
    assert fn.launches == before


def test_wrappers_check_shapes():
    w, zq = torch.zeros(3, 24), torch.zeros(3)
    assert score_kernel.check_single_shapes("op", 10, 24, w, zq) == 3
    with pytest.raises(ValueError, match="stages"):
        score_kernel.check_single_shapes("op", 10, 24, torch.zeros(9, 24),
                                         torch.zeros(9))
    with pytest.raises(ValueError, match="do not agree"):
        score_kernel.check_single_shapes("op", 10, 8, w, zq)
    with pytest.raises(ValueError, match="do not agree"):
        score_kernel.check_single_shapes("op", 10, 24, w, torch.zeros(2))
    with pytest.raises(ValueError, match="at most"):
        score_kernel.check_single_shapes("op", 2**31, 24, w, zq)


# ---------------------------------------------------------------------------
# training L3 through the vmapped single-group op
# ---------------------------------------------------------------------------

def _port_vmap_score(x, w_eff, zq):
    return torch.func.vmap(lambda xb, zb: TK.cascade_score(xb, w_eff, zb))(
        x, zq)


def _jax_vmap_score(x, w_eff, zq):
    """benchmarks/train_bench.py's `_vmap_score`: jax.vmap of the
    reference's single-group op."""
    return jax.vmap(lambda xb, zb: JK.cascade_score(xb, w_eff, zb))(x, zq)


def test_fit_through_vmapped_op_matches_reference():
    cfg = dict(n_queries=200, items_per_query=16, seed=3)
    tr, _ = generate_log(LogConfig(**cfg)).split(0.8)
    jtr, _ = jgenerate_log(JLogConfig(**cfg)).split(0.8)
    _, _, jcfg, tcfg = cascades(3)
    kw = dict(loss="l3", epochs=2, lr=0.05, batch_groups=16, log_every=1)
    j_losses, t_losses = [], []
    jp = JT.fit(jtr, jcfg, JL.LossConfig(beta=2.0), JT.TrainConfig(**kw),
                callback=lambda s, v: j_losses.append((s, v)),
                loss_fn=functools.partial(JL.loss_l3,
                                          score_fn=_jax_vmap_score))
    tp = TT.fit(tr, tcfg, TL.LossConfig(beta=2.0), TT.TrainConfig(**kw),
                callback=lambda s, v: t_losses.append((s, v)),
                loss_fn=functools.partial(TL.loss_l3,
                                          score_fn=_port_vmap_score),
                init_params=jax.device_get(
                    JC.init_params(jcfg, jax.random.PRNGKey(0))),
                device="cpu")
    assert len(t_losses) == 20                   # 160 groups / 16, 2 epochs
    assert [s for s, _ in t_losses] == [s for s, _ in j_losses]
    close([v for _, v in t_losses], [v for _, v in j_losses],
          rtol=TRAJ_TOL, atol=TRAJ_TOL)
    jp = jax.device_get(jp)
    assert set(tp) == set(jp)
    for k in jp:
        close(tp[k], jp[k], rtol=PARAM_RTOL, atol=PARAM_ATOL)
