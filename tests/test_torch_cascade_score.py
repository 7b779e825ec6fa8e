"""The port's single-group scorer (K6, `kernels.ops.cascade_score`, with its
backward) and feature-major scorer (K7, `kernels.ops.cascade_score_fm`)
on the CPU, against the reference's Pallas kernels in interpret mode and
its XLA references, on the same numpy inputs; gradients through the op,
alone and under torch.func.vmap against jax.vmap (over every in_dims,
with the op's calls each way: one for the whole batch where x is mapped
and w_eff is not); the piece plan of K6's backward; and `fit` training L3
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


def _count_plain_calls(monkeypatch) -> dict[str, int]:
    """Count the op's calls of its plain forward and backward (one K6
    launch each on the card)."""
    calls = {"cascade_score_ref": 0, "cascade_score_bwd_ref": 0}

    def counted(name):
        fn = getattr(TK, name)

        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    for name in list(calls):
        monkeypatch.setattr(TK, name, counted(name))
    return calls


def test_vmap_runs_one_call_each_way(monkeypatch):
    """Under vmap over the losses' in_dims (x and zq mapped, w_eff not) the
    op runs once for the whole batch forward and once backward (one K6
    launch each way on the card), as jax.vmap gives the reference's kernel
    one grid."""
    calls = _count_plain_calls(monkeypatch)
    _port_vmap_grads(*_vmap_loss_case())
    assert calls == {"cascade_score_ref": 1, "cascade_score_bwd_ref": 1}


# (x, w_eff, zq) batch dims, and the op's calls each way for a batch of
# _B_GRID groups: one for a mapped x with w_eff unmapped, one per group
# otherwise (ops._Score.vmap)
_B_GRID = 3
_IN_DIMS = [
    pytest.param((0, None, 0), 1, id="x0-zq0"),
    pytest.param((1, None, 1), 1, id="x1-zq1"),
    pytest.param((0, None, None), 1, id="x0-zq_shared"),
    pytest.param((1, None, None), 1, id="x1-zq_shared"),
    pytest.param((1, None, 0), 1, id="x1-zq0"),
    pytest.param((0, 0, 0), _B_GRID, id="x0-w0-zq0"),
    pytest.param((None, None, 0), _B_GRID, id="x_shared-zq0"),
]


def _in_dims_case(in_dims, seed):
    """x, w, zq with a batch of _B_GRID at each mapped input's dim."""
    rng = np.random.default_rng(seed)
    shapes = ((9, 8), (3, 8), (3,))
    out = []
    for shape, dim in zip(shapes, in_dims):
        if dim is not None:
            shape = shape[:dim] + (_B_GRID,) + shape[dim:]
        out.append((rng.normal(size=shape) * 0.5).astype(np.float32))
    return out


@pytest.mark.slow           # interpret-mode vmap compile is the cost here
@pytest.mark.parametrize("in_dims,calls_each_way", _IN_DIMS)
def test_vmap_in_dims_match_reference(monkeypatch, in_dims, calls_each_way):
    """torch.func.vmap of the op over each in_dims against jax.vmap of the
    reference's op (both Pallas kernels interpreted): values, and the
    gradients of sum(lp ** 2) in every input; and the op's calls each
    way."""
    arrays = _in_dims_case(in_dims, seed=sum(d or 0 for d in in_dims) + 7)

    def jloss(*a):
        lp = jax.vmap(lambda xx, ww, zz: JK.cascade_score(
            xx, ww, zz, interpret=True), in_axes=in_dims)(*a)
        return (lp ** 2).sum(), lp

    (_, want), want_grads = jax.value_and_grad(jloss, (0, 1, 2),
                                               has_aux=True)(
        *map(jnp.asarray, arrays))
    calls = _count_plain_calls(monkeypatch)
    args = [t(a).requires_grad_(True) for a in arrays]
    lp = torch.func.vmap(TK.cascade_score, in_dims=in_dims)(*args)
    (lp ** 2).sum().backward()
    assert calls == {"cascade_score_ref": calls_each_way,
                     "cascade_score_bwd_ref": calls_each_way}
    close(lp, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(args, want_grads):
        close(a.grad, b, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("n_items", [1, 7, 64, 256, 257, 1000, 4096])
def test_piece_plan_covers_each_row_once(n_items):
    """K6's backward cuts each group into pieces: the plan is a function of
    N alone (a whole group up to WHOLE_GROUP_ROWS items, PIECE_ROWS-row
    pieces past that), and its pieces cover every row exactly once."""
    rows, per_group = score_kernel.piece_plan(n_items)
    if n_items <= score_kernel.WHOLE_GROUP_ROWS:
        assert (rows, per_group) == (n_items, 1)
    else:
        assert rows == score_kernel.PIECE_ROWS
    covered = np.zeros(n_items, int)
    for p in range(per_group):
        covered[p * rows:(p + 1) * rows] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("b,n_items,shared", [(3, 1000, False),
                                              (3, 1000, True),
                                              (5, 7, False), (4, 300, True)])
def test_piece_sums_match_plain_sums(b, n_items, shared):
    """dw and dzq added piece by piece in the kernel's order (each piece's
    partial, then dw over every piece and dzq over each group's pieces, or
    every piece when zq is shared) equal the plain version's sums, at the
    backward's bar (sums over up to 3000 items in another order)."""
    rng = np.random.default_rng(b + n_items)
    d, t_stages = 8, 3
    x, g = (t(rng.normal(size=s).astype(np.float32))
            for s in ((b, n_items, d), (b, n_items, t_stages)))
    w = t((0.3 * rng.normal(size=(t_stages, d))).astype(np.float32))
    zq = t(rng.normal(size=(t_stages,) if shared else (b, t_stages))
           .astype(np.float32))
    _, dw, dzq = cascade_score_bwd_ref(x, w, zq, g)
    rows, per_group = score_kernel.piece_plan(n_items)
    dw_sum = torch.zeros_like(dw)
    dzq_sum = torch.zeros((b, t_stages))
    for gi in range(b):
        for p in range(per_group):
            sl = slice(p * rows, (p + 1) * rows)
            zb = zq if shared else zq[gi]
            _, dw_p, dzq_p = cascade_score_bwd_ref(x[gi, sl], w, zb,
                                                   g[gi, sl])
            dw_sum += dw_p
            dzq_sum[gi] += dzq_p
    close(dw_sum, dw, rtol=BWD_RTOL, atol=BWD_ATOL)
    close(dzq_sum.sum(0) if shared else dzq_sum, dzq, rtol=BWD_RTOL,
          atol=BWD_ATOL)


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


@pytest.mark.parametrize("x_shape,zq_shape,want", [
    ((10, 24), (3,), (1, 10, 24, 3, 3)),
    ((4, 10, 24), (4, 3), (4, 10, 24, 3, 3)),
    ((4, 10, 24), (3,), (4, 10, 24, 3, 0)),
    ((4, 10, 24), (5, 3), "do not agree"),
    ((10, 24), (1, 3), "do not agree"),
    ((2, 4, 10, 24), (3,), "expected"),
])
def test_group_shapes(x_shape, zq_shape, want):
    """K6's wrappers take one group or B groups, with zq per group or one
    zq row shared by every group (stride 0): (B, N, d, T, zq stride)."""
    args = ("op", torch.zeros(x_shape), torch.zeros(3, 24),
            torch.zeros(zq_shape))
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            score_kernel._groups(*args)
    else:
        assert score_kernel._groups(*args) == want


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
