"""The port's kernel modules on the CPU: each kernel's plain PyTorch
version against the reference's Pallas kernel in interpret mode and its
XLA reference, on the same numpy inputs; K2's threshold select (the CUDA
kernel's algorithm, written out in plain code) against the all-pairs
stable rank, exactly, at ties, signed zeros, -inf survivors, NaN and
n_keep past the survivors; the device dispatch of kernels.ops; and the
CUDA wrappers' refusal of what their kernels do not take. The CUDA kernels
themselves are held to these plain versions on the card by chip_smoke.py.

Tolerances of the training kernels (K3-K5): rtol 1e-5 / atol 1e-5 on
values, rtol 1e-4 / atol 5e-5 on the backward's outputs — the reference's
own bars between its interpreted kernels and its XLA references
(tests/test_cascade_loss.py); the sums (over up to 130 items, of terms up
to ~1e2) are taken in another order. K4's NLL partial against the
interpreted kernel: rtol 2e-5, because the plain version computes it in
probability space as the reference's XLA reference does, and on the case
G=130, d=24, T=1 that reference and the reference's own kernel differ by
1.33e-5 relative (log1p(-exp(lp)) near lp = 0 magnifies an ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro.kernels.cascade_filter.kernel import cascade_filter as jfilter
from repro.kernels.cascade_filter.ref import cascade_filter_ref as jfilter_ref
from repro.kernels.cascade_loss import kernel as jloss
from repro.kernels.cascade_loss import ref as jloss_ref
from repro.kernels.cascade_score.kernel import (
    cascade_score_batched_bwd as jscore_bwd)
from repro.kernels.cascade_score.ref import cascade_score_batched_ref as jscore_ref
from repro.kernels.cascade_score.ref import cascade_score_bwd_ref as jscore_bwd_ref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TK
from repro_torch.kernels.cascade_filter import kernel as filter_kernel
from repro_torch.core.pipeline import filter_chain
from repro_torch.kernels.cascade_filter.ref import (assert_decision_margin,
                                                    order_key,
                                                    threshold_chain,
                                                    threshold_select)
from repro_torch.kernels.cascade_loss import kernel as loss_kernel
from repro_torch.kernels.cascade_loss.ref import (cascade_loss_bwd_ref,
                                                  cascade_loss_ref)
from repro_torch.kernels.cascade_score import kernel as score_kernel
from repro_torch.kernels.cascade_score.ref import cascade_score_batched_bwd_ref
from repro_torch.kernels.query_bias import kernel as qb_kernel
from torch_parity import (at_offset, close, filter_case, loss_case, n, t,
                          with_margin)

# ---------------------------------------------------------------------------
# K1: cascade_score_batched
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,g", [(1, 1), (3, 7), (2, 64), (4, 130)])
@pytest.mark.parametrize("d,t_stages", [(24, 3), (8, 1), (40, 5), (24, 8)])
def test_score_plain_matches_reference_kernel(b, g, d, t_stages):
    x, w, zq, _, _ = filter_case(b, g, d, t_stages, seed=b * 101 + g + d)
    got = TK.cascade_score_batched(t(x), t(w), t(zq))
    assert tuple(got.shape) == (b, g, t_stages) and got.dtype == torch.float32
    want_kernel = JK.cascade_score_batched(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(zq), interpret=True)
    want_ref = jscore_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(zq))
    close(got, want_kernel)
    close(got, want_ref)


def test_score_padded_rows_stay_inert():
    """All-zero padded rows score log sigmoid(zq) cumulated, as in the
    reference, and never NaN."""
    x, w, zq, _, _ = filter_case(2, 16, 24, 3, seed=0)
    x[:, 10:] = 0.0
    got = n(TK.cascade_score_batched(t(x), t(w), t(zq)))
    want = np.cumsum(-np.log1p(np.exp(-zq)), axis=-1)       # log sigma(zq)
    np.testing.assert_allclose(got[:, 10:], np.broadcast_to(
        want[:, None, :], got[:, 10:].shape), rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all()


def test_score_is_cumulative():
    x, w, zq, _, _ = filter_case(2, 256, 24, 4, seed=1)
    out = n(TK.cascade_score_batched(t(x), t(w), t(zq)))
    assert (np.diff(out, axis=-1) <= 1e-6).all()


# ---------------------------------------------------------------------------
# K2: cascade_filter
# ---------------------------------------------------------------------------

def _assert_filter_parity(case, *, interpret=True):
    x, w, zq, mask, m_q = case
    got = TK.cascade_filter(*map(t, case))
    assert_decision_margin(got["lp"], t(mask), t(m_q))
    refs = [jfilter_ref(*map(jnp.asarray, case))]
    if interpret:
        refs.append(jfilter(*map(jnp.asarray, case), interpret=True))
    for want in refs:
        close(got["lp"], want["lp"])
        close(got["expected_counts"], want["expected_counts"])
        np.testing.assert_array_equal(n(got["n_keep"]),
                                      np.asarray(want["n_keep"]))
        np.testing.assert_array_equal(n(got["survivors"]),
                                      np.asarray(want["survivors"]))
    return got


@pytest.mark.parametrize("g", [1, 7, 48])
@pytest.mark.parametrize("d,t_stages", [(24, 3), (8, 1), (40, 5)])
def test_filter_plain_matches_reference_kernel(g, d, t_stages):
    case = with_margin(lambda s: filter_case(2, g, d, t_stages, s),
                       seed=g * 37 + d)
    _assert_filter_parity(case)


@pytest.mark.parametrize("g", [130, 256, 512])
def test_filter_plain_matches_reference_at_serving_groups(g):
    case = with_margin(lambda s: filter_case(4, g, 24, 3, s), seed=g)
    _assert_filter_parity(case, interpret=False)


@pytest.mark.parametrize("g", [7, 130])
@pytest.mark.parametrize("d", [5, 13, 27])
def test_score_and_filter_plain_match_reference_at_d_not_a_multiple_of_4(d, g):
    """d % 4 != 0: the layout the CUDA kernels read with their scalar
    paths (K1's 4-byte copies, K2's per-group column chunks)."""
    case = with_margin(lambda s: filter_case(3, g, d, 3, s), seed=g * 3 + d)
    x, w, zq = case[:3]
    got = TK.cascade_score_batched(t(x), t(w), t(zq))
    close(got, JK.cascade_score_batched(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(zq), interpret=True))
    close(got, jscore_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(zq)))
    _assert_filter_parity(case, interpret=g <= 48)


@pytest.mark.parametrize("d", [24, 13])
def test_score_and_filter_plain_on_x_at_a_4_byte_offset(d):
    """x contiguous but 4 bytes past a 16-byte boundary (the CUDA kernels'
    scalar paths on the card): the plain versions give the reference's
    values and decisions."""
    x, w, zq, mask, m_q = with_margin(lambda s: filter_case(2, 64, d, 3, s),
                                      seed=d)
    xo = at_offset(t(x))
    got = TK.cascade_score_batched(xo, t(w), t(zq))
    close(got, jscore_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(zq)))
    res = TK.cascade_filter(xo, t(w), t(zq), t(mask), t(m_q))
    want = jfilter(*map(jnp.asarray, (x, w, zq, mask, m_q)), interpret=True)
    close(res["lp"], want["lp"])
    close(res["expected_counts"], want["expected_counts"])
    for k in ("n_keep", "survivors"):
        np.testing.assert_array_equal(n(res[k]), np.asarray(want[k]))


def test_filter_tied_scores():
    """Duplicated items tie exactly; the stable rank keeps the lowest
    index, as the reference's stable argsort does."""
    def make(s):
        x, w, zq, mask, m_q = filter_case(3, 64, 24, 3, s)
        x[:, 1::2] = x[:, ::2]
        return x, w, zq, np.ones_like(mask), m_q
    got = _assert_filter_parity(with_margin(make, seed=0))
    surv = n(got["survivors"])
    assert 0 < surv[..., -1].sum() < surv.shape[0] * surv.shape[1]


def test_filter_fully_masked_group():
    def make(s):
        x, w, zq, mask, m_q = filter_case(3, 32, 24, 3, s)
        mask[1] = 0.0
        return x, w, zq, mask, m_q
    got = _assert_filter_parity(with_margin(make, seed=1))
    assert n(got["survivors"])[1].sum() == 0
    assert (n(got["n_keep"])[1] == 1).all()


def test_filter_mq_exceeds_group():
    """m_q >> G: keep counts clip at the group size, keeping all."""
    def make(s):
        x, w, zq, mask, m_q = filter_case(2, 16, 24, 2, s)
        return (x, w, np.full_like(zq, 8.0), np.ones_like(mask),
                np.full_like(m_q, 1e6))
    got = _assert_filter_parity(with_margin(make, seed=2))
    assert (n(got["n_keep"]) == 16).all()
    assert (n(got["survivors"])[..., -1] == 1).all()


def test_filter_chain_is_nested():
    """Stage j survivors are a subset of stage j-1 survivors."""
    case = with_margin(lambda s: filter_case(4, 96, 24, 4, s), seed=3)
    got = _assert_filter_parity(case)
    surv = n(got["survivors"])
    assert (np.diff(surv, axis=-1) <= 0).all()
    assert (surv[..., 0] <= case[3]).all()


def test_margin_check_flags_boundary_inputs():
    """A keep count that lands on an integer, and two survivors 1e-6 apart
    at a cut, are refused before any exact comparison."""
    lp = torch.log(torch.full((1, 4, 1), 0.5))      # sum exp(lp) = 2
    with pytest.raises(AssertionError, match="keep-count margin"):
        assert_decision_margin(lp, torch.ones(1, 4), torch.tensor([4.0]))
    lp = torch.tensor([[[-1.0], [-1.000001], [-9.0], [-9.0]]])
    m = torch.tensor([1.0])
    with pytest.raises(AssertionError, match="tie margin"):
        # sum exp(lp) = 0.736 + 2e-4 -> n_keep 1: the cut falls between the
        # two near-equal scores
        assert_decision_margin(lp, torch.ones(1, 4), m)
    assert_decision_margin(torch.tensor([[[-1.0], [-1.0], [-9.0]]]),
                           torch.ones(1, 3), m)     # an exact tie is fine


# ---------------------------------------------------------------------------
# K2's select rule (order-preserving key, threshold, tie prefix) in plain
# code, held to the all-pairs rank it replaces in the CUDA kernel
# ---------------------------------------------------------------------------

def _all_pairs_keep(s, n_keep):
    """rank_i = #{k : s_k > s_i} + #{k < i : s_k == s_i} over the group
    (NaN compares false), kept iff rank_i < n_keep: the rank the CUDA
    kernel computed before, pair by pair."""
    idx = torch.arange(s.shape[1])
    gt = (s[:, None, :] > s[:, :, None]).sum(-1)
    eq = ((s[:, None, :] == s[:, :, None])
          & (idx[None, :] < idx[:, None])).sum(-1)
    return gt + eq < n_keep[:, None]


def _all_pairs_chain(lp, mask, n_keep):
    surv = mask.float()
    cols = []
    for j in range(lp.shape[-1]):
        alive = surv > 0
        s = torch.where(alive, lp[..., j], -torch.inf)
        keep = _all_pairs_keep(s, n_keep[:, j])
        surv = torch.where(alive, surv * keep.float(), surv)
        cols.append(surv)
    return torch.stack(cols, dim=-1)


def _select_case(name, rng):
    """(scores (B, G), n_keep (B,)) for one edge of the select."""
    b, g = 6, 64
    s = rng.normal(size=(b, g)).astype(np.float32)
    dead = rng.random((b, g)) < 0.2
    if name == "twins":
        s[:, 1::2] = s[:, ::2]
    elif name == "signed_zeros":
        s[:, ::3] = 0.0
        s[:, 1::3] = -0.0
    elif name == "ties_across_cut":
        s = np.round(s).astype(np.float32)           # a handful of levels
    elif name == "fully_masked":
        dead[:] = True
    elif name == "neg_inf_survivors":
        s[:, ::5] = -np.inf                          # survivors at -inf too
    elif name == "nan":
        s[:, ::7] = np.nan
    elif name == "group_512":
        g = 512
        s = rng.normal(size=(b, g)).astype(np.float32)
        s[:, 1::4] = s[:, ::4]
        dead = rng.random((b, g)) < 0.2
    elif name == "tiny_and_huge":
        s = (s * np.float32(1e-38)).astype(np.float32)
        s[:, ::4] = np.float32(3e38)
        s[:, 2::4] = np.float32(-3e38)
    s = np.where(dead, -np.inf, s).astype(np.float32)
    n_keep = rng.integers(1, g + 1, size=b)
    if name == "keep_exceeds_survivors":
        n_keep = np.full(b, g)
        n_keep[:3] = (~dead[:3]).sum(-1) + 1
    n_keep[0] = max(1, (~dead[0]).sum() // 2)        # a cut inside
    return torch.from_numpy(s), torch.from_numpy(n_keep).float()


@pytest.mark.parametrize("name", [
    "random", "twins", "signed_zeros", "ties_across_cut", "fully_masked",
    "keep_exceeds_survivors", "group_512", "neg_inf_survivors", "nan",
    "tiny_and_huge"])
def test_threshold_select_matches_all_pairs_rank(name):
    """The plain version of the CUDA kernel's threshold select keeps the
    same items as the all-pairs stable rank, exactly, at ties (twins,
    +0.0 and -0.0, equal scores across the cut), non-survivors at -inf
    (also among survivors), NaN scores and n_keep at or past the
    survivors, in groups of up to 512."""
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    for _ in range(5):
        s, n_keep = _select_case(name, rng)
        got = threshold_select(s, n_keep)
        want = _all_pairs_keep(s, n_keep)
        assert torch.equal(got, want), (s, n_keep)


def test_order_key_orders_as_float_compare():
    vals = torch.tensor([-torch.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45,
                         1.0, 3e38, torch.inf])
    keys = order_key(vals)
    assert (keys >= 0).all() and (keys < 2**32).all()
    for a in range(len(vals)):
        for c in range(len(vals)):
            assert bool(vals[a] > vals[c]) == bool(keys[a] > keys[c])
            assert bool(vals[a] == vals[c]) == bool(keys[a] == keys[c])


@pytest.mark.parametrize("g", [1, 7, 64, 256, 512])
def test_threshold_chain_matches_filter_chain(g):
    """The stage chain through the select (with the kernel's keep-all
    shortcut) against core.pipeline's argsort chain and the all-pairs
    chain, on filter_case scores, on scores with twins, and on a fully
    masked group."""
    x, w, zq, mask, m_q = map(t, filter_case(4, g, 24, 3, seed=g))
    x[:, 1::2] = x[:, ::2][:, :g // 2]
    mask[2] = 0.0
    for xx in (x, t(filter_case(4, g, 24, 3, seed=g + 1)[0])):
        lp = TK.cascade_score_batched_ref(xx, w, zq)
        n_keep = TK.cascade_filter_ref(xx, w, zq, mask, m_q)["n_keep"]
        got = threshold_chain(lp, mask, n_keep)
        assert torch.equal(got, filter_chain(lp, mask, n_keep))
        assert torch.equal(got, _all_pairs_chain(lp, mask, n_keep))


def test_threshold_chain_at_neg_inf_survivors():
    """A survivor whose lp is -inf ties the non-survivors before it (the
    rank's rule), which the kernel's shortcut must not skip."""
    lp = torch.tensor([[[-torch.inf], [-1.0], [-torch.inf], [-2.0]]])
    mask = torch.tensor([[0.0, 1.0, 1.0, 1.0]])
    n_keep = torch.tensor([[3.0]])
    got = threshold_chain(lp, mask, n_keep)
    assert torch.equal(got, _all_pairs_chain(lp, mask, n_keep))
    assert got[0, :, 0].tolist() == [0.0, 1.0, 0.0, 1.0]


# ---------------------------------------------------------------------------
# ops dispatch and the CUDA wrappers' checks (no card needed)
# ---------------------------------------------------------------------------

def test_ops_cpu_tensors_take_the_plain_versions_and_build_nothing():
    TK.reset_launch_counts()
    x, w, zq, mask, m_q = map(t, filter_case(2, 8, 24, 3, seed=4))
    wg = w.clone().requires_grad_(True)
    TK.cascade_score_batched(x, wg, zq).sum().backward()
    TK.cascade_filter(x, w, zq, mask, m_q)
    xc = torch.cat([x, torch.ones(2, 8, 4)], dim=-1)
    sum(o.sum() for o in TK.cascade_loss_fused(xc, wg, zq)).backward()
    TK.swa_decode(torch.randn(2, 4, 64), torch.randn(2, 9, 2, 64),
                  torch.randn(2, 9, 2, 64), 5)
    TK.swa_decode_partial(torch.randn(2, 4, 64), torch.randn(2, 9, 2, 64),
                          torch.randn(2, 9, 2, 64), 2, 7)
    TK.cascade_score(x[0], wg, zq[0]).sum().backward()
    TK.cascade_score_fm(x[0].T, w, zq[0])
    TK.query_bias(torch.randn(2, 8), torch.randn(3, 8), torch.randn(3))
    assert TK.launch_counts() == {
        "cascade_score_batched": 0, "cascade_filter": 0,
        "cascade_score_batched_bwd": 0, "cascade_loss": 0,
        "cascade_loss_bwd": 0, "swa_decode": 0, "swa_decode_partial": 0,
        "cascade_score": 0, "cascade_score_bwd": 0, "cascade_score_fm": 0,
        "query_bias": 0}
    assert _build._lib is None


@pytest.mark.parametrize("op,args", [
    ("cascade_score_batched", lambda x, w, zq, m, mq: (x[0], w, zq)),
    ("cascade_filter", lambda x, w, zq, m, mq: (x, w, zq, m, mq[:, None])),
    ("cascade_loss_fused", lambda x, w, zq, m, mq: (x[0], w, zq)),
    ("cascade_loss_fused", lambda x, w, zq, m, mq: (x, w, zq, zq[0])),
])
def test_ops_rank_errors_match_reference(op, args):
    arrs = filter_case(2, 8, 24, 3, seed=5)
    with pytest.raises(ValueError) as want:
        getattr(JK, op)(*args(*map(jnp.asarray, arrs)))
    with pytest.raises(ValueError) as got:
        getattr(TK, op)(*args(*map(t, arrs)))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fn,nargs", [
    (score_kernel.cascade_score_batched, 3),
    (filter_kernel.cascade_filter, 5),
    (score_kernel.cascade_score_batched_bwd, 4),
    (loss_kernel.cascade_loss, 3),
    (loss_kernel.cascade_loss_bwd, 6),
    (qb_kernel.query_bias, 3)])
def test_cuda_wrappers_refuse_cpu_tensors(fn, nargs):
    before = fn.launches
    args = list(map(t, filter_case(2, 8, 24, 3, seed=6)))
    args = (args + args)[:nargs]
    if fn is qb_kernel.query_bias:          # q (R, d_q), w_q (T, d_q), b (T,)
        args = [args[0][0], args[1], args[2][0]]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args)
    assert fn.launches == before


# ---------------------------------------------------------------------------
# query_bias, and the plain scorer's rows independent of the batch
# ---------------------------------------------------------------------------

def _rows_by_b(fn, n_rows, bs):
    """fn(lo, hi) on row slices of every size in bs, stitched back
    together in row order, one result per b."""
    return {b: torch.cat([fn(s, min(s + b, n_rows))
                          for s in range(0, n_rows, b)]) for b in bs}


def test_query_bias_plain_rows_do_not_depend_on_the_batch():
    """The same rows at b = 1, 2, 3, 8 and 16 give identical bits, within
    1e-6 of the reference's q @ w_q.T + b; the one-hot query buckets the
    log draws give exactly w_q's column plus b."""
    rng = np.random.default_rng(21)
    q = rng.normal(size=(48, 8)).astype(np.float32)
    w_q = (0.3 * rng.normal(size=(3, 8))).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    got = _rows_by_b(lambda lo, hi: TK.query_bias(t(q[lo:hi]), t(w_q), t(b)),
                     len(q), (1, 2, 3, 8, 16))
    for zq in got.values():
        assert zq.dtype == torch.float32 and tuple(zq.shape) == (48, 3)
        assert torch.equal(zq, got[1])
    close(got[1], jnp.asarray(q) @ jnp.asarray(w_q).T + jnp.asarray(b),
          rtol=1e-6, atol=1e-6)
    hot = np.eye(8, dtype=np.float32)[[0, 3, 7]]
    assert torch.equal(TK.query_bias(t(hot), t(w_q), t(b)),
                       t(w_q[:, [0, 3, 7]].T + b))


@pytest.mark.parametrize("g", [1, 5, 8, 64])
def test_plain_scorer_rows_do_not_depend_on_the_batch(g):
    """K1's and K2's plain versions give a group the same bits at every
    batch size (a CPU matmul would not, below 16 rows): what lets a
    request served in a chunk of any size equal its solo serve."""
    x, w, zq, mask, m_q = map(t, filter_case(32, g, 24, 3, seed=g))
    for out in (_rows_by_b(lambda lo, hi: TK.cascade_score_batched(
                    x[lo:hi], w, zq[lo:hi]), 32, (1, 2, 3, 8, 16, 32)),
                _rows_by_b(lambda lo, hi: TK.cascade_filter(
                    x[lo:hi], w, zq[lo:hi], mask[lo:hi], m_q[lo:hi])["lp"],
                    32, (1, 2, 3, 8, 16, 32))):
        for lp in out.values():
            assert torch.equal(lp, out[32])


def test_build_key_follows_the_sources():
    key = _build._digest()
    assert key == _build._digest() and len(key) == 16
    assert all((_build.CSRC / s).exists() for s in _build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# K3: cascade_score_batched_bwd; K4 / K5: cascade_loss / cascade_loss_bwd
# ---------------------------------------------------------------------------

# Every G in {1, 7, 130}, d in {8, 24}, T in {1, 3, 8} meets the interpreted
# kernels in the fast set or the slow sweep; the JAX XLA references (eager
# and cheaper to reach) take the fast set.
TRAIN_FAST = [(1, 24, 1), (7, 8, 3), (130, 24, 8), (7, 24, 3)]
TRAIN_SLOW = [(g, d, t_) for g in (1, 7, 130) for d in (8, 24)
              for t_ in (1, 3, 8) if (g, d, t_) not in TRAIN_FAST]
# d + 4 not a multiple of 4: K5's scalar path on the card
TRAIN_ODD_D = [(7, 5, 3), (130, 13, 8), (1, 27, 1), (7, 27, 3)]
_TRAIN_GRID = ([pytest.param(*c, id="-".join(map(str, c)))
                for c in TRAIN_FAST + TRAIN_ODD_D]
               + [pytest.param(*c, id="-".join(map(str, c)),
                               marks=pytest.mark.slow) for c in TRAIN_SLOW])
BWD_RTOL, BWD_ATOL = 1e-4, 5e-5


def _cotangents(b, t_, g=None, seed=1):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(b,)), rng.normal(size=(t_,)),
           rng.normal(size=(b, t_))]
    if g is not None:
        out.append(rng.normal(size=(b, g, t_)))
    return [a.astype(np.float32) for a in out]


@pytest.mark.parametrize("g,d,t_stages", _TRAIN_GRID)
def test_score_bwd_plain_matches_reference_kernel(g, d, t_stages):
    b = 3
    x, w, zq, _, _ = filter_case(b, g, d, t_stages, seed=g * 7 + d + t_stages)
    gct = _cotangents(b, t_stages, g)[3]
    gct[1] = 0.0               # a padded group: zero cotangent adds nothing
    got = cascade_score_batched_bwd_ref(t(x), t(w), t(zq), t(gct))
    want = jscore_bwd(*map(jnp.asarray, (x, w, zq, gct)), interpret=True)
    for a, r in zip(got, want):
        close(a, r, rtol=BWD_RTOL, atol=BWD_ATOL)
    assert float(got[0][1].abs().max()) == 0.0
    assert float(got[2][1].abs().max()) == 0.0
    if (g, d, t_stages) in TRAIN_FAST:
        # the closed form, per group, is the reference's single-group ref
        for i in range(b):
            ref = jscore_bwd_ref(x[i], w, zq[i], gct[i])
            close(got[0][i], ref[0], rtol=BWD_RTOL, atol=BWD_ATOL)
            close(got[2][i], ref[2], rtol=BWD_RTOL, atol=BWD_ATOL)


@pytest.mark.parametrize("g,d,t_stages", _TRAIN_GRID)
def test_loss_plain_matches_reference_kernels(g, d, t_stages):
    """K4's and K5's plain versions against the interpreted Pallas kernels;
    group 0 is fully masked."""
    b = 3
    xc, w, zq = loss_case(b, g, d, t_stages, seed=g * 11 + d + t_stages)
    got = cascade_loss_ref(t(xc), t(w), t(zq))
    want = jloss.cascade_loss(*map(jnp.asarray, (xc, w, zq)), d_x=d,
                              interpret=True)
    assert [tuple(a.shape) for a in got] == [(b,), (t_stages,), (b, t_stages)]
    for a, r, rtol in zip(got, want, (2e-5, 1e-5, 1e-5)):
        close(a, r, rtol=rtol, atol=1e-5)
    assert float(got[0][0]) == 0.0 and float(got[2][0].abs().max()) == 0.0
    g_ll, g_cost, g_cnt = _cotangents(b, t_stages)
    got_b = cascade_loss_bwd_ref(*map(t, (xc, w, zq, g_ll, g_cost, g_cnt)))
    want_b = jloss.cascade_loss_bwd(
        *map(jnp.asarray, (xc, w, zq, g_ll, g_cost, g_cnt)), d_x=d,
        interpret=True)
    for a, r in zip(got_b, want_b):
        close(a, r, rtol=BWD_RTOL, atol=BWD_ATOL)
    assert float(got_b[0][..., d:].abs().max()) == 0.0      # data lanes
    assert float(got_b[0][0].abs().max()) == 0.0            # masked group
    if (g, d, t_stages) in TRAIN_FAST:
        jref = jloss_ref.cascade_loss_ref(*map(jnp.asarray, (xc, w, zq)))
        for a, r in zip(got, jref):
            close(a, r)
        jref_b = jloss_ref.cascade_loss_bwd_ref(
            *map(jnp.asarray, (xc, w, zq, g_ll, g_cost, g_cnt)))
        for a, r in zip(got_b, jref_b):
            close(a, r, rtol=BWD_RTOL, atol=BWD_ATOL)


def test_loss_underflow_stays_finite():
    """A total log pass-probability below log(FLT_MIN) (8 stages at -12
    nats) keeps the NLL partial finite and equal to the log-space kernel's,
    as in the reference's ref."""
    xc, w, zq = loss_case(2, 8, 4, 8, seed=7, dead_group=False)
    zq = np.full_like(zq, -12.0)
    got = cascade_loss_ref(t(xc), t(w) * 0.0, t(zq), t(zq))
    assert torch.isfinite(got[0]).all()
    want = jloss.cascade_loss(jnp.asarray(xc), jnp.asarray(w) * 0.0,
                              jnp.asarray(zq), d_x=4, interpret=True)
    close(got[0], want[0], rtol=1e-4, atol=1e-4)


def test_training_wrappers_check_shapes_before_launch():
    """The packed width and the cotangent shapes are refused before any
    build or launch (ValueError, not a kernel error)."""
    xc, w, zq = loss_case(2, 4, 8, 2, seed=0)
    with pytest.raises(ValueError, match="packed item width"):
        loss_kernel._check_packed("cascade_loss", t(xc)[..., :-1], t(w),
                                  t(zq))
    with pytest.raises(ValueError, match="stages"):
        score_kernel.check_shapes("cascade_score_batched_bwd", t(xc),
                                  torch.zeros(9, 12), torch.zeros(2, 9), 12)
