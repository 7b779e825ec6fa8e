"""The port's kernel modules on the CPU: each kernel's plain PyTorch
version against the reference's Pallas kernel in interpret mode and its
XLA reference, on the same numpy inputs; the device dispatch of
kernels.ops; and the CUDA wrappers' refusal of what their kernels do not
take. The CUDA kernels themselves are held to these plain versions on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro.kernels.cascade_filter.kernel import cascade_filter as jfilter
from repro.kernels.cascade_filter.ref import cascade_filter_ref as jfilter_ref
from repro.kernels.cascade_score.ref import cascade_score_batched_ref as jscore_ref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TK
from repro_torch.kernels.cascade_filter import kernel as filter_kernel
from repro_torch.kernels.cascade_filter.ref import assert_decision_margin
from repro_torch.kernels.cascade_score import kernel as score_kernel
from torch_parity import close, filter_case, n, t, with_margin

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
# ops dispatch and the CUDA wrappers' checks (no card needed)
# ---------------------------------------------------------------------------

def test_ops_cpu_tensors_take_the_plain_versions_and_build_nothing():
    TK.reset_launch_counts()
    x, w, zq, mask, m_q = map(t, filter_case(2, 8, 24, 3, seed=4))
    TK.cascade_score_batched(x, w, zq)
    TK.cascade_filter(x, w, zq, mask, m_q)
    assert TK.launch_counts() == {"cascade_score_batched": 0,
                                  "cascade_filter": 0}
    assert _build._lib is None


@pytest.mark.parametrize("op,args", [
    ("cascade_score_batched", lambda x, w, zq, m, mq: (x[0], w, zq)),
    ("cascade_filter", lambda x, w, zq, m, mq: (x, w, zq, m, mq[:, None])),
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
    (filter_kernel.cascade_filter, 5)])
def test_cuda_wrappers_refuse_cpu_tensors(fn, nargs):
    before = fn.launches
    args = list(map(t, filter_case(2, 8, 24, 3, seed=6)))[:nargs]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args)
    assert fn.launches == before


def test_build_key_follows_the_sources():
    key = _build._digest()
    assert key == _build._digest() and len(key) == 16
    assert all((_build.CSRC / s).exists() for s in _build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
