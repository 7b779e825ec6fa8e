"""core.pipeline of the port against the reference: the plan registry,
the keep counts and the stage chain on the reference's own lp, run_cascade
in all three plans, and the Eq-16 latency in both conventions."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import pipeline as JP
from repro_torch.core import pipeline as TP
from repro_torch.kernels.cascade_filter.ref import assert_decision_margin
from torch_parity import cascades, close, n, t


def _batch(b, g, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, g, 24)).astype(np.float32)
    q = np.eye(8, dtype=np.float32)[rng.integers(0, 8, b)]
    mask = (rng.random((b, g)) < 0.85).astype(np.float32)
    m_q = rng.integers(1, 4 * g + 2, b).astype(np.float32)
    return x, q, mask, m_q


def _batch_with_margin(b, g, seed, tp, tcfg):
    for s in range(seed, seed + 20):
        x, q, mask, m_q = _batch(b, g, s)
        lp = TP.run_cascade(tp, tcfg, t(x), t(q), t(mask), t(m_q))["lp"]
        try:
            assert_decision_margin(lp, t(mask), t(m_q))
            return x, q, mask, m_q
        except AssertionError:
            continue
    raise AssertionError("no seed with margin")


def test_plans_and_unknown_plan_error_match_reference():
    assert tuple(TP.PLANS) == tuple(JP.PLANS)
    for name in TP.PLANS:
        assert TP.resolve_plan(name).fused_filter \
            == JP.resolve_plan(name).fused_filter
    with pytest.raises(ValueError) as want:
        JP.resolve_plan("fused")
    with pytest.raises(ValueError) as got:
        TP.resolve_plan("fused")
    assert str(got.value) == str(want.value)
    _, tp, _, tcfg = cascades()
    x, q, mask, m_q = map(t, _batch(1, 4, 0))
    with pytest.raises(ValueError, match="unknown pipeline plan"):
        TP.run_cascade(tp, tcfg, x, q, mask, m_q, fused="fused")


@pytest.mark.parametrize("b,g", [(2, 16), (4, 64), (3, 256)])
def test_keep_counts_and_chain_on_reference_lp(b, g):
    """The stage chain is tested on the reference's own lp."""
    jp, tp, jcfg, tcfg = cascades()
    x, q, mask, m_q = _batch_with_margin(b, g, b * 7 + g, tp, tcfg)
    lp = np.asarray(JP.run_cascade(jp, jcfg, *map(jnp.asarray,
                                                  (x, q, mask, m_q)))["lp"])
    j_counts, j_keep = JP.keep_counts_from_lp(jnp.asarray(lp),
                                              jnp.asarray(mask),
                                              jnp.asarray(m_q))
    t_counts, t_keep = TP.keep_counts_from_lp(t(lp), t(mask), t(m_q))
    close(t_counts, j_counts)
    np.testing.assert_array_equal(n(t_keep), np.asarray(j_keep))
    np.testing.assert_array_equal(
        n(TP.filter_chain(t(lp), t(mask), t_keep)),
        np.asarray(JP.filter_chain(jnp.asarray(lp), jnp.asarray(mask),
                                   j_keep)))


def test_filter_chain_ties_keep_lowest_index():
    lp = t(np.array([[[-1.0], [-0.5], [-0.5], [-0.5], [-2.0]]]))
    surv = n(TP.filter_chain(lp, t(np.ones((1, 5))), t([[2.0]])))
    np.testing.assert_array_equal(surv[0, :, 0], [0, 1, 1, 0, 0])


@pytest.mark.parametrize("plan", ["none", "score", "filter"])
@pytest.mark.parametrize("b,g", [(1, 16), (4, 64), (2, 256)])
def test_run_cascade_matches_reference(plan, b, g):
    jp, tp, jcfg, tcfg = cascades()
    x, q, mask, m_q = _batch_with_margin(b, g, b * 13 + g, tp, tcfg)
    want = JP.run_cascade(jp, jcfg, *map(jnp.asarray, (x, q, mask, m_q)),
                          fused=plan)
    got = TP.run_cascade(tp, tcfg, *map(t, (x, q, mask, m_q)), fused=plan)
    assert set(got) == set(want) == {"lp", "survivors", "scores",
                                     "expected_counts", "n_keep",
                                     "kept_per_stage"}
    for k in ("lp", "scores", "expected_counts"):
        close(got[k], want[k])
    for k in ("survivors", "n_keep", "kept_per_stage"):
        np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("plan", ["score", "filter"])
def test_run_cascade_matches_reference_kernels_interpreted(plan):
    """The same against the reference's Pallas kernels in interpret mode."""
    jp, tp, jcfg, tcfg = cascades()
    x, q, mask, m_q = _batch_with_margin(2, 32, 5, tp, tcfg)
    want = JP.run_cascade(jp, jcfg, *map(jnp.asarray, (x, q, mask, m_q)),
                          fused=plan, interpret=True)
    got = TP.run_cascade(tp, tcfg, *map(t, (x, q, mask, m_q)), fused=plan)
    close(got["lp"], want["lp"])
    np.testing.assert_array_equal(n(got["survivors"]),
                                  np.asarray(want["survivors"]))


def test_plans_agree_with_each_other():
    _, tp, _, tcfg = cascades()
    x, q, mask, m_q = map(t, _batch_with_margin(8, 64, 2, tp, tcfg))
    outs = {p: TP.run_cascade(tp, tcfg, x, q, mask, m_q, fused=p)
            for p in TP.PLANS}
    for p in ("score", "filter"):
        close(outs[p]["lp"], outs["none"]["lp"])
        np.testing.assert_array_equal(n(outs[p]["survivors"]),
                                      n(outs["none"]["survivors"]))


@pytest.mark.parametrize("convention", ["entering", "printed"])
def test_latency_from_counts_matches_reference(convention):
    _, _, jcfg, tcfg = cascades()
    rng = np.random.default_rng(0)
    counts = (rng.random((5, 3)) * 300).astype(np.float32)
    m_q = rng.integers(100, 10_000, 5).astype(np.float32)
    want = JP.latency_from_counts(jnp.asarray(counts), jnp.asarray(m_q),
                                  jcfg, 0.0015, convention)
    got = TP.latency_from_counts(t(counts), t(m_q), tcfg, 0.0015, convention)
    close(got, want)
