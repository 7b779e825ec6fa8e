"""core.cascade of the port against the reference: params carried across
as numpy arrays, and every cascade function on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cascade as JC
from repro_torch.core import cascade as TC
from repro_torch.kernels.cascade_filter.ref import assert_decision_margin
from torch_parity import cascades, close, n, t


def _batch(b=4, g=16, seed=0, d_x=24, d_q=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, g, d_x)).astype(np.float32)
    q = np.eye(d_q, dtype=np.float32)[rng.integers(0, d_q, b)]
    mask = (rng.random((b, g)) < 0.8).astype(np.float32)
    m_q = rng.integers(20, 5000, b).astype(np.float32)
    return x, q, mask, m_q


def test_params_from_numpy_round_trip():
    jp, tp, _, _ = cascades()
    host = jax.device_get(jp)
    assert set(tp) == {"w_x", "w_q", "b"}
    for k in host:
        assert tp[k].dtype == torch.float32 and tp[k].device.type == "cpu"
        np.testing.assert_array_equal(n(tp[k]), np.asarray(host[k]))
    # and back: the port's params as numpy give the reference the same
    # cascade
    again = TC.params_from_numpy({k: n(v) for k, v in tp.items()},
                                 device="cpu")
    for k in tp:
        assert torch.equal(again[k], tp[k])


def test_params_from_numpy_rejects_bad_layouts():
    _, tp, _, _ = cascades()
    host = {k: n(v) for k, v in tp.items()}
    with pytest.raises(ValueError, match="missing"):
        TC.params_from_numpy({"w_x": host["w_x"]}, device="cpu")
    with pytest.raises(ValueError, match="cascade"):
        TC.params_from_numpy({**host, "b": np.zeros(5)}, device="cpu")


def test_config_hashable_and_validated():
    cfg = cascades()[3]
    assert hash(cfg) == hash(TC.CascadeConfig(cfg.n_stages, cfg.d_x, cfg.d_q,
                                              cfg.masks, cfg.stage_times))
    np.testing.assert_array_equal(cfg.t, np.asarray(cfg.stage_times))
    with pytest.raises(ValueError):
        TC.CascadeConfig(3, 24, 8)


@pytest.mark.parametrize("fn", ["stage_logits", "stage_probs", "pass_probs",
                                "log_pass_probs", "final_prob",
                                "final_score"])
def test_cascade_functions_match_reference(fn):
    jp, tp, jcfg, tcfg = cascades()
    x, q, _, _ = _batch()
    want = getattr(JC, fn)(jp, jcfg, jnp.asarray(x), jnp.asarray(q))
    got = getattr(TC, fn)(tp, tcfg, t(x), t(q))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


def test_expected_counts_match_reference():
    jp, tp, jcfg, tcfg = cascades()
    x, q, mask, m_q = _batch(seed=1)
    want = JC.expected_counts_per_query(jp, jcfg, *map(jnp.asarray,
                                                       (x, q, mask, m_q)))
    got = TC.expected_counts_per_query(tp, tcfg, *map(t, (x, q, mask, m_q)))
    close(got, want)


def test_hard_cascade_filter_and_cost_match_reference():
    jp, tp, jcfg, tcfg = cascades()
    x, q, mask, m_q = _batch(b=6, g=32, seed=2)
    assert_decision_margin(TC.log_pass_probs(tp, tcfg, t(x), t(q)), t(mask),
                           t(m_q))
    want = JC.hard_cascade_filter(jp, jcfg, *map(jnp.asarray,
                                                 (x, q, mask, m_q)))
    got = TC.hard_cascade_filter(tp, tcfg, *map(t, (x, q, mask, m_q)))
    close(got["scores"], want["scores"])
    close(got["expected_counts"], want["expected_counts"])
    np.testing.assert_array_equal(n(got["survivors"]),
                                  np.asarray(want["survivors"]))
    np.testing.assert_array_equal(n(got["kept_per_stage"]),
                                  np.asarray(want["kept_per_stage"]))
    close(TC.actual_cost_per_query(got["survivors"], t(mask), tcfg),
          JC.actual_cost_per_query(want["survivors"], jnp.asarray(mask),
                                   jcfg))
