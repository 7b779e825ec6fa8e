"""The port's numpy data modules and configs reproduce the reference's
byte for byte: the synthetic log, its split, the feature registry, the
CLOES configuration."""

import dataclasses

import numpy as np
import pytest

from repro.configs import cloes as jcloes
from repro.data import LogConfig as JLogConfig
from repro.data import features as JF
from repro.data import generate_log as jgenerate
from repro_torch.configs import cloes as tcloes
from repro_torch.data import LogConfig as TLogConfig
from repro_torch.data import features as TF
from repro_torch.data import generate_log as tgenerate

FIELDS = ("x", "q", "y", "behavior", "price", "mask", "m_q", "relevance")


def _same_log(a, b):
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert va.dtype == vb.dtype and va.shape == vb.shape, f
        assert va.tobytes() == vb.tobytes(), f


@pytest.mark.parametrize("kw", [dict(n_queries=300, items_per_query=32,
                                     seed=11),
                                dict(n_queries=800, seed=0),
                                dict(n_queries=50, items_per_query=16,
                                     seed=3, zipf_a=1.1)])
def test_generate_log_byte_identical(kw):
    _same_log(jgenerate(JLogConfig(**kw)), tgenerate(TLogConfig(**kw)))


@pytest.mark.parametrize("frac,seed", [(0.8, 0), (0.5, 7)])
def test_split_byte_identical(frac, seed):
    ja, jb = jgenerate(JLogConfig(n_queries=200, seed=5)).split(frac, seed)
    ta, tb = tgenerate(TLogConfig(n_queries=200, seed=5)).split(frac, seed)
    _same_log(ja, ta)
    _same_log(jb, tb)
    assert ja.n_instances == ta.n_instances


def test_feature_registry_identical():
    assert JF.FEATURE_NAMES == TF.FEATURE_NAMES
    assert JF.N_FEATURES == TF.N_FEATURES == 24
    assert JF.N_QUERY_BUCKETS == TF.N_QUERY_BUCKETS
    np.testing.assert_array_equal(JF.FEATURE_COSTS, TF.FEATURE_COSTS)
    np.testing.assert_array_equal(JF.FEATURE_QUALITY, TF.FEATURE_QUALITY)
    m_q = np.array([1, 50, 51, 999, 2e5, 5e5])
    np.testing.assert_array_equal(JF.recall_bucket(m_q),
                                  TF.recall_bucket(m_q))
    for t in (1, 2, 3, 5):
        masks = JF.default_stage_masks(t)
        np.testing.assert_array_equal(masks, TF.default_stage_masks(t))
        np.testing.assert_array_equal(JF.stage_costs(masks),
                                      TF.stage_costs(masks))


def test_cloes_config_identical():
    j, t = jcloes.CASCADE, tcloes.CASCADE
    assert (j.n_stages, j.d_x, j.d_q) == (t.n_stages, t.d_x, t.d_q) \
        == (3, 24, 8)
    assert j.masks == t.masks and j.stage_times == t.stage_times
    for jl, tl in ((jcloes.LOSS, tcloes.LOSS),
                   (jcloes.LOSS_PEAK, tcloes.LOSS_PEAK)):
        assert dataclasses.asdict(jl) == dataclasses.asdict(tl)


def test_loss_config_defaults_identical():
    from repro.core.losses import LossConfig as J
    from repro_torch.core.losses import LossConfig as T
    assert dataclasses.asdict(J()) == dataclasses.asdict(T())
    assert hash(T(beta=5.0)) == hash(T(beta=5.0))
