"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same inputs, made with numpy from a seed, go to the JAX reference and to
the port on the CPU.

Tolerances: continuous outputs (lp, counts, scores, latencies) at
rtol 1e-5 / atol 1e-6 — float32 sums taken in another order; the
reference is not bitwise-consistent with itself on this JAX either.
Discrete outputs (n_keep, survivors, orders, statuses) exactly, after
asserting that the inputs leave every decision a margin
(repro_torch.kernels.cascade_filter.ref.assert_decision_margin)."""

import jax
import numpy as np
import torch

from repro.core import cascade as JC
from repro.data import features as JF
from repro_torch.core import cascade as TC
from repro_torch.kernels.cascade_filter.ref import assert_decision_margin
from repro_torch.kernels.cascade_score.ref import cascade_score_batched_ref

RTOL, ATOL = 1e-5, 1e-6


def t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)


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
