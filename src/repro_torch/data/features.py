"""Feature registry for the e-commerce ranking problem (paper Table 1).

The paper lists query-item features with associated online computation costs
(normalized CPU cost per item). The full Taobao set has "more than 40 features";
the paper publishes five representative ones plus a query-only recalled-count
feature. We reproduce those five with the exact published costs and pad the
registry with additional features in the same three cost tiers so the cascade
has a realistic "dozens of features" to allocate across stages.

Feature informativeness is modelled as inversely related to cost (the paper's
premise: "cheap features ... performance in rank may be not high, while some
more complicated features ... can be more accurate but more expensive").
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Feature:
    name: str
    cost: float          # normalized per-item CPU cost (paper Table 1 units)
    quality: float       # correlation of the feature with the latent relevance
    tier: str            # "statistical" | "predict"


# The five published query-item features (paper Table 1, exact costs).
PAPER_FEATURES: tuple[Feature, ...] = (
    Feature("sales_volume", 0.02, 0.35, "statistical"),
    Feature("postpay_score", 0.09, 0.40, "statistical"),
    Feature("ctr_lr_score", 0.13, 0.55, "predict"),
    Feature("relevance_score", 0.74, 0.80, "predict"),
    Feature("deep_wide_score", 0.84, 0.90, "predict"),
)

# Padding features in the same tiers ("more than 40 features ... not all listed").
_EXTRA: tuple[Feature, ...] = tuple(
    [Feature(f"stat_{i}", c, q, "statistical")
     for i, (c, q) in enumerate([(0.01, 0.22), (0.03, 0.30), (0.02, 0.26),
                                 (0.05, 0.33), (0.04, 0.28), (0.06, 0.31)])]
    + [Feature(f"mid_{i}", c, q, "predict")
       for i, (c, q) in enumerate([(0.10, 0.45), (0.15, 0.52), (0.12, 0.48),
                                   (0.18, 0.50), (0.20, 0.54), (0.16, 0.47)])]
    + [Feature(f"deep_{i}", c, q, "predict")
       for i, (c, q) in enumerate([(0.60, 0.72), (0.70, 0.78), (0.65, 0.74),
                                   (0.80, 0.82), (0.75, 0.76), (0.90, 0.85),
                                   (0.55, 0.70)])]
)

ALL_FEATURES: tuple[Feature, ...] = PAPER_FEATURES + _EXTRA
FEATURE_NAMES: tuple[str, ...] = tuple(f.name for f in ALL_FEATURES)
N_FEATURES: int = len(ALL_FEATURES)           # 24 query-item features
FEATURE_COSTS: np.ndarray = np.array([f.cost for f in ALL_FEATURES])
FEATURE_QUALITY: np.ndarray = np.array([f.quality for f in ALL_FEATURES])

# Query-only feature: one-hot bucket of the recalled-item count M_q
# ("does not affect the result order but determines the size of each stage").
N_QUERY_BUCKETS: int = 8
RECALL_BUCKET_EDGES: np.ndarray = np.geomspace(50, 200_000, N_QUERY_BUCKETS - 1)


def recall_bucket(m_q: np.ndarray) -> np.ndarray:
    """One-hot bucket index of the recalled-item count."""
    return np.digitize(m_q, RECALL_BUCKET_EDGES)


def default_stage_masks(n_stages: int = 3) -> np.ndarray:
    """Binary (T, d_x) assignment of features to cascade stages by cost tier.

    Stage 1: ultra-cheap statistical features (cost <= 0.02, comparable to
    the 2-stage heuristic's sales-volume scan) — the paper's first stage
    uses "a few efficient features ... for quickly eliminating irrelevant
    items". Stage 2 adds mid-cost predictive scores, the final stage adds
    the expensive relevance / deep-network scores.
    """
    costs = FEATURE_COSTS
    if n_stages == 1:
        return np.ones((1, N_FEATURES))
    if n_stages == 2:
        edges = [0.02, np.inf]
    elif n_stages == 3:
        edges = [0.02, 0.25, np.inf]
    else:  # spread cost quantiles across stages
        qs = np.quantile(costs, np.linspace(0, 1, n_stages + 1)[1:])
        qs[-1] = np.inf
        edges = list(qs)
    masks = np.zeros((n_stages, N_FEATURES))
    lo = -np.inf
    for j, hi in enumerate(edges):
        masks[j] = ((costs > lo) & (costs <= hi)).astype(np.float64)
        lo = hi
    # every stage must see at least one feature
    assert (masks.sum(axis=1) > 0).all(), "empty cascade stage feature set"
    return masks


def stage_costs(masks: np.ndarray) -> np.ndarray:
    """Per-item cost t_j of evaluating stage j = sum of newly-computed feature
    costs in that stage (features already computed in earlier stages are free)."""
    seen = np.zeros(N_FEATURES, dtype=bool)
    out = np.zeros(masks.shape[0])
    for j in range(masks.shape[0]):
        new = (masks[j] > 0) & ~seen
        out[j] = FEATURE_COSTS[new].sum()
        seen |= masks[j] > 0
    return out
