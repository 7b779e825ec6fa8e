"""Synthetic e-commerce search log, calibrated to the paper's published stats.

The paper's 2M-instance Taobao benchmark was never publicly released, so we
generate a log with the same *published* characteristics (§4.1):

- instances sampled from a query log; each instance = (user-)query, item,
  features, match-count M_q (number of recalled items for the query);
- positive:negative ratio about 1:10 per query;
- positives are clicks or purchases (purchases are a subset of clicks);
- query popularity is long-tailed (hot queries recall up to ~1e5+ items, tail
  queries recall tens — paper Fig 4 shows 'storage box' vs 'floor wax');
- feature values are noisy views of a latent query-item relevance, with
  informativeness increasing with feature cost (Table 1).

The generator is seeded and vectorized; 2M instances take a few seconds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import features as F

BEHAVIOR_NONE, BEHAVIOR_CLICK, BEHAVIOR_PURCHASE = 0, 1, 2


@dataclasses.dataclass
class LogConfig:
    n_queries: int = 2000           # distinct queries
    items_per_query: int = 64       # N_q instances sampled per query (padded group)
    zipf_a: float = 1.3             # query popularity exponent
    m_q_min: int = 200              # min recalled items
    m_q_max: int = 500_000          # max recalled items (hot query)
    pos_rate_target: float = 1 / 11  # 1:10 positives:negatives
    purchase_given_click: float = 0.25
    price_mu: float = 3.2           # lognormal price params (≈ e^3.2 ≈ 25 units)
    price_sigma: float = 1.1
    seed: int = 0


@dataclasses.dataclass
class SearchLog:
    """Query-grouped training log.

    Shapes: B = number of query groups, G = items per group, d_x = #features,
    d_q = query-feature dim.
    """
    x: np.ndarray          # (B, G, d_x) query-item features
    q: np.ndarray          # (B, d_q) query-only features (one-hot recall bucket)
    y: np.ndarray          # (B, G) binary label: clicked or purchased
    behavior: np.ndarray   # (B, G) 0 none / 1 click / 2 purchase
    price: np.ndarray      # (B, G) item price
    mask: np.ndarray       # (B, G) valid-item mask (1.0 = real instance)
    m_q: np.ndarray        # (B,) recalled-item count M_q per query
    relevance: np.ndarray  # (B, G) latent ground-truth relevance (for eval only)

    @property
    def n_instances(self) -> int:
        return int(self.mask.sum())

    def flat(self) -> tuple[np.ndarray, ...]:
        """Flatten to instance-level arrays (valid rows only)."""
        m = self.mask.astype(bool)
        qb = np.broadcast_to(self.q[:, None, :], self.x.shape[:2] + self.q.shape[-1:])
        return (self.x[m], qb[m], self.y[m], self.behavior[m], self.price[m])

    def split(self, frac: float, seed: int = 0) -> tuple["SearchLog", "SearchLog"]:
        """Split query groups into train/test (by query, as in per-query CV)."""
        rng = np.random.default_rng(seed)
        b = self.x.shape[0]
        perm = rng.permutation(b)
        k = int(b * frac)
        idx_a, idx_b = perm[:k], perm[k:]
        take = lambda idx: SearchLog(**{
            f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(SearchLog)
        })
        return take(idx_a), take(idx_b)


def generate_log(cfg: LogConfig | None = None) -> SearchLog:
    cfg = cfg or LogConfig()
    rng = np.random.default_rng(cfg.seed)
    B, G, d_x = cfg.n_queries, cfg.items_per_query, F.N_FEATURES

    # --- query popularity and recall size (long-tailed) -----------------
    # lognormal recall sizes (median ~8k, sigma 1.2, clipped to
    # [m_q_min, m_q_max]) — calibrated so the 2-stage heuristic's offline
    # cost ratio reproduces the paper's 0.30 (Table 3) and hot queries reach
    # ~1e5-5e5 recalled items (paper: "features of millions of items").
    log_mq = rng.normal(np.log(8000.0), 1.2, B)
    m_q = np.clip(np.exp(log_mq), cfg.m_q_min, cfg.m_q_max).astype(np.int64)
    pop = (np.argsort(np.argsort(m_q)) + 1.0) / B          # popularity ~ rank

    # query difficulty: hot queries have more relevant inventory on average
    q_bias = rng.normal(0, 0.5, size=(B, 1)) + 0.3 * (pop[:, None] - 0.5)

    # --- latent relevance & labels --------------------------------------
    rel = q_bias + rng.normal(0, 1.0, size=(B, G))
    # calibrate click rate to the 1:10 pos:neg ratio by bisecting the offset
    thresh = np.quantile(rel, 1 - cfg.pos_rate_target)
    lo, hi = -10.0, 10.0
    for _ in range(40):
        mid = (lo + hi) / 2
        if _sigmoid(2.2 * (rel - thresh) + mid).mean() < cfg.pos_rate_target:
            lo = mid
        else:
            hi = mid
    click_logit = 2.2 * (rel - thresh) + (lo + hi) / 2
    click = rng.random((B, G)) < _sigmoid(click_logit)
    purchase = click & (rng.random((B, G)) <
                        cfg.purchase_given_click * _sigmoid(1.5 * (rel - thresh)) * 2)
    behavior = np.where(purchase, BEHAVIOR_PURCHASE,
                        np.where(click, BEHAVIOR_CLICK, BEHAVIOR_NONE))
    y = (behavior > 0).astype(np.float64)

    # --- features: noisy views of relevance, SNR grows with quality -----
    qual = F.FEATURE_QUALITY  # (d_x,)
    noise = rng.normal(0, 1.0, size=(B, G, d_x))
    x = qual[None, None, :] * rel[:, :, None] + np.sqrt(1 - qual ** 2)[None, None, :] * noise
    # statistical features are item-level (shared across the query a bit less
    # informative): add item-popularity confound to sales_volume-like features
    stat_idx = np.array([i for i, f in enumerate(F.ALL_FEATURES) if f.tier == "statistical"])
    x[:, :, stat_idx] += 0.5 * rng.normal(0, 1.0, size=(B, G, 1))

    # --- price (lognormal), independent of relevance --------------------
    price = np.exp(rng.normal(cfg.price_mu, cfg.price_sigma, size=(B, G)))

    # --- query-only feature: one-hot recall bucket ----------------------
    bucket = F.recall_bucket(m_q)
    q = np.eye(F.N_QUERY_BUCKETS)[bucket]

    # --- instance sampling ∝ query traffic -------------------------------
    # The paper's 2M instances are sampled from the live log, so hot queries
    # contribute many more instances than tail queries. We mirror that with a
    # popularity-dependent valid count N_q per group (instance-weighted
    # metrics are then hot-dominated, as in Table 3's COST column).
    n_q = np.clip(np.round(G * pop), 8, G).astype(int)
    mask = (np.arange(G)[None, :] < n_q[:, None]).astype(np.float64)
    return SearchLog(x=x, q=q, y=y, behavior=behavior.astype(np.int32),
                     price=price, mask=mask, m_q=m_q, relevance=rel)


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-z))
