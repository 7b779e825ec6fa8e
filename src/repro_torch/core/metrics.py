"""Evaluation metrics for the offline (Table 3) and online-sim (Tables 4, Figs
3–5) experiments: AUC, CPU-cost ratio, expected latency, result-size stats,
and the user-behavior simulators (CTR / orders / GMV / escape rate).

numpy only: the port's copy of the reference's `core/metrics.py`, so that
both packages score a ranking with the same code."""

from __future__ import annotations

import numpy as np


def auc(scores: np.ndarray, labels: np.ndarray,
        mask: np.ndarray | None = None) -> float:
    """Area under the ROC curve via the rank-sum (Mann–Whitney) statistic."""
    s = np.asarray(scores, dtype=np.float64).ravel()
    y = np.asarray(labels).ravel()
    if mask is not None:
        keep = np.asarray(mask).ravel() > 0
        s, y = s[keep], y[keep]
    pos, neg = s[y > 0], s[y == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    ranks = np.empty(len(s))
    order = np.argsort(s, kind="mergesort")
    sorted_s = s[order]
    # average ranks for ties
    ranks_sorted = np.arange(1, len(s) + 1, dtype=np.float64)
    _, inv, cnt = np.unique(sorted_s, return_inverse=True, return_counts=True)
    cum = np.concatenate([[0], np.cumsum(cnt)])
    avg = (cum[:-1] + cum[1:] + 1) / 2.0
    ranks[order] = avg[inv]
    n_pos, n_neg = len(pos), len(neg)
    rank_pos = ranks[y > 0].sum()
    return float((rank_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def group_auc(scores: np.ndarray, labels: np.ndarray,
              mask: np.ndarray | None = None) -> float:
    """Mean per-query AUC (pair-weighted). The cascade's query-only feature
    g(q) shifts scores per query ('does not affect the result order but
    determines the size of each stage'), so ranking quality is within-query:
    pooled AUC would conflate result-size control with ordering."""
    B = scores.shape[0]
    if mask is None:
        mask = np.ones_like(labels)
    total, wsum = 0.0, 0.0
    for b in range(B):
        m = mask[b] > 0
        y = labels[b][m]
        npos, nneg = int(y.sum()), int((1 - y).sum())
        if npos == 0 or nneg == 0:
            continue
        w = npos * nneg
        total += w * auc(scores[b][m], y)
        wsum += w
    return float(total / wsum) if wsum else float("nan")


def cost_ratio(cost: float, baseline_cost: float) -> float:
    """Paper Table 3 convention: single-stage-all-features cost == 1."""
    return float(cost / baseline_cost)


def result_size_stats(kept_final: np.ndarray, m_q: np.ndarray,
                      n_o: float = 200.0) -> dict[str, float]:
    """Distribution of final result counts vs the N_o floor (Fig 4 bottom)."""
    # kept_final are within-group survivor counts; scale to recall size
    return {
        "mean_results": float(np.mean(kept_final)),
        "p10_results": float(np.percentile(kept_final, 10)),
        "frac_below_floor": float(np.mean(kept_final < np.minimum(n_o, m_q))),
    }


# ---------------------------------------------------------------------------
# Online-behavior simulators: the paper's online metrics (CTR, #orders, GMV,
# escape rate) come from live A/B tests; we simulate users with the same
# qualitative behavior documented in the paper:
#   - users browse the top of the ranked list (position bias),
#   - escape probability grows with latency (Fig 4: "the more time the search
#     system responds, the more likely a user escapes"),
#   - purchases follow clicks with probability increasing in relevance.
# ---------------------------------------------------------------------------

def simulate_session(scores: np.ndarray, relevance: np.ndarray,
                     price: np.ndarray, mask: np.ndarray,
                     latency_ms: np.ndarray,
                     top_k: int = 10, latency_escape_ms: float = 130.0,
                     escape_slope: float = 0.004,
                     seed: int = 0) -> dict[str, float]:
    """Simulate one pageview per query group; returns CTR/orders/GMV/escape.

    scores: (B, G) ranking scores (-inf for filtered items)
    relevance: (B, G) latent ground-truth relevance
    latency_ms: (B,) per-query serving latency
    """
    rng = np.random.default_rng(seed)
    B, G = scores.shape
    # escape before interacting, driven by latency above ~latency_escape
    p_escape = 1.0 / (1.0 + np.exp(-escape_slope * 1000 *
                                   (latency_ms - latency_escape_ms) / 1000.0))
    p_escape = np.clip(0.05 + 0.9 * (p_escape - 0.5).clip(0) * 2, 0.02, 0.95)
    escaped = rng.random(B) < p_escape

    order = np.argsort(-np.where(mask > 0, scores, -np.inf), axis=-1)
    top = order[:, :top_k]                                   # (B, k)
    rows = np.arange(B)[:, None]
    rel_top = relevance[rows, top]
    price_top = price[rows, top]
    valid_top = (mask[rows, top] > 0) & np.isfinite(scores[rows, top])
    pos_bias = 1.0 / np.log2(np.arange(2, top_k + 2))        # DCG-style
    p_click = 1 / (1 + np.exp(-1.8 * (rel_top - 0.8))) * pos_bias * valid_top
    clicks = (rng.random((B, top_k)) < p_click) & ~escaped[:, None]
    p_buy = 0.25 / (1 + np.exp(-1.2 * (rel_top - 1.2)))
    buys = clicks & (rng.random((B, top_k)) < p_buy)
    gmv = (buys * price_top).sum()
    return {
        "ctr": float(clicks.any(axis=1).mean()),
        "ctr_non_escaped": float(clicks.any(axis=1)[~escaped].mean()
                                 if (~escaped).any() else 0.0),
        "orders": float(buys.sum()),
        "gmv": float(gmv),
        "unit_price": float(gmv / max(buys.sum(), 1)),
        "escape_rate": float(escaped.mean()),
        "mean_latency_ms": float(latency_ms.mean()),
    }
