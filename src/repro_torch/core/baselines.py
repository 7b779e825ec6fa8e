"""Comparison algorithms from the paper (§4.2), ported from the reference's
`core/baselines.py`:

- single-stage classifier with ALL features (accuracy ceiling, cost 1.0);
- single-stage classifier with the cheapest features only;
- the 2-stage heuristic deployed at Taobao before CLOES: stage 1 filters by
  regularized sales volume to a constant 6000 survivors, stage 2 is an LR
  over all remaining features;
- soft cascade [Raykar et al. / Lefakis & Fleuret]: the same product-of-
  sigmoids model trained with the pure likelihood objective L1 (no cost or
  user-experience terms);
- CLOES itself: the full L3 objective.

Keyword arguments of the fits (device=, init_params=, callback=, ...) pass
straight through to core.trainer.fit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cascade as C
from repro_torch.core import losses as L
from repro_torch.core import metrics as M
from repro_torch.core.trainer import TrainConfig, fit
from repro_torch.data import features as F
from repro_torch.data.synthetic import SearchLog


def _single_stage_cfg(feature_mask: np.ndarray) -> C.CascadeConfig:
    """A 1-stage 'cascade' == plain logistic regression over masked features."""
    mask = feature_mask[None, :]  # (1, d_x)
    t = np.array([F.FEATURE_COSTS[feature_mask > 0].sum()])
    return C.CascadeConfig(n_stages=1, d_x=F.N_FEATURES,
                           d_q=F.N_QUERY_BUCKETS, masks=mask, stage_times=t)


def single_stage_all_features() -> C.CascadeConfig:
    return _single_stage_cfg(np.ones(F.N_FEATURES))


def single_stage_simple_features(cost_cap: float = 0.05) -> C.CascadeConfig:
    """Cheapest features only ('e.g., sales volume')."""
    return _single_stage_cfg((F.FEATURE_COSTS <= cost_cap).astype(np.float64))


def _cascade_cfg(n_stages: int) -> C.CascadeConfig:
    masks = F.default_stage_masks(n_stages)
    return C.CascadeConfig(n_stages=n_stages, d_x=F.N_FEATURES,
                           d_q=F.N_QUERY_BUCKETS, masks=masks,
                           stage_times=F.stage_costs(masks))


@dataclasses.dataclass
class TwoStageResult:
    params: C.Params
    cfg: C.CascadeConfig
    stage1_keep: int


def _stage1_survivors(log: SearchLog, stage1_keep: int) -> np.ndarray:
    """Stage 1: rank by sales volume within each group, keep the group's
    share of `stage1_keep` (at least 1). Returns a (B, G) bool mask."""
    sv_idx = F.FEATURE_NAMES.index("sales_volume")
    keep_frac = np.minimum(stage1_keep / np.maximum(log.m_q, 1), 1.0)  # (B,)
    k_in_group = np.maximum(1, np.round(keep_frac * log.x.shape[1])).astype(int)
    order = np.argsort(-log.x[:, :, sv_idx], axis=1)
    rank = np.argsort(order, axis=1)
    return rank < k_in_group[:, None]


def fit_two_stage(log: SearchLog, stage1_keep: int = 6000,
                  tcfg: TrainConfig | None = None,
                  **fit_kwargs) -> TwoStageResult:
    """The heuristic production baseline. Stage 1: rank by regularized sales
    volume, keep a constant `stage1_keep` (6000 at Taobao). Stage 2: LR with
    all features, trained on instances that *would survive* stage 1."""
    tcfg = tcfg or TrainConfig(loss="l1", epochs=8)
    cfg = single_stage_all_features()
    survive = (_stage1_survivors(log, stage1_keep).astype(np.float64)
               * log.mask)
    pruned = dataclasses.replace(log, mask=survive)
    params = fit(pruned, cfg, L.LossConfig(), tcfg, **fit_kwargs)
    return TwoStageResult(params=params, cfg=cfg, stage1_keep=stage1_keep)


def eval_two_stage(res: TwoStageResult, log: SearchLog) -> dict[str, float]:
    """Score = stage-2 LR on survivors, below every survivor otherwise;
    cost = stage-1 sales volume for all + full feature set for survivors."""
    sv_idx = F.FEATURE_NAMES.index("sales_volume")
    survive = _stage1_survivors(log, res.stage1_keep) & (log.mask > 0)
    device = res.params["w_x"].device
    with torch.no_grad():
        x = torch.as_tensor(log.x, dtype=torch.float32, device=device)
        q = torch.as_tensor(log.q, dtype=torch.float32, device=device)
        scores = C.final_score(res.params, res.cfg, x, q).cpu().numpy()
    ranked_scores = np.where(survive, scores, scores.min() - 10.0)
    # cost in index-item units: stage 1 scans all M_q recalled items,
    # stage 2 runs the full feature set on min(6000, M_q) survivors
    n = log.m_q.sum()
    cost_s1 = F.FEATURE_COSTS[sv_idx] * n
    cost_s2 = ((F.FEATURE_COSTS.sum() - F.FEATURE_COSTS[sv_idx])
               * np.minimum(res.stage1_keep, log.m_q).sum())
    per_query_lat = (F.FEATURE_COSTS[sv_idx] * log.mask.sum(1)
                     / log.mask.sum(1).clip(1) * log.m_q
                     + (F.FEATURE_COSTS.sum() - F.FEATURE_COSTS[sv_idx])
                     * np.minimum(res.stage1_keep, log.m_q))
    return {
        "auc": M.group_auc(ranked_scores, log.y, log.mask),
        "expected_cost_per_item": float((cost_s1 + cost_s2) / n),
        "mean_expected_latency": float(per_query_lat.mean()),
        "mean_final_count": float(np.minimum(res.stage1_keep, log.m_q).mean()),
    }


def fit_soft_cascade(log: SearchLog, n_stages: int = 3,
                     tcfg: TrainConfig | None = None, **fit_kwargs):
    """Soft cascade: the noisy-AND product model (Eqs 1–5) *without* the
    cost and user-experience terms — CLOES trained with L1 only (on the
    card: K1 forward and K3 backward each step)."""
    cfg = _cascade_cfg(n_stages)
    tcfg = tcfg or TrainConfig(loss="l1", epochs=8)
    return fit(log, cfg, L.LossConfig(), tcfg, **fit_kwargs), cfg


def fit_cloes(log: SearchLog, n_stages: int = 3,
              lcfg: L.LossConfig | None = None,
              tcfg: TrainConfig | None = None, **fit_kwargs):
    """The proposed model: the full L3 objective (on the card: K4 forward
    and K5 backward each step)."""
    cfg = _cascade_cfg(n_stages)
    lcfg = lcfg or L.LossConfig()
    tcfg = tcfg or TrainConfig(loss="l3", epochs=8)
    return fit(log, cfg, lcfg, tcfg, **fit_kwargs), cfg
