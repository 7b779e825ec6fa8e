"""The serving-time hard cascade — ONE implementation, shared by
`core.cascade.hard_cascade_filter` and `serving.CascadeSession`.

The paper's deployed system (§4, Eq 10) runs T chained stage filters:
stage j keeps the top-E[Count_{q,j}] surviving items by cumulative
score. `run_cascade` routes either through the fused score+filter kernel
(one block per query group — csrc/cascade_filter.cu) or through a scorer
followed by the stage chain below.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import cascade as C
from repro_torch.kernels import ops as K


# ---------------------------------------------------------------------------
# The pipeline-plan registry — the single source of truth for serving-mode
# resolution: an unknown plan fails with the SAME error everywhere.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """One named way to execute the cascade.

    scorer: (x (B, G, d), w_eff (T, d), zq (B, T)) -> lp (B, G, T).
    fused_filter: run the fully fused score+filter kernel instead of
            scorer + the stage chain.
    """
    name: str
    description: str
    scorer: Callable[..., torch.Tensor]
    fused_filter: bool = False


PLANS: dict[str, PipelinePlan] = {
    "none": PipelinePlan(
        "none", "plain PyTorch scorer + stage chain",
        K.cascade_score_batched_ref),
    "score": PipelinePlan(
        "score", "batched scorer kernel + stage chain",
        K.cascade_score_batched),
    "filter": PipelinePlan(
        "filter", "fully fused score+filter kernel (one block per group)",
        K.cascade_score_batched, fused_filter=True),
}


def resolve_plan(name: str) -> PipelinePlan:
    """Resolve a plan name, raising the one shared unknown-plan error."""
    plan = PLANS.get(name)
    if plan is None:
        raise ValueError(f"unknown pipeline plan: {name!r} "
                         f"(expected one of {tuple(PLANS)})")
    return plan


def keep_counts_from_lp(lp: torch.Tensor, mask: torch.Tensor,
                        m_q: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq-10 expected counts and per-stage keep counts from cumulative log
    pass-probs. lp: (B, G, T), mask: (B, G), m_q: (B,) -> ((B, T), (B, T)).

    Keep counts are the expected counts rescaled from the M_q recalled
    items to the G scored items, bounded by [1, G]."""
    g = mask.shape[-1]
    maskf = mask.float()
    n_q = torch.clamp_min(maskf.sum(-1), 1.0)
    pp = torch.exp(lp) * maskf[..., None]
    counts = (m_q.float() / n_q)[:, None] * pp.sum(-2)
    n_keep = torch.clamp(
        torch.ceil(counts * maskf.sum(-1, keepdim=True)
                   / torch.clamp_min(m_q[:, None].float(), 1.0)),
        1.0, float(g))
    return counts, n_keep


def filter_chain(lp: torch.Tensor, mask: torch.Tensor,
                 n_keep: torch.Tensor) -> torch.Tensor:
    """Stage chain: per stage, stable top-n_keep of the current survivors
    by lp[..., j] ('this expected number ... served as the threshold for
    filtering out items in the corresponding stage').

    Returns the per-stage survivor masks (B, G, T)."""
    surv = mask.float()
    cols = []
    for j in range(lp.shape[-1]):
        s = torch.where(surv > 0, lp[..., j], -torch.inf)
        order = torch.argsort(-s, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True).float()
        surv = surv * (rank < n_keep[:, j:j + 1]).float()
        cols.append(surv)
    return torch.stack(cols, dim=-1)


def run_cascade(params: C.Params, cfg: C.CascadeConfig,
                x: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
                m_q: torch.Tensor, *, fused: str = "none"
                ) -> dict[str, torch.Tensor]:
    """Score + hard-filter a padded (B, G) candidate batch.

    fused names a PLANS entry:
           'none'   — plain scorer + stage chain (the reference path);
           'score'  — batched scorer kernel, stage chain;
           'filter' — fully fused score+filter kernel.
    On CPU tensors every plan runs the kernels' plain versions.

    Returns lp (B, G, T), survivors (B, G, T), scores (B, G),
    expected_counts (B, T), n_keep (B, T), kept_per_stage (B, T)."""
    # Resolve the plan BEFORE any compute: an unknown plan must not cost
    # a scoring setup or surface as a downstream shape error.
    plan = resolve_plan(fused)
    # One scoring formulation for every plan (precomputed w_eff / zq, the
    # kernels' decomposition), so the plans agree on every discrete
    # decision, not just to tolerance.
    w_eff = (params["w_x"] * C.masks_tensor(cfg, x.device)).contiguous()
    zq = (q @ params["w_q"].T + params["b"]).contiguous()
    if plan.fused_filter:
        out = K.cascade_filter(x, w_eff, zq, mask, m_q)
        lp, surv = out["lp"], out["survivors"]
        counts, n_keep = out["expected_counts"], out["n_keep"]
    else:
        lp = plan.scorer(x, w_eff, zq)
        counts, n_keep = keep_counts_from_lp(lp, mask, m_q)
        surv = filter_chain(lp, mask, n_keep)
    return {
        "lp": lp,
        "survivors": surv,
        "scores": lp[..., -1],
        "expected_counts": counts,
        "n_keep": n_keep,
        "kept_per_stage": surv.sum(1),
    }


def latency_from_counts(counts: torch.Tensor, m_q: torch.Tensor,
                        cfg: C.CascadeConfig, latency_scale: float,
                        convention: str = "entering") -> torch.Tensor:
    """Eq-16 latency model from already-computed expected counts (B, T) —
    the serving pipeline's latency estimate without re-scoring the batch."""
    t = C.stage_times_tensor(cfg, counts.dtype, counts.device)
    if convention == "entering":
        entering = torch.cat(
            [m_q[:, None].to(counts.dtype), counts[:, :-1]], dim=-1)
        lat = (entering * t).sum(-1)
    else:  # as printed in the paper
        lat = (counts * t).sum(-1)
    return latency_scale * lat
