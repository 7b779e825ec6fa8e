"""CLOES objectives (paper §3.2–3.3, Eqs 4–17) — single-forward engine, as
in the reference (`core/losses.py`).

All losses take the query-grouped batch layout: x (B, G, d_x), q (B, d_q),
y/mask/price/behavior (B, G), m_q (B,). Every term is differentiable and
the full L3 objective is a single scalar optimized by SGD (paper §3.2).

Every objective derives from ONE shared cascade forward: `cascade_forward`
computes the (B, G, T) cumulative log pass-probabilities once through the
pipeline plan's scorer (`kernels.ops.cascade_score_batched`: K1 forward and
K3 backward on the card), plus the one stop-gradient variant L3's w_q-only
penalty routing needs. NLL (Eq 4/17), expected cost (Eq 8), per-query
counts (Eq 10) and the size and latency penalties (Eqs 14–16) are cheap
reductions of that tensor.

The deployed L3 objective runs through `kernels.ops.cascade_loss_fused`
(K4 forward and K5 backward on the card), which emits those per-item
reductions from the pass that computes the scores and carries the penalty
stop-gradient routing in its backward — see `_loss_l3_fused`. The unfused
graph stays reachable through `loss_l3`'s score_fn seam.

Engine-batch protocol: every batch term that does not depend on the params
is a function of (log, lcfg), so the trainer's engine precomputes it once
per fit (`trainer._engine_pack`) and ships it in the batch under the
optional keys

    wgt      (B, G)  Eq-17 importance weights (from behavior/price)
    cost_w   (B, G)  Eq-8 cost weights: mask [* (1-y)] * (M_q / N_q)
    mn       (B,)    Eq-10 extrapolation factor M_q / N_q
    n_o_eff  (B,)    min(N_o, M_q) result-size floor
    xc       (B, G, d_x+4)  the packed [x | y | mask | wgt | cost_w] items,
                     exactly what `kernels.ops.cascade_loss_fused` reads

The losses use these when present and compute them from the raw batch
(behavior/price/mask/y/m_q) otherwise — the same float ops either way.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import cascade as C
from repro_torch.core.pipeline import latency_from_counts, resolve_plan
from repro_torch.data.synthetic import BEHAVIOR_CLICK, BEHAVIOR_PURCHASE
from repro_torch.kernels import ops as K
from repro_torch.kernels.cascade_loss.kernel import LOG_P_CLAMP, pack_items


@dataclasses.dataclass(frozen=True)
class LossConfig:
    alpha: float = 1e-4      # l2 regularization (Eq 5)
    beta: float = 1.0        # CPU-cost trade-off (Eq 9); paper sweeps 1..10
    delta: float = 1.0       # result-size penalty weight (Eq 15); paper: 1
    eps_latency: float = 0.05  # latency penalty weight (Eq 15 'epsilon'); paper: 0.05
    gamma: float = 0.05      # smooth-hinge sharpness (Eq 14)
    n_o: float = 200.0       # minimum result size N_o (paper: 200)
    t_l: float = 130.0       # latency budget T_l in ms (paper: 130 ms)
    # Converts per-item cost units to ms, calibrated jointly with the
    # synthetic recall distribution (see the reference's LossConfig).
    latency_scale: float = 0.0015
    # importance weights (Eq 17)
    eps_purchase: float = 1.0  # 'epsilon': purchase weight multiplier (paper: 10)
    mu_price: float = 1.0      # 'mu': price weight multiplier (paper sweeps 1..4)
    # Eq 16 as printed uses t_j * E[Count_{q,j}]; 'entering' uses the Eq-8
    # convention t_j * E[Count_{q,j-1}] with Count_{q,0} = M_q (items
    # entering stage j pay t_j) and is the default.
    latency_convention: str = "entering"
    # Count the expected cost (Eq 8) over negative instances only.
    cost_mask_positives: bool = False


# ---------------------------------------------------------------------------
# The shared forward: one scoring pass (+ the L3 penalty variant).
# ---------------------------------------------------------------------------

def cascade_forward(params: C.Params, cfg: C.CascadeConfig,
                    x: torch.Tensor, q: torch.Tensor, *,
                    penalty_variant: bool = False, score_fn=None,
                    plan: str = "score"
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, G, T) cumulative log pass-probabilities through the plan's
    scorer (default plan "score": `kernels.ops.cascade_score_batched`);
    score_fn overrides it with any (x, w_eff, zq) -> lp callable.

    With penalty_variant, also returns the stop-gradient routing L3's UX
    penalties need: the same values, with w_x and b detached so penalty
    gradients flow only into the query-only weights w_q (see loss_l3)."""
    score = score_fn or resolve_plan(plan).scorer
    x = x.contiguous()                    # engine batches slice x from xc
    w_eff = params["w_x"] * C.masks_tensor(cfg, x.device)          # (T, d_x)
    zq = q @ params["w_q"].T + params["b"]                          # (B, T)
    lp = score(x, w_eff, zq)
    if not penalty_variant:
        return lp, None
    zq_pen = q @ params["w_q"].T + params["b"].detach()
    return lp, score(x, w_eff.detach(), zq_pen)


# ---------------------------------------------------------------------------
# Eq 17 — importance weights for multi-behavior e-commerce effectiveness.
# ---------------------------------------------------------------------------

def importance_weights(behavior: torch.Tensor, price: torch.Tensor,
                       lcfg: LossConfig) -> torch.Tensor:
    """wgt_i = eps*mu*log(price) (purchase) | mu*log(price) (click) | 1."""
    logp = torch.log(torch.clamp_min(price, 1.0 + 1e-6))  # log(price) >= ~0
    w_click = lcfg.mu_price * logp
    w_buy = lcfg.eps_purchase * w_click
    return torch.where(behavior == BEHAVIOR_PURCHASE, w_buy,
                       torch.where(behavior == BEHAVIOR_CLICK, w_click, 1.0))


# ---------------------------------------------------------------------------
# Derivations from the shared forward: each reduces lp, no re-scoring.
# ---------------------------------------------------------------------------

def _batch_wgt(batch, lcfg: LossConfig):
    """Eq-17 weights: the engine column, or derived from the raw batch;
    None when the batch carries no behavior signal (unweighted)."""
    wgt = batch.get("wgt")
    if wgt is None and batch.get("behavior") is not None:
        wgt = importance_weights(batch["behavior"], batch["price"], lcfg)
    return wgt


def nll_from_lp(lp: torch.Tensor, y, mask, wgt=None) -> torch.Tensor:
    """-l(w): negative (importance-weighted) log-likelihood, Eqs 4/17.

    log p_i = lp[..., -1] is the stable log-sigmoid cumsum; log(1 - p_i)
    is log1p(-exp(log_p)) with log_p clamped at -1e-7 (torch.minimum: at an
    exact tie half the tangent passes, as with the reference's
    jnp.minimum)."""
    last = lp[..., -1]
    log_p = torch.minimum(last, last.new_tensor(LOG_P_CLAMP))   # keep 1-p > 0
    log_1mp = torch.log1p(-torch.exp(log_p))
    ll = y * log_p + (1.0 - y) * log_1mp
    if wgt is not None:
        ll = ll * wgt
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _cost_core(lp: torch.Tensor, cfg: C.CascadeConfig, w, n) -> torch.Tensor:
    """Eq-8 reduction given ready cost weights w (B, G) and normalizer n."""
    pp = torch.exp(lp) * w[..., None]                           # (B, G, T)
    counts = torch.cat([n[None], pp.sum(dim=(0, 1))[:-1]])     # (T,)
    t = C.stage_times_tensor(cfg, lp.dtype, lp.device)
    return (counts * t).sum() / n


def cost_from_lp(lp: torch.Tensor, cfg: C.CascadeConfig, mask, y=None,
                 m_q=None) -> torch.Tensor:
    """T(w) = sum_{j=0}^{T-1} E[Count_j] * t_{j+1}  (Eq 8), normalized per
    INDEX item, with E[Count_j] in index-item units via the Eq-10
    extrapolation (each logged instance of query q stands for M_q/N_q
    recalled items). With y given (cost_mask_positives), only negative
    instances contribute. E[Count_0] = sum_q M_q."""
    w = mask if y is None else mask * (1.0 - y)
    if m_q is not None:
        n_q = torch.clamp_min(mask.sum(dim=-1), 1.0)           # (B,)
        w = w * (m_q / n_q)[:, None]
        n = torch.clamp_min(m_q.sum(), 1.0)
    else:
        n = torch.clamp_min(mask.sum(), 1.0)
    return _cost_core(lp, cfg, w, n)


def counts_from_lp(lp: torch.Tensor, mask, m_q, mn=None) -> torch.Tensor:
    """E[Count_{q,j}] ≈ (M_q / N_q) * sum_i p_pass_j  (Eq 10). Returns
    (B, T). mn is the precomputed M_q / N_q engine column."""
    pp = torch.exp(lp) * mask[..., None]                        # (B, G, T)
    if mn is None:
        mn = m_q / torch.clamp_min(mask.sum(dim=-1), 1.0)      # (B,)
    return mn[..., None] * pp.sum(dim=-2)


def latency_from_counts_q(counts: torch.Tensor, m_q, cfg: C.CascadeConfig,
                          lcfg: LossConfig) -> torch.Tensor:
    """E[Latency_{q,T}] = sum_j t_j * E[Count_{q,·}]  (Eq 16). Returns (B,).
    Shares core.pipeline.latency_from_counts with the serving pipeline."""
    return latency_from_counts(counts, m_q, cfg, lcfg.latency_scale,
                               lcfg.latency_convention)


# ---------------------------------------------------------------------------
# Standalone term APIs (evaluation / benchmarks): one forward each.
# ---------------------------------------------------------------------------

def weighted_nll(params: C.Params, cfg: C.CascadeConfig, lcfg: LossConfig,
                 x, q, y, mask, behavior=None, price=None) -> torch.Tensor:
    """-l(w): negative (importance-weighted) log-likelihood, Eqs 4/17."""
    lp, _ = cascade_forward(params, cfg, x, q)
    wgt = (importance_weights(behavior, price, lcfg)
           if behavior is not None else None)
    return nll_from_lp(lp, y, mask, wgt)


def l2_penalty(params: C.Params, lcfg: LossConfig) -> torch.Tensor:
    """alpha * ||w||_2^2 (Eq 5), summed in key order (b, w_q, w_x) as the
    reference's tree_leaves are."""
    return lcfg.alpha * sum(torch.sum(params[k] ** 2) for k in sorted(params))


def expected_cost(params: C.Params, cfg: C.CascadeConfig,
                  x, q, mask, y=None, m_q=None) -> torch.Tensor:
    """T(w) (Eq 8) from a fresh forward — see cost_from_lp."""
    lp, _ = cascade_forward(params, cfg, x, q)
    return cost_from_lp(lp, cfg, mask, y, m_q)


def expected_latency_per_query(params: C.Params, cfg: C.CascadeConfig,
                               lcfg: LossConfig, x, q, mask,
                               m_q) -> torch.Tensor:
    """E[Latency_{q,T}] (Eq 16) from a fresh forward. Returns (B,)."""
    lp, _ = cascade_forward(params, cfg, x, q)
    return latency_from_counts_q(counts_from_lp(lp, mask, m_q), m_q, cfg,
                                 lcfg)


# ---------------------------------------------------------------------------
# Eq 14 — smooth hinge g'(z, N_o) = (1/gamma) ln(1 + exp(gamma (N_o - z))).
# ---------------------------------------------------------------------------

def smooth_hinge(z: torch.Tensor, target, gamma: float) -> torch.Tensor:
    """Differentiable approximation of max(target - z, 0); -> hinge as
    gamma grows. softplus as logaddexp(u, 0), like jax.nn.softplus (torch's
    F.softplus switches to the identity above its threshold)."""
    u = gamma * (target - z)
    return torch.logaddexp(u, torch.zeros_like(u)) / gamma


# ---------------------------------------------------------------------------
# Full objectives L1 (Eq 5), L2 (Eq 9), L3 (Eq 15) — one forward each.
# ---------------------------------------------------------------------------

def _nll_cost_from_lp(lp, cfg: C.CascadeConfig, lcfg: LossConfig, batch):
    """(NLL, Eq-8 cost) from the shared forward's lp — the L2/L3 core,
    using the engine batch's precomputed cost weights when present."""
    nll = nll_from_lp(lp, batch["y"], batch["mask"], _batch_wgt(batch, lcfg))
    cost_w = batch.get("cost_w")
    if cost_w is not None:
        cost = _cost_core(lp, cfg, cost_w,
                          torch.clamp_min(batch["m_q"].sum(), 1.0))
    else:
        y_for_cost = batch["y"] if lcfg.cost_mask_positives else None
        cost = cost_from_lp(lp, cfg, batch["mask"], y_for_cost,
                            batch.get("m_q"))
    return nll, cost


def _l2_from_lp(params, lp, cfg: C.CascadeConfig, lcfg: LossConfig, batch):
    """L2 (Eq 9) given the shared forward's lp."""
    nll, cost = _nll_cost_from_lp(lp, cfg, lcfg, batch)
    return nll + l2_penalty(params, lcfg) + lcfg.beta * cost


def loss_l1(params, cfg: C.CascadeConfig, lcfg: LossConfig,
            batch) -> torch.Tensor:
    lp, _ = cascade_forward(params, cfg, batch["x"], batch["q"])
    return (nll_from_lp(lp, batch["y"], batch["mask"],
                        _batch_wgt(batch, lcfg))
            + l2_penalty(params, lcfg))


def loss_l2(params, cfg: C.CascadeConfig, lcfg: LossConfig,
            batch) -> torch.Tensor:
    lp, _ = cascade_forward(params, cfg, batch["x"], batch["q"])
    return _l2_from_lp(params, lp, cfg, lcfg, batch)


def _l3_tail(params, cfg: C.CascadeConfig, lcfg: LossConfig,
             nll, cost, counts_pen, m_q, n_o) -> torch.Tensor:
    """Assemble Eq 15 from the reduced terms: the UX hinges over the
    per-query penalty counts + the shared NLL / l2 / Eq-8 cost core. The
    size floor penalizes E[Count_{q,T}] < N_o (never more than the query
    recalls), the latency cap Latency > T_l (unit: excess ms); both are
    means over queries."""
    size_pen = smooth_hinge(counts_pen[:, -1], n_o, lcfg.gamma).mean()
    lat = latency_from_counts_q(counts_pen, m_q, cfg, lcfg)
    lat_pen = smooth_hinge(torch.full_like(lat, lcfg.t_l), lat,
                           lcfg.gamma).mean()
    return (nll + l2_penalty(params, lcfg) + lcfg.beta * cost
            + lcfg.delta * size_pen + lcfg.eps_latency * lat_pen)


def _loss_l3_fused(params, cfg: C.CascadeConfig, lcfg: LossConfig,
                   batch) -> torch.Tensor:
    """L3 through ONE `kernels.ops.cascade_loss_fused` call.

    The op computes the logits once and emits the three per-group partial
    reductions (NLL terms, Eq-8 cost accumulators, Eq-10 keep counts);
    everything left here is O(B*T). The Eq-15 stop-gradient routing
    (penalties adjust only w_q — see loss_l3) is in the op's backward:
    zq_pen is the gradient tap the counts stream flows into.

    Engine batches arrive with wgt/cost_w/mn/n_o_eff and the packed items
    under "xc"; raw batches derive the columns and pack here (the same
    float ops)."""
    x, q, y = batch["x"], batch["q"], batch["y"]
    mask, m_q = batch["mask"], batch["m_q"]
    mn = batch.get("mn")
    if mn is None:
        mn = m_q / torch.clamp_min(mask.sum(dim=-1), 1.0)
    n_o = batch.get("n_o_eff")
    if n_o is None:
        n_o = torch.clamp_max(m_q.to(x.dtype), lcfg.n_o)
    xc = batch.get("xc")
    if xc is None:
        wgt = _batch_wgt(batch, lcfg)
        if wgt is None:
            wgt = torch.ones_like(mask)
        cost_w = batch.get("cost_w")
        if cost_w is None:
            base = mask * (1.0 - y) if lcfg.cost_mask_positives else mask
            cost_w = base * mn[:, None]
        xc = pack_items(x, y, mask, wgt, cost_w)
    w_eff = params["w_x"] * C.masks_tensor(cfg, x.device)           # (T, d_x)
    zq = q @ params["w_q"].T + params["b"]                          # (B, T)
    zq_pen = q @ params["w_q"].T + params["b"].detach()
    ll, cost_pp, cnt_pp = K.cascade_loss_fused(xc.contiguous(), w_eff, zq,
                                               zq_pen)
    nll = -ll.sum() / torch.clamp_min(mask.sum(), 1.0)
    n = torch.clamp_min(m_q.sum(), 1.0)
    counts = torch.cat([n[None], cost_pp[:-1]])                      # (T,)
    cost = (counts * C.stage_times_tensor(cfg, ll.dtype, ll.device)).sum() / n
    counts_pen = mn[:, None] * cnt_pp                                # (B, T)
    return _l3_tail(params, cfg, lcfg, nll, cost, counts_pen, m_q, n_o)


def loss_l3(params, cfg: C.CascadeConfig, lcfg: LossConfig, batch,
            *, score_fn=None) -> torch.Tensor:
    """The deployed CLOES objective (Eq 15).

    Gradient routing: the two user-experience penalties adjust only the
    query-only parameters w_q ("used to control the magnitude of the
    prediction probability ... but does not affect the rank order"), so
    w_x and b are detached inside the penalty terms.

    By default the whole objective runs through ONE
    `kernels.ops.cascade_loss_fused` call (`_loss_l3_fused`). Passing
    score_fn pins the unfused score-then-reduce graph below, with both
    penalties reducing the penalty-variant forward lp_pen."""
    if score_fn is None:
        return _loss_l3_fused(params, cfg, lcfg, batch)
    x, q, mask, m_q = batch["x"], batch["q"], batch["mask"], batch["m_q"]
    lp, lp_pen = cascade_forward(params, cfg, x, q, penalty_variant=True,
                                 score_fn=score_fn)
    counts_pen = counts_from_lp(lp_pen, mask, m_q, batch.get("mn"))
    n_o = batch.get("n_o_eff")
    if n_o is None:
        n_o = torch.clamp_max(m_q.to(x.dtype), lcfg.n_o)
    nll, cost = _nll_cost_from_lp(lp, cfg, lcfg, batch)
    return _l3_tail(params, cfg, lcfg, nll, cost, counts_pen, m_q, n_o)


LOSSES = {"l1": loss_l1, "l2": loss_l2, "l3": loss_l3}
