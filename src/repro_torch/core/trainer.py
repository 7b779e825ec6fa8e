"""SGD trainer for the CLOES cascade (paper §3.2: minibatch SGD, params
initialized near zero), ported from the reference's `core/trainer.py`.
Batches are query groups so the per-query reductions of Eqs 10/16 are
local sums.

Two engines behind the same `fit()` API, visiting the same minibatches in
the same order (host numpy permutations, the reference's RNG stream):

  * ``engine="scan"`` (default) — the log is packed and uploaded to the
    device ONCE, with the param-independent loss terms precomputed
    (`_engine_pack`); each epoch gathers it on the device by the host
    permutation, once, and then runs one eager step per minibatch, with
    the parameters and the momentum each one raveled vector. The packed
    item array is the layout the fused L3 op reads
    (`kernels.ops.cascade_loss_fused`), so the default objective is one
    forward and one backward kernel per step on the card. With
    TrainConfig.precision="bf16" the item array is stored in bfloat16 and
    up-cast once per epoch, after the gather; TrainConfig.loss_scale
    scales the optimized objective.
  * ``engine="loop"`` — one step per minibatch over host batches uploaded
    per step, parameters as a dict: the trajectory-parity oracle.

The reference's scan engine is one `jax.lax.scan` per epoch; the port runs
the same steps eagerly (capturing a step as a CUDA graph is later work).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core import cascade as C
from repro_torch.core import losses as L
from repro_torch.core import metrics as M
from repro_torch.data.synthetic import SearchLog
from repro_torch.kernels.cascade_loss.kernel import pack_items
from repro_torch.optim.sgd import apply_updates, momentum_sgd


@dataclasses.dataclass
class TrainConfig:
    loss: str = "l3"           # l1 | l2 | l3
    lr: float = 0.05
    momentum: float = 0.9
    batch_groups: int = 64     # query groups per minibatch
    epochs: int = 10
    seed: int = 0
    log_every: int = 200
    engine: str = "scan"       # scan | loop (see module docstring)
    # Storage precision of the packed item array (scan engine only):
    # "bf16" halves its footprint and the per-epoch gather; every consumer
    # accumulates in f32. The small group array stays f32 (m_q/mn/n_o_eff
    # reach the thousands, where bf16 would shift the penalty targets).
    precision: str = "f32"     # f32 | bf16
    # Static loss scale (scan engine only): the step optimizes
    # loss * loss_scale and unscales the gradient before the update.
    loss_scale: float = 1.0


def epoch_steps(n_groups: int, batch_groups: int) -> tuple[int, int]:
    """(full minibatches per epoch, query groups DROPPED from the tail).
    The tail partial batch is dropped so every step sees the same
    (batch_groups, G) shapes; a fresh permutation each epoch means no
    group is systematically lost."""
    steps = n_groups // batch_groups
    return steps, n_groups - steps * batch_groups


def _epoch_perm(n_groups: int, batch_groups: int, seed: int) -> np.ndarray:
    """Host-side minibatch index plan for one epoch: (steps, batch_groups),
    from the reference's RNG stream, so both engines (and both packages)
    visit identical minibatches."""
    steps, _ = epoch_steps(n_groups, batch_groups)
    perm = np.random.default_rng(seed).permutation(n_groups)
    return perm[:steps * batch_groups].reshape(steps, batch_groups)


def _log_arrays(log: SearchLog, device, idx=None) -> dict[str, torch.Tensor]:
    """The log (or its groups `idx`) as tensors on `device`."""
    def take(a, dtype=torch.float32):
        a = np.asarray(a if idx is None else a[idx])
        return torch.as_tensor(a, dtype=dtype, device=device)
    return {
        "x": take(log.x), "q": take(log.q), "y": take(log.y),
        "mask": take(log.mask),
        "behavior": take(log.behavior, torch.int64),
        "price": take(log.price), "m_q": take(log.m_q),
    }


def batches(log: SearchLog, batch_groups: int, seed: int,
            device="cuda") -> Iterator[dict]:
    """Host-side minibatch iterator (the loop engine's data path): each
    minibatch is uploaded when it is used. The tail partial batch is
    dropped — see `epoch_steps`."""
    for idx in _epoch_perm(log.x.shape[0], batch_groups, seed):
        yield _log_arrays(log, device, idx)


def _resolve_loss(loss_name) -> Callable:
    return L.LOSSES[loss_name] if isinstance(loss_name, str) else loss_name


def train_step(params: C.Params, opt_state, batch, cfg: C.CascadeConfig,
               lcfg: L.LossConfig, loss_name, opt_update):
    """One SGD step on a dict of params: (params, opt_state, loss)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = _resolve_loss(loss_name)(leaves, cfg, lcfg, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    updates, opt_state = opt_update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss.detach()


# ---------------------------------------------------------------------------
# Scan engine: the log packed on the device once, raveled params/momentum.
# ---------------------------------------------------------------------------

def _engine_pack(log: SearchLog, lcfg: L.LossConfig, precision: str = "f32",
                 device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Upload the log once, with param-independent loss terms precomputed.

    Returns (item (B, G, d_x+4), group (B, d_q+3)):
      item  = [x | y | mask | wgt | cost_w]   (`pack_items`)
      group = [q | m_q | mn | n_o_eff]
    With precision="bf16" the item array is stored in bfloat16."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown engine precision: {precision!r} "
                         "(expected 'f32' or 'bf16')")
    d = _log_arrays(log, device)
    wgt = L.importance_weights(d["behavior"], d["price"], lcfg)
    mn = d["m_q"] / torch.clamp_min(d["mask"].sum(-1), 1.0)
    base_w = (d["mask"] * (1.0 - d["y"]) if lcfg.cost_mask_positives
              else d["mask"])
    cost_w = base_w * mn[:, None]
    n_o_eff = torch.clamp_max(d["m_q"], lcfg.n_o)
    item = pack_items(d["x"], d["y"], d["mask"], wgt, cost_w)
    group = torch.cat([d["q"], d["m_q"][:, None], mn[:, None],
                       n_o_eff[:, None]], dim=-1)
    if precision == "bf16":
        item = item.to(torch.bfloat16)
    return item, group


def _engine_unpack(item: torch.Tensor, group: torch.Tensor,
                   d_x: int, d_q: int) -> dict[str, torch.Tensor]:
    """Packed minibatch -> the engine-batch dict the losses consume. Up-casts
    to f32 first (a no-op for f32 packs); the packed items ride along
    under "xc" for the fused L3 op."""
    item = item.float()
    group = group.float()
    return {
        "xc": item,
        "x": item[..., :d_x], "y": item[..., d_x],
        "mask": item[..., d_x + 1], "wgt": item[..., d_x + 2],
        "cost_w": item[..., d_x + 3],
        "q": group[..., :d_q], "m_q": group[..., d_q],
        "mn": group[..., d_q + 1], "n_o_eff": group[..., d_q + 2],
    }


def _ravel(params: C.Params) -> tuple[torch.Tensor, Callable]:
    """One vector of the params in key order (b, w_q, w_x — the order of
    the reference's ravel_pytree), and the map back to a dict of views."""
    keys = sorted(params)
    shapes = [params[k].shape for k in keys]
    sizes = [params[k].numel() for k in keys]
    theta = torch.cat([params[k].reshape(-1) for k in keys])

    def unravel(th: torch.Tensor) -> C.Params:
        return {k: p.view(s) for k, p, s in
                zip(keys, torch.split(th, sizes), shapes)}
    return theta, unravel


def _initial_params(cfg: C.CascadeConfig, tcfg: TrainConfig, init_params,
                    device) -> C.Params:
    if init_params is None:
        return C.init_params(cfg, torch.Generator().manual_seed(tcfg.seed),
                             device=device)
    return C.params_from_numpy(
        {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
         for k, v in init_params.items()}, device=device)


def fit(log: SearchLog, cfg: C.CascadeConfig, lcfg: L.LossConfig,
        tcfg: TrainConfig | None = None,
        callback: Callable[[int, float], None] | None = None,
        *, loss_fn: Callable | None = None, init_params=None,
        device="cuda") -> C.Params:
    """Train CLOES params on the log on `device`. See the module docstring
    for the engines.

    loss_fn overrides the objective looked up from tcfg.loss.
    init_params (numpy arrays or tensors of the reference layout) sets the
    starting weights — the reference initialises from jax.random, which
    torch cannot replay, so a parity check passes the reference's initial
    weights here; without it the seeded `init_params` starts the fit.
    callback(step, loss) sees every log_every-th step's loss."""
    tcfg = tcfg or TrainConfig()
    device = torch.device(device)
    params = _initial_params(cfg, tcfg, init_params, device)
    opt = momentum_sgd(tcfg.lr, tcfg.momentum)
    loss_fn = loss_fn or L.LOSSES[tcfg.loss]

    if tcfg.engine == "loop":
        if tcfg.precision != "f32" or tcfg.loss_scale != 1.0:
            raise ValueError(
                "precision/loss_scale are scan-engine features (the loop "
                "engine is the plain-f32 oracle); got "
                f"precision={tcfg.precision!r}, loss_scale={tcfg.loss_scale}")
        opt_state = opt.init(params)
        step = 0
        for epoch in range(tcfg.epochs):
            for batch in batches(log, tcfg.batch_groups, tcfg.seed + epoch,
                                 device):
                params, opt_state, loss = train_step(
                    params, opt_state, batch, cfg, lcfg, loss_fn, opt.update)
                if callback and step % tcfg.log_every == 0:
                    callback(step, float(loss))
                step += 1
        return params
    if tcfg.engine != "scan":
        raise ValueError(f"unknown trainer engine: {tcfg.engine!r}")

    n_groups = log.x.shape[0]
    steps_per_epoch, _ = epoch_steps(n_groups, tcfg.batch_groups)
    if steps_per_epoch == 0:
        return params
    item, group = _engine_pack(log, lcfg, tcfg.precision, device)
    theta, unravel = _ravel(params)
    opt_state = opt.init(theta)
    for epoch in range(tcfg.epochs):
        idx = torch.as_tensor(
            _epoch_perm(n_groups, tcfg.batch_groups, tcfg.seed + epoch),
            device=device).reshape(-1)
        # one gather per packed array and epoch; a bf16 pack is gathered in
        # bf16 and up-cast here, once per epoch
        shape = (steps_per_epoch, tcfg.batch_groups)
        items = item[idx].reshape(*shape, *item.shape[1:]).float()
        groups = group[idx].reshape(*shape, *group.shape[1:]).float()
        losses = []
        for i in range(steps_per_epoch):
            batch = _engine_unpack(items[i], groups[i], cfg.d_x, cfg.d_q)
            th = theta.detach().requires_grad_(True)
            loss = loss_fn(unravel(th), cfg, lcfg, batch) * tcfg.loss_scale
            (grad,) = torch.autograd.grad(loss, th)
            if tcfg.loss_scale != 1.0:
                loss = loss / tcfg.loss_scale
                grad = grad / tcfg.loss_scale
            updates, opt_state = opt.update(grad, opt_state, theta)
            theta = apply_updates(theta.detach(), updates)
            losses.append(loss.detach())
        if callback:
            base = epoch * steps_per_epoch
            for i, v in enumerate(torch.stack(losses).tolist()):
                if (base + i) % tcfg.log_every == 0:
                    callback(base + i, v)
    return {k: v.clone() for k, v in unravel(theta).items()}


def evaluate(params: C.Params, cfg: C.CascadeConfig, log: SearchLog,
             lcfg: L.LossConfig | None = None) -> dict[str, float]:
    """Offline metrics on the params' device: AUC of the final score +
    expected cost per instance (Eq 8) + expected per-query latency (Eq 16)
    + final result size, all from ONE cascade forward."""
    lcfg = lcfg or L.LossConfig()
    device = params["w_x"].device
    d = _log_arrays(log, device)
    with torch.no_grad():
        lp, _ = L.cascade_forward(params, cfg, d["x"], d["q"])
        scores = lp[..., -1].cpu().numpy()
        cost = float(L.cost_from_lp(lp, cfg, d["mask"], m_q=d["m_q"]))
        counts = L.counts_from_lp(lp, d["mask"], d["m_q"])           # (B, T)
        lat = L.latency_from_counts_q(counts, d["m_q"], cfg,
                                      lcfg).cpu().numpy()
        counts_t = counts[:, -1].cpu().numpy()
    return {
        "auc": M.group_auc(scores, log.y, log.mask),
        "pooled_auc": M.auc(scores, log.y, log.mask),
        "expected_cost_per_item": cost,
        "mean_expected_latency": float(lat.mean()),
        "p95_expected_latency": float(np.percentile(lat, 95)),
        "mean_final_count": float(counts_t.mean()),
        "frac_queries_below_no": float(
            (counts_t < np.minimum(lcfg.n_o, log.m_q)).mean()),
    }
