"""Plain PyTorch versions of the fused L3 training-step reductions (K4) and
of their backward (K5).

Given the packed items xc = [x | y | mask | wgt | cost_w] (see kernel.py),
the stage weights and the per-group biases, `cascade_loss_ref` computes the
three partial reductions of the L3 objective in one forward:

    ll[b]         = sum_g wgt*mask * (y * lpc_T + (1-y) * log1p(-exp(lpc_T)))
    cost_pp[t]    = sum_bg cost_w * exp(lp_t)
    cnt_pp[b, t]  = sum_g  mask   * exp(lp_t)

with lp the (B, G, T) cumulative log pass-probabilities (Eqs 1-2, 6) and
lpc_T = min(lp[..., -1], -1e-7) the NLL's clamped final stage.

`cascade_loss_bwd_ref` is the closed-form backward. The CPU path of
`kernels.ops.cascade_loss_fused` runs the pair: the forward's values and
the closed form's gradients. On the card they are the oracles of K4 and K5.

The forward computes the pass-probabilities in probability space, as the
reference's does: one sigmoid, an unrolled per-stage product, and the NLL's
log pass-probability as a sum of per-stage logs of the same sigmoids (a
log of the product underflows float32 at ~-87 nats; each per-stage log is
floored at the smallest normal float32 so the value stays finite). Its
values match the kernels' log-space form to a few float32 ulp.

The Eq-15 stop-gradient routing is built in algebraically, so plain
autograd through the forward reproduces the closed form's streams:

    jac_k    = (1 - s_k).detach()              # d lp_t / d zq_k, k <= t
    dzp      = zq_pen - zq_pen.detach()        # value 0, gradient tap
    pp_pen_t = pp_t.detach() * (1 + sum_{k<=t} jac_k * dzp_k)

pp_pen equals pp bit for bit, and its derivative in zq_pen is the exact
Jacobian of the pass-probabilities in zq, while it touches neither w_eff
nor zq.

Ties at the clamp: the forward's `torch.minimum` passes half the tangent
where lp_T == -1e-7 exactly (as `jnp.minimum` does in the reference's
forward); the closed form, like the reference's kernel, passes all of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.cascade_loss.kernel import LOG_P_CLAMP, N_DATA_COLS

_TINY = torch.finfo(torch.float32).tiny


def _cols(xc: torch.Tensor):
    d_x = xc.shape[-1] - N_DATA_COLS
    xf = xc.float()
    y, mask, wgt, cost_w = [xf[..., d_x + i] for i in range(N_DATA_COLS)]
    return xf[..., :d_x], y, mask, wgt, cost_w


def cascade_loss_ref(xc: torch.Tensor, w_eff: torch.Tensor, zq: torch.Tensor,
                     zq_pen: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xc (B, G, d_x+4), w_eff (T, d_x), zq/zq_pen (B, T) ->
    (ll (B,), cost_pp (T,), cnt_pp (B, T)), all float32. The Eq-8 cost
    accumulator is a grid-wide per-stage sum; the Eq-10 counts stay per
    group.

    zq_pen must equal zq in value; with zq_pen=None the counts stream taps
    zq like everything else."""
    x, y, mask, wgt, cost_w = _cols(xc)
    logits = (torch.einsum("bgd,td->bgt", x, w_eff.float())
              + zq.float()[:, None, :])
    s = torch.sigmoid(logits)
    t = s.shape[-1]
    ls = torch.log(torch.clamp_min(s, _TINY))
    dzp = None if zq_pen is None else zq_pen.float() - zq_pen.float().detach()
    pp_k = lp_sum = jac = None
    cost_cols, cnt_cols = [], []
    for k in range(t):
        s_k = s[..., k]
        pp_k = s_k if pp_k is None else pp_k * s_k
        lp_sum = ls[..., k] if lp_sum is None else lp_sum + ls[..., k]
        cost_cols.append((pp_k * cost_w).sum())
        if dzp is None:
            cnt_cols.append((pp_k * mask).sum(dim=1))
        else:
            d_jac = (1.0 - s_k).detach() * dzp[:, k:k + 1]
            jac = d_jac if jac is None else jac + d_jac
            pp_pen_k = pp_k.detach() * (1.0 + jac)
            cnt_cols.append((pp_pen_k * mask).sum(dim=1))
    lpc = torch.minimum(lp_sum, lp_sum.new_tensor(LOG_P_CLAMP))
    ll = (wgt * mask) * (y * lpc + (1.0 - y) * torch.log1p(-torch.exp(lpc)))
    return (ll.sum(dim=1), torch.stack(cost_cols),
            torch.stack(cnt_cols, dim=-1))


def cascade_loss_bwd_ref(xc: torch.Tensor, w_eff: torch.Tensor,
                         zq: torch.Tensor, g_ll: torch.Tensor,
                         g_cost: torch.Tensor, g_cnt: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Closed-form backward: g_ll (B,), g_cost (T,), g_cnt (B, T) ->
    (dxc (B, G, d_x+4), dw_eff (T, d_x), dzq (B, T), dzq_pen (B, T)), all
    float32. The main stream (NLL + cost) flows to dw_eff and dzq, the
    penalty stream (counts) only to dzq_pen; dxc carries both, with its
    four data columns exactly zero. The clamp passes the whole tangent
    where lp_T <= -1e-7, ties included."""
    x, y, mask, wgt, cost_w = [a if i == 0 else a[..., None]
                               for i, a in enumerate(_cols(xc))]
    wf = w_eff.float()
    logits = torch.einsum("bgd,td->bgt", x, wf) + zq.float()[:, None, :]
    lp = torch.cumsum(F.logsigmoid(logits), dim=-1)
    pp = torch.exp(lp)
    t = lp.shape[-1]
    lpc = torch.minimum(lp[..., -1:], lp.new_tensor(LOG_P_CLAMP))
    ppc = torch.exp(lpc)
    dll = (wgt * mask) * (y - (1.0 - y) * ppc / (1.0 - ppc))     # (B, G, 1)
    g_nll = torch.where(lp[..., -1:] <= LOG_P_CLAMP,
                        g_ll.float()[:, None, None] * dll, 0.0)
    pad_nll = F.pad(g_nll, (t - 1, 0))              # the NLL taps stage T-1
    g_lp_main = pad_nll + g_cost.float()[None, None, :] * pp * cost_w
    g_lp_pen = g_cnt.float()[:, None, :] * pp * mask
    sig = torch.sigmoid(-logits)

    def back(g_lp):
        gc = (g_lp.sum(-1, keepdim=True) - torch.cumsum(g_lp, dim=-1)
              + g_lp)
        return gc * sig

    gm, gp = back(g_lp_main), back(g_lp_pen)
    dx = torch.einsum("bgt,td->bgd", gm + gp, wf)
    dxc = F.pad(dx, (0, N_DATA_COLS))
    dw = torch.einsum("bgt,bgd->td", gm, x)
    return dxc, dw, gm.sum(dim=1), gp.sum(dim=1)
