"""Plain PyTorch versions of the cascade scorers (K1, K6, K7) and their
backwards (K3, K6's).

Computes, for every item, the per-stage cumulative log pass-probability of
the CLOES cascade (Eqs 1-2, 6):

    logit[b, g, j] = x[b, g] . w_eff[j] + zq[b, j]
    lp[b, g, j]    = sum_{k<=j} log sigmoid(logit[b, g, k])

`cascade_score_batched_ref` is the CPU path of
`kernels.ops.cascade_score_batched` and the oracle the CUDA kernel
(`csrc/cascade_score.cu`) is held against on the card;
`cascade_score_batched_bwd_ref` is the closed-form backward, the CPU path
of the op's gradient and the oracle of K3 (`csrc/cascade_score_bwd.cu`).
`cascade_score_ref` and `cascade_score_bwd_ref` are the same for one group
of N items with one bias row zq (T,), or for B such groups at once (x
(B, N, d) with zq (B, T), or zq (T,) shared by every group): the CPU path
and oracle of `kernels.ops.cascade_score` (K6 forward and backward, also
under vmap) and, on xt.T, of `kernels.ops.cascade_score_fm` (K7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cascade_score_batched_ref(x: torch.Tensor, w_eff: torch.Tensor,
                              zq: torch.Tensor) -> torch.Tensor:
    """x (B, G, d), w_eff (T, d), zq (B, T) -> (B, G, T) float32."""
    logits = (torch.einsum("bgd,td->bgt", x.float(), w_eff.float())
              + zq.float()[:, None, :])
    return torch.cumsum(F.logsigmoid(logits), dim=-1)


def cascade_score_batched_bwd_ref(x: torch.Tensor, w_eff: torch.Tensor,
                                  zq: torch.Tensor, g: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Closed-form backward of `cascade_score_batched_ref`: cotangent g
    (B, G, T) -> (dx (B, G, d), dw_eff (T, d), dzq (B, T)), all float32.

        gc      = reverse cumsum of g over stages (total - cumsum + g)
        g_logit = gc * sigmoid(-logit)
        dx = g_logit . w_eff,  dw_eff = sum_bg g_logit^T x,  dzq = sum_g g_logit
    """
    xf, wf, gf = x.float(), w_eff.float(), g.float()
    logits = torch.einsum("bgd,td->bgt", xf, wf) + zq.float()[:, None, :]
    gc = gf.sum(-1, keepdim=True) - torch.cumsum(gf, dim=-1) + gf
    g_logit = gc * torch.sigmoid(-logits)
    return (torch.einsum("bgt,td->bgd", g_logit, wf),
            torch.einsum("bgt,bgd->td", g_logit, xf),
            g_logit.sum(dim=1))


def cascade_score_ref(x: torch.Tensor, w_eff: torch.Tensor,
                      zq: torch.Tensor) -> torch.Tensor:
    """x (..., N, d), w_eff (T, d), zq (..., T) or (T,) -> (..., N, T)
    float32."""
    logits = x.float() @ w_eff.float().T + zq.float()[..., None, :]
    return torch.cumsum(F.logsigmoid(logits), dim=-1)


def cascade_score_bwd_ref(x: torch.Tensor, w_eff: torch.Tensor,
                          zq: torch.Tensor, g: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Closed-form backward of `cascade_score_ref`: cotangent g (..., N, T)
    -> (dx shaped as x, dw_eff (T, d), dzq shaped as zq), all float32, as
    `cascade_score_batched_bwd_ref` per group; a zq shared by the groups
    gets the sum over all of them."""
    xf, wf, gf = x.float(), w_eff.float(), g.float()
    logits = xf @ wf.T + zq.float()[..., None, :]
    gc = gf.sum(-1, keepdim=True) - torch.cumsum(gf, dim=-1) + gf
    g_logit = gc * torch.sigmoid(-logits)                      # (..., N, T)
    t, d = wf.shape
    dzq = g_logit.sum(dim=-2)
    return (g_logit @ wf,
            g_logit.reshape(-1, t).T @ xf.reshape(-1, d),
            dzq.reshape(zq.shape) if dzq.ndim == zq.ndim
            else dzq.reshape(-1, t).sum(0))
