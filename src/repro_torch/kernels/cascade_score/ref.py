"""Plain PyTorch version of the batched cascade scorer (K1).

Computes, for every item, the per-stage cumulative log pass-probability of
the CLOES cascade (Eqs 1-2, 6):

    logit[b, g, j] = x[b, g] . w_eff[j] + zq[b, j]
    lp[b, g, j]    = sum_{k<=j} log sigmoid(logit[b, g, k])

It is the CPU path of `kernels.ops.cascade_score_batched` and the oracle
the CUDA kernel (`csrc/cascade_score.cu`) is held against on the card.
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
