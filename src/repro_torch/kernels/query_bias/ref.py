"""Plain PyTorch version of `query_bias` (csrc/query_bias.cu):

    zq[r, t] = b[t] + sum_j q[r, j] * w_q[t, j]

accumulated column by column in index order (acc = b, then acc = acc +
q[:, j] * w_q[:, j] for each j), a separately rounded product and sum per
step: the CUDA kernel's operations in its order, so the two give the same
bits, and a row's bits never depend on how many rows were passed with it
(a matmul orders its sums by the problem's size)."""

from __future__ import annotations

import torch


def query_bias_ref(q: torch.Tensor, w_q: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """q (R, J), w_q (T, J), b (T,) -> zq (R, T), float32."""
    q, w_q = q.float(), w_q.float()
    acc = b.float().expand(q.shape[0], -1)
    for j in range(q.shape[1]):
        acc = acc + q[:, j:j + 1] * w_q[:, j]
    return acc.contiguous()
