"""Wrapper of the CUDA kernel `query_bias` (`csrc/query_bias.cu`): one
thread per (row, stage), each summing its dot product in index order.

Launches on the current stream of the inputs' device and counts its
launches in `query_bias.launches`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STAGES = 8


def query_bias(q: torch.Tensor, w_q: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """q (R, J), w_q (T, J), b (T,) -> zq (R, T), all float32."""
    op = "query_bias"
    device = _build.check_inputs(op, q=q, w_q=w_q, b=b)
    rows, dq = q.shape
    t = w_q.shape[0]
    if not 1 <= t <= MAX_STAGES:
        raise ValueError(f"{op}: cascade of {t} stages, the kernel takes "
                         f"1..{MAX_STAGES}")
    if w_q.shape[1] != dq or tuple(b.shape) != (t,):
        raise ValueError(f"{op}: shapes q {tuple(q.shape)}, w_q "
                         f"{tuple(w_q.shape)}, b {tuple(b.shape)} do not "
                         "agree")
    zq = torch.empty((rows, t), dtype=torch.float32, device=device)
    if rows == 0:
        return zq
    lib = _build.load_library()
    with torch.cuda.device(device):
        rc = lib.query_bias(q.data_ptr(), w_q.data_ptr(), b.data_ptr(),
                            zq.data_ptr(), rows, dq, t,
                            _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    _build.count_launch(query_bias)
    return zq


query_bias.launches = 0
