"""Wrapper of the CUDA kernel K1 (`csrc/cascade_score.cu`): the batched
cascade scorer, x (B, G, d), w_eff (T, d), zq (B, T) -> lp (B, G, T).

Launches on the current stream of the inputs' device and counts its
launches in `cascade_score_batched.launches`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STAGES = 8


def cascade_score_batched(x: torch.Tensor, w_eff: torch.Tensor,
                          zq: torch.Tensor) -> torch.Tensor:
    op = "cascade_score_batched"
    device = _build.check_inputs(op, x=x, w_eff=w_eff, zq=zq)
    b, g, d = x.shape
    t = w_eff.shape[0]
    if not 1 <= t <= MAX_STAGES:
        raise ValueError(f"{op}: cascade of {t} stages, the kernel takes "
                         f"1..{MAX_STAGES}")
    if w_eff.shape[1] != d or tuple(zq.shape) != (b, t):
        raise ValueError(f"{op}: shapes x {tuple(x.shape)}, w_eff "
                         f"{tuple(w_eff.shape)}, zq {tuple(zq.shape)} do not "
                         "agree")
    out = torch.empty((b, g, t), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    if lib.cascade_score_batched_smem(d, t) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{op}: d={d} needs more shared memory than a "
                         "block has")
    with torch.cuda.device(device):
        rc = lib.cascade_score_batched(
            x.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), out.data_ptr(),
            b, g, d, t, _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    cascade_score_batched.launches += 1
    return out


cascade_score_batched.launches = 0
