"""Wrappers of the CUDA kernels K1 (`csrc/cascade_score.cu`), the batched
cascade scorer x (B, G, d), w_eff (T, d), zq (B, T) -> lp (B, G, T), and
K3 (`csrc/cascade_score_bwd.cu`), its backward.

Each launches on the current stream of the inputs' device and counts its
launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STAGES = 8


def check_shapes(op: str, x: torch.Tensor, w_eff: torch.Tensor,
                 zq: torch.Tensor, d: int) -> tuple[int, int, int]:
    """Raise unless w_eff is (T, d) with 1 <= T <= MAX_STAGES and zq is
    (B, T) for x's B groups; returns (B, G, T)."""
    b, g = x.shape[:2]
    t = w_eff.shape[0]
    if not 1 <= t <= MAX_STAGES:
        raise ValueError(f"{op}: cascade of {t} stages, the kernel takes "
                         f"1..{MAX_STAGES}")
    if w_eff.shape[1] != d or tuple(zq.shape) != (b, t):
        raise ValueError(f"{op}: shapes x {tuple(x.shape)}, w_eff "
                         f"{tuple(w_eff.shape)}, zq {tuple(zq.shape)} do not "
                         "agree")
    return b, g, t


def check_smem(op: str, need: int, d: int) -> None:
    if need > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{op}: d={d} needs more shared memory than a "
                         "block has")


def cascade_score_batched(x: torch.Tensor, w_eff: torch.Tensor,
                          zq: torch.Tensor) -> torch.Tensor:
    op = "cascade_score_batched"
    device = _build.check_inputs(op, x=x, w_eff=w_eff, zq=zq)
    d = x.shape[2]
    b, g, t = check_shapes(op, x, w_eff, zq, d)
    out = torch.empty((b, g, t), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    check_smem(op, lib.cascade_score_batched_smem(d, t), d)
    with torch.cuda.device(device):
        rc = lib.cascade_score_batched(
            x.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), out.data_ptr(),
            b, g, d, t, _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    cascade_score_batched.launches += 1
    return out


cascade_score_batched.launches = 0


def cascade_score_batched_bwd(x: torch.Tensor, w_eff: torch.Tensor,
                              zq: torch.Tensor, g: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K3: cotangent g (B, G, T) -> (dx (B, G, d), dw_eff (T, d), dzq (B, T))."""
    op = "cascade_score_batched_bwd"
    device = _build.check_inputs(op, x=x, w_eff=w_eff, zq=zq, g=g)
    d = x.shape[2]
    b, n, t = check_shapes(op, x, w_eff, zq, d)
    if tuple(g.shape) != (b, n, t):
        raise ValueError(f"{op}: cotangent of shape {tuple(g.shape)}, "
                         f"expected {(b, n, t)}")
    dx = torch.empty((b, n, d), dtype=torch.float32, device=device)
    dzq = torch.empty((b, t), dtype=torch.float32, device=device)
    if b == 0:
        return dx, torch.zeros((t, d), device=device), dzq
    dw = torch.empty((t, d), dtype=torch.float32, device=device)
    dw_part = torch.empty((t * d, b), dtype=torch.float32, device=device)
    lib = _build.load_library()
    check_smem(op, lib.cascade_score_bwd_smem(d, t), d)
    with torch.cuda.device(device):
        rc = lib.cascade_score_batched_bwd(
            x.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), dzq.data_ptr(), dw_part.data_ptr(),
            b, n, d, t, _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    cascade_score_batched_bwd.launches += 1
    return dx, dw, dzq


cascade_score_batched_bwd.launches = 0
