"""Wrappers of the CUDA kernels K4 and K5 (`csrc/cascade_loss.cu`): the
fused L3 training-step reductions over the packed items and their
backward, plus the packed-item layout both they and the plain versions
read.

Packed items: xc (B, G, d_x + 4) = [x | y | mask | wgt | cost_w] along the
feature axis (`pack_items`), the trainer's engine-batch layout.

Each wrapper launches on the current stream of the inputs' device and
counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cascade_score.kernel import check_shapes, check_smem

# Number of data columns packed after the d_x features: y, mask, wgt, cost_w.
N_DATA_COLS = 4

# The NLL's clamp: log p kept <= -1e-7 so 1 - p stays positive in float32
# (the same literal as core.losses.nll_from_lp and csrc/cascade_loss.cu).
LOG_P_CLAMP = -1e-7


def pack_items(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
               wgt: torch.Tensor, cost_w: torch.Tensor) -> torch.Tensor:
    """THE packed-item layout: [x | y | mask | wgt | cost_w] along the
    feature axis — the one definition of the column order that the kernels,
    the plain versions and the trainer's engine pack slice by."""
    return torch.cat([x, y[..., None], mask[..., None], wgt[..., None],
                      cost_w[..., None]], dim=-1)


def _check_packed(op: str, xc: torch.Tensor, w_eff: torch.Tensor,
                  zq: torch.Tensor) -> tuple[int, int, int, int]:
    d = w_eff.shape[1]
    if xc.shape[2] != d + N_DATA_COLS:
        raise ValueError(f"{op}: packed item width {xc.shape[2]} != d_x + "
                         f"{N_DATA_COLS} (d_x={d})")
    b, g, t = check_shapes(op, xc, w_eff, zq, d)
    return b, g, d, t


def cascade_loss(xc: torch.Tensor, w_eff: torch.Tensor, zq: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: xc (B, G, d_x+4), w_eff (T, d_x), zq (B, T) ->
    (ll (B,), cost_pp (T,), cnt_pp (B, T))."""
    op = "cascade_loss"
    device = _build.check_inputs(op, xc=xc, w_eff=w_eff, zq=zq)
    b, g, d, t = _check_packed(op, xc, w_eff, zq)
    ll = torch.empty((b,), dtype=torch.float32, device=device)
    cnt = torch.empty((b, t), dtype=torch.float32, device=device)
    if b == 0:
        return ll, torch.zeros((t,), device=device), cnt
    cost = torch.empty((t,), dtype=torch.float32, device=device)
    # scratch of the per-block cost_pp partials, kept at B blocks: the grid
    # is one wave of the card, at most one block per group
    cost_part = torch.empty(t * b, dtype=torch.float32, device=device)
    lib = _build.load_library()
    check_smem(op, lib.cascade_loss_smem(d, t), d)
    with torch.cuda.device(device):
        rc = lib.cascade_loss(
            xc.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), ll.data_ptr(),
            cost.data_ptr(), cnt.data_ptr(), cost_part.data_ptr(),
            b, g, d, t, _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    _build.count_launch(cascade_loss)
    return ll, cost, cnt


cascade_loss.launches = 0


def cascade_loss_bwd(xc: torch.Tensor, w_eff: torch.Tensor, zq: torch.Tensor,
                     g_ll: torch.Tensor, g_cost: torch.Tensor,
                     g_cnt: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """K5: cotangents g_ll (B,), g_cost (T,), g_cnt (B, T) ->
    (dxc (B, G, d_x+4), dw_eff (T, d_x), dzq (B, T), dzq_pen (B, T))."""
    op = "cascade_loss_bwd"
    device = _build.check_inputs(op, xc=xc, w_eff=w_eff, zq=zq, g_ll=g_ll,
                                 g_cost=g_cost, g_cnt=g_cnt)
    b, g, d, t = _check_packed(op, xc, w_eff, zq)
    want = {"g_ll": (b,), "g_cost": (t,), "g_cnt": (b, t)}
    got = {"g_ll": tuple(g_ll.shape), "g_cost": tuple(g_cost.shape),
           "g_cnt": tuple(g_cnt.shape)}
    if got != want:
        raise ValueError(f"{op}: cotangent shapes {got}, expected {want}")
    dxc = torch.empty((b, g, d + N_DATA_COLS), dtype=torch.float32,
                      device=device)
    dzq = torch.empty((b, t), dtype=torch.float32, device=device)
    dzq_pen = torch.empty((b, t), dtype=torch.float32, device=device)
    if b == 0:
        return dxc, torch.zeros((t, d), device=device), dzq, dzq_pen
    dw = torch.empty((t, d), dtype=torch.float32, device=device)
    # as cost_part in cascade_loss
    dw_part = torch.empty(t * d * b, dtype=torch.float32, device=device)
    lib = _build.load_library()
    check_smem(op, lib.cascade_loss_bwd_smem(d, t), d)
    with torch.cuda.device(device):
        rc = lib.cascade_loss_bwd(
            xc.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), g_ll.data_ptr(),
            g_cost.data_ptr(), g_cnt.data_ptr(), dxc.data_ptr(),
            dw.data_ptr(), dzq.data_ptr(), dzq_pen.data_ptr(),
            dw_part.data_ptr(), b, g, d, t, _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    _build.count_launch(cascade_loss_bwd)
    return dxc, dw, dzq, dzq_pen


cascade_loss_bwd.launches = 0
