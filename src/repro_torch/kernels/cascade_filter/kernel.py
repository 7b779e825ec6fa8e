"""Wrapper of the CUDA kernel K2 (`csrc/cascade_filter.cu`): the fused
score + Eq-10 keep counts + chained stable top-n_keep select, one thread
per item, each block walking query groups.

Launches on the current stream of the inputs' device and counts its
launches in `cascade_filter.launches`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STAGES = 8
MAX_GROUP = 512     # one thread per item


def cascade_filter(x: torch.Tensor, w_eff: torch.Tensor, zq: torch.Tensor,
                   mask: torch.Tensor, m_q: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
    """x (B, G, d), w_eff (T, d), zq (B, T), mask (B, G), m_q (B,) ->
    dict(lp (B, G, T), survivors (B, G, T) 0/1, expected_counts (B, T),
    n_keep (B, T)), all float32."""
    op = "cascade_filter"
    device = _build.check_inputs(op, x=x, w_eff=w_eff, zq=zq, mask=mask,
                                 m_q=m_q)
    b, g, d = x.shape
    t = w_eff.shape[0]
    if not 1 <= t <= MAX_STAGES:
        raise ValueError(f"{op}: cascade of {t} stages, the kernel takes "
                         f"1..{MAX_STAGES}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"{op}: group of {g} items, the kernel takes "
                         f"1..{MAX_GROUP}")
    if (w_eff.shape[1] != d or tuple(zq.shape) != (b, t)
            or tuple(mask.shape) != (b, g) or tuple(m_q.shape) != (b,)):
        raise ValueError(
            f"{op}: shapes x {tuple(x.shape)}, w_eff {tuple(w_eff.shape)}, "
            f"zq {tuple(zq.shape)}, mask {tuple(mask.shape)}, m_q "
            f"{tuple(m_q.shape)} do not agree")
    out = {
        "lp": torch.empty((b, g, t), dtype=torch.float32, device=device),
        "survivors": torch.empty((b, g, t), dtype=torch.float32,
                                 device=device),
        "expected_counts": torch.empty((b, t), dtype=torch.float32,
                                       device=device),
        "n_keep": torch.empty((b, t), dtype=torch.float32, device=device),
    }
    if b == 0:
        return out
    lib = _build.load_library()
    if lib.cascade_filter_smem(g, d, t) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{op}: d={d} needs more shared memory than a "
                         "block has")
    with torch.cuda.device(device):
        rc = lib.cascade_filter(
            x.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), mask.data_ptr(),
            m_q.data_ptr(), out["lp"].data_ptr(),
            out["survivors"].data_ptr(), out["expected_counts"].data_ptr(),
            out["n_keep"].data_ptr(), b, g, d, t,
            _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    _build.count_launch(cascade_filter)
    return out


cascade_filter.launches = 0
