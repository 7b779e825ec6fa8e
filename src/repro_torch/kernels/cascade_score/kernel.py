"""Wrappers of the CUDA kernels K1 (`csrc/cascade_score.cu`), the batched
cascade scorer x (B, G, d), w_eff (T, d), zq (B, T) -> lp (B, G, T), and
K3 (`csrc/cascade_score_bwd.cu`), its backward; and of
`csrc/cascade_score_single.cu`: K6, the single-group scorer x (N, d),
w_eff (T, d), zq (T,) -> (N, T), with its backward, and K7, the same
function of the feature-major xt (d, N).

Each launches on the current stream of the inputs' device and counts its
launches in `<wrapper>.launches`. K1 and K3 take float32; K6 and K7 take
float32 or bfloat16 inputs (mixed as they come) and return float32.
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
    # scratch of the per-block dw partials, kept at B blocks: the grid is
    # one wave of the card, at most one block per group
    dw_part = torch.empty(t * d * b, dtype=torch.float32, device=device)
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


# ---------------------------------------------------------------------------
# K6 (forward and backward) and K7: one group of N items, one bias row
# ---------------------------------------------------------------------------

SINGLE_DTYPES = (torch.float32, torch.bfloat16)
MAX_ITEMS = 2**31 - 1          # the kernels index items with a 32-bit int


def check_single_shapes(op: str, n: int, d: int, w_eff: torch.Tensor,
                        zq: torch.Tensor) -> int:
    """Raise unless w_eff is (T, d) with 1 <= T <= MAX_STAGES and zq is
    (T,) for n <= MAX_ITEMS items of d features; returns T."""
    t = w_eff.shape[0]
    if not 1 <= t <= MAX_STAGES:
        raise ValueError(f"{op}: cascade of {t} stages, the kernel takes "
                         f"1..{MAX_STAGES}")
    if w_eff.shape[1] != d or tuple(zq.shape) != (t,):
        raise ValueError(f"{op}: {n} items of {d} features, w_eff "
                         f"{tuple(w_eff.shape)}, zq {tuple(zq.shape)} do not "
                         "agree")
    if n > MAX_ITEMS:
        raise ValueError(f"{op}: {n} items, the kernel takes at most "
                         f"{MAX_ITEMS}")
    return t


def _bf16_bits(*tensors: torch.Tensor) -> int:
    """Bit i set when the i-th tensor is bfloat16 (the kernels' `bf16`)."""
    return sum(1 << i for i, a in enumerate(tensors)
               if a.dtype == torch.bfloat16)


def _forward(wrapper, entry: str, x: torch.Tensor, w_eff: torch.Tensor,
             zq: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """Launch the forward kernel `entry` (K6 or K7) for `wrapper`, which
    names the op and counts the launch."""
    op = wrapper.__name__
    device = _build.check_inputs(op, SINGLE_DTYPES, x=x, w_eff=w_eff, zq=zq)
    t = check_single_shapes(op, n, d, w_eff, zq)
    out = torch.empty((n, t), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = _build.load_library()
    check_smem(op, getattr(lib, f"{entry}_smem")(d, t), d)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            x.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), out.data_ptr(),
            n, d, t, _bf16_bits(x, w_eff, zq), _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    wrapper.launches += 1
    return out


def cascade_score(x: torch.Tensor, w_eff: torch.Tensor,
                  zq: torch.Tensor) -> torch.Tensor:
    """K6: x (N, d), w_eff (T, d), zq (T,) -> (N, T) float32."""
    return _forward(cascade_score, "cascade_score_single", x, w_eff, zq,
                    *x.shape)


cascade_score.launches = 0


def cascade_score_fm(xt: torch.Tensor, w_eff: torch.Tensor,
                     zq: torch.Tensor) -> torch.Tensor:
    """K7: xt (d, N) feature-major, w_eff (T, d), zq (T,) -> (N, T) float32,
    contiguous (the reference returns its (T, N) result transposed)."""
    d, n = xt.shape
    return _forward(cascade_score_fm, "cascade_score_fm", xt, w_eff, zq, n, d)


cascade_score_fm.launches = 0


def cascade_score_bwd(x: torch.Tensor, w_eff: torch.Tensor, zq: torch.Tensor,
                      g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's backward: cotangent g (N, T) -> (dx (N, d), dw_eff (T, d),
    dzq (T,)), all float32; dw_eff and dzq are summed over the N items in a
    fixed order."""
    op = "cascade_score_bwd"
    device = _build.check_inputs(op, SINGLE_DTYPES, x=x, w_eff=w_eff, zq=zq,
                                 g=g)
    n, d = x.shape
    t = check_single_shapes(op, n, d, w_eff, zq)
    if tuple(g.shape) != (n, t):
        raise ValueError(f"{op}: cotangent of shape {tuple(g.shape)}, "
                         f"expected {(n, t)}")
    dx = torch.empty((n, d), dtype=torch.float32, device=device)
    if n == 0:
        sums = torch.zeros(t * d + t, dtype=torch.float32, device=device)
        return dx, sums[:t * d].view(t, d), sums[t * d:]
    lib = _build.load_library()
    check_smem(op, lib.cascade_score_single_bwd_smem(d, t), d)
    sums = torch.empty(t * d + t, dtype=torch.float32, device=device)
    part = torch.empty((t * d + t) * lib.cascade_score_single_bwd_blocks(n),
                       dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.cascade_score_single_bwd(
            x.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), g.data_ptr(),
            dx.data_ptr(), sums.data_ptr(), part.data_ptr(), n, d, t,
            _bf16_bits(x, w_eff, zq, g), _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    cascade_score_bwd.launches += 1
    return dx, sums[:t * d].view(t, d), sums[t * d:]


cascade_score_bwd.launches = 0
