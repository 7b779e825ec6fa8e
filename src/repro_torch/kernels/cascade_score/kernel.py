"""Wrappers of the CUDA kernels K1 (`csrc/cascade_score.cu`), the batched
cascade scorer x (B, G, d), w_eff (T, d), zq (B, T) -> lp (B, G, T), and
K3 (`csrc/cascade_score_bwd.cu`), its backward; of K6, the single-group
scorer x (N, d), w_eff (T, d), zq (T,) -> (N, T), which takes a leading
group axis too (B groups in one launch, as `jax.vmap` gives the
reference's kernel a grid axis): its forward is K1's kernel
(`csrc/cascade_score.cu`), its backward in `csrc/cascade_score_single.cu`;
and of K7 (`csrc/cascade_score_single.cu`), K6's function of the
feature-major xt (d, N).

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
    _build.count_launch(cascade_score_batched)
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
    _build.count_launch(cascade_score_batched_bwd)
    return dx, dw, dzq


cascade_score_batched_bwd.launches = 0


# ---------------------------------------------------------------------------
# K6 (forward and backward) and K7: groups of N items
# ---------------------------------------------------------------------------

SINGLE_DTYPES = (torch.float32, torch.bfloat16)
MAX_ITEMS = 2**31 - 1          # the kernels index items with a 32-bit int
# K6's backward cuts each group into pieces: a group of up to
# WHOLE_GROUP_ROWS items is one piece, a larger one PIECE_ROWS-row pieces
# (the last one shorter).
WHOLE_GROUP_ROWS = 256
PIECE_ROWS = 128


def piece_plan(n: int) -> tuple[int, int]:
    """(rows per piece, pieces per group) of K6's backward for groups of n
    items. A function of n alone, so the order of the kernel's sums
    depends only on the shapes: a block adds a piece's rows, the pieces'
    partials are added in piece order."""
    rows = PIECE_ROWS if n > WHOLE_GROUP_ROWS else max(n, 1)
    return rows, -(-n // rows)


def check_single_shapes(op: str, n: int, d: int, w_eff: torch.Tensor,
                        zq: torch.Tensor, groups: int | None = None) -> int:
    """Raise unless w_eff is (T, d) with 1 <= T <= MAX_STAGES and zq is
    (T,) — or (groups, T) when `groups` is given — for n <= MAX_ITEMS
    items of d features in all; returns T."""
    t = w_eff.shape[0]
    if not 1 <= t <= MAX_STAGES:
        raise ValueError(f"{op}: cascade of {t} stages, the kernel takes "
                         f"1..{MAX_STAGES}")
    zq_ok = tuple(zq.shape) == (t,) or (
        groups is not None and tuple(zq.shape) == (groups, t))
    if w_eff.shape[1] != d or not zq_ok:
        raise ValueError(f"{op}: {n} items of {d} features, w_eff "
                         f"{tuple(w_eff.shape)}, zq {tuple(zq.shape)} do not "
                         "agree")
    if n > MAX_ITEMS:
        raise ValueError(f"{op}: {n} items, the kernel takes at most "
                         f"{MAX_ITEMS}")
    return t


def _groups(op: str, x: torch.Tensor, w_eff: torch.Tensor,
            zq: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(B, N, d, T, zq's group stride) of K6's inputs: x (N, d) with zq
    (T,) is one group; x (B, N, d) with zq (B, T) is B groups, and with zq
    (T,) B groups that share one bias row (stride 0)."""
    if x.ndim not in (2, 3):
        raise ValueError(f"{op}: x of shape {tuple(x.shape)}, expected "
                         "(N, d) or (B, N, d)")
    b, n, d = (1, *x.shape) if x.ndim == 2 else x.shape
    t = check_single_shapes(op, b * n, d, w_eff, zq,
                            groups=b if x.ndim == 3 else None)
    return b, n, d, t, t if zq.ndim == 2 or x.ndim == 2 else 0


def _bf16_bits(*tensors: torch.Tensor) -> int:
    """Bit i set when the i-th tensor is bfloat16 (the kernels' `bf16`)."""
    return sum(1 << i for i, a in enumerate(tensors)
               if a.dtype == torch.bfloat16)


def cascade_score(x: torch.Tensor, w_eff: torch.Tensor,
                  zq: torch.Tensor) -> torch.Tensor:
    """K6: x (N, d), w_eff (T, d), zq (T,) -> (N, T) float32; or B groups
    at once, x (B, N, d) and zq (B, T), or zq (T,) shared by every group,
    -> (B, N, T). One launch either way."""
    op = "cascade_score"
    device = _build.check_inputs(op, SINGLE_DTYPES, x=x, w_eff=w_eff, zq=zq)
    b, n, d, t, zq_stride = _groups(op, x, w_eff, zq)
    out = torch.empty((*x.shape[:-1], t), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    bf16 = _bf16_bits(x, w_eff, zq)
    check_smem(op, lib.cascade_score_groups_smem(d, t, bf16), d)
    with torch.cuda.device(device):
        rc = lib.cascade_score_groups(
            x.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), out.data_ptr(),
            b, n, d, t, zq_stride, bf16, _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    _build.count_launch(cascade_score)
    return out


cascade_score.launches = 0


def cascade_score_fm(xt: torch.Tensor, w_eff: torch.Tensor,
                     zq: torch.Tensor) -> torch.Tensor:
    """K7: xt (d, N) feature-major, w_eff (T, d), zq (T,) -> (N, T) float32,
    contiguous (the reference returns its (T, N) result transposed)."""
    op = "cascade_score_fm"
    device = _build.check_inputs(op, SINGLE_DTYPES, xt=xt, w_eff=w_eff,
                                 zq=zq)
    d, n = xt.shape
    t = check_single_shapes(op, n, d, w_eff, zq)
    out = torch.empty((n, t), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = _build.load_library()
    check_smem(op, lib.cascade_score_fm_smem(d, t), d)
    with torch.cuda.device(device):
        rc = lib.cascade_score_fm(
            xt.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), out.data_ptr(),
            n, d, t, _bf16_bits(xt, w_eff, zq), _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    _build.count_launch(cascade_score_fm)
    return out


cascade_score_fm.launches = 0


def cascade_score_bwd(x: torch.Tensor, w_eff: torch.Tensor, zq: torch.Tensor,
                      g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's backward: cotangent g (..., N, T) of `cascade_score`'s output ->
    (dx shaped as x, dw_eff (T, d), dzq shaped as zq), all float32; dw_eff
    is summed over every item, dzq over each group's items (every item
    when zq is shared), in an order fixed by the shapes (`piece_plan`).
    One call: the kernel, then the pieces' partials added in piece order
    (one pass, or two when dzq sums a group's pieces of several)."""
    op = "cascade_score_bwd"
    device = _build.check_inputs(op, SINGLE_DTYPES, x=x, w_eff=w_eff, zq=zq,
                                 g=g)
    b, n, d, t, zq_stride = _groups(op, x, w_eff, zq)
    if tuple(g.shape) != (*x.shape[:-1], t):
        raise ValueError(f"{op}: cotangent of shape {tuple(g.shape)}, "
                         f"expected {(*x.shape[:-1], t)}")
    dx = torch.empty(x.shape, dtype=torch.float32, device=device)
    if b * n == 0:
        return (dx, torch.zeros((t, d), device=device),
                torch.zeros(zq.shape, device=device))
    lib = _build.load_library()
    bf16 = _bf16_bits(x, w_eff, zq, g)
    check_smem(op, lib.cascade_score_groups_bwd_smem(d, t, bf16), d)
    rows, per_group = piece_plan(n)
    # [dw | dzq], and the pieces' partials: (t * d + t) rows of b * per_group
    sums = torch.empty(t * d + zq.numel(), dtype=torch.float32, device=device)
    part = torch.empty((t * d + t) * b * per_group, dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        rc = lib.cascade_score_groups_bwd(
            x.data_ptr(), w_eff.data_ptr(), zq.data_ptr(), g.data_ptr(),
            dx.data_ptr(), sums.data_ptr(), part.data_ptr(), b, n, d, t,
            zq_stride, rows, bf16, _build.stream_handle(device))
    _build.check_launch(lib, op, rc)
    _build.count_launch(cascade_score_bwd)
    return dx, sums[:t * d].view(t, d), sums[t * d:].view(zq.shape)


cascade_score_bwd.launches = 0
