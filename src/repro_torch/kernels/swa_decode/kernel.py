"""Wrapper of the CUDA kernel K8 (`csrc/swa_decode.cu`): one-token GQA
flash-decode attention, q (B, H, hd) against k/v (B, S, Hkv, hd) at the
host int `cache_len`, over the positions (cache_len - window, cache_len],
-> (B, H, hd) in q's dtype (float32 or bfloat16).

The wrapper plans the launch on the host: only the in-window positions
[lo, hi) are visited, cut into `n_split` contiguous splits so that the
grid is one full wave of the card — the SMs times the blocks of this
kernel instance that fit on one (asked of the CUDA runtime once per
instance) — even at B = 1. Each block handles one (batch, kv head, group
of up to 8 query heads, split); with several splits the last block of a
(batch, head group) to finish combines the per-split softmax partials in
split order, inside the same launch. The plan depends only on the shapes,
cache_len, window and the card, so two launches on the same inputs give
the same bits.

Launches on the current stream of the inputs' device and counts them in
`swa_decode.launches` (one CUDA launch per call).

`swa_decode_partial` is the same kernel in its partials mode, over the
slots [lo, hi) of one rank's block of a sequence-cut cache: one launch
(counted in `swa_decode_partial.launches`) that returns the block's
unnormalised softmax state (m, l, acc) for `models.parallel
.combine_partials`. An empty range launches nothing. The combine's tickets
are kept per (device, stream), so calls in flight on several streams of
one card never share, reset or free each other's (see `_tickets`).
"""

from __future__ import annotations

import functools
import math
import operator

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swa_decode.ref import NO_WINDOW

HEAD_DIMS = (64, 128)
MAX_HEAD_GROUP = 8      # query heads one block carries (kernel template)
MIN_SPLIT = 64          # positions below which a split is not worth a block
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _instance(index: int, hd: int, group: int, bf16: bool) -> tuple[int, int]:
    """(blocks per SM, positions per shared-memory stage) of the kernel
    instance, asked of the library once per instance and device."""
    lib = _build.load_library()
    with torch.cuda.device(index):
        per_sm = lib.swa_decode_blocks_per_sm(hd, group, int(bf16))
    if per_sm < 1:
        raise RuntimeError(f"swa_decode: no block of the (hd={hd}, group="
                           f"{group}, bf16={bf16}) instance fits on an SM")
    return per_sm, lib.swa_decode_tile(hd, int(bf16))


def head_group(rep: int) -> int:
    """Query heads per block: the smallest kernel instance (2, 4, 8)
    that holds all rep heads of a kv head, else groups of 8 (rep 1 runs
    in the group-2 instance, which masks the heads it does not have)."""
    for g in (2, 4):
        if rep <= g:
            return g
    return MAX_HEAD_GROUP


def plan(b: int, s: int, h: int, hkv: int, cache_len: int, window: int,
         n_sm: int, blocks_per_sm: int, tile: int) -> dict:
    """The launch plan of one call (host ints only): the most splits of
    at least MIN_SPLIT positions that keep the grid within one wave of
    n_sm * blocks_per_sm blocks, each split a whole number of `tile`
    positions (the kernel's shared-memory stage) but the last."""
    return plan_range(b, h, hkv, max(0, cache_len - window + 1),
                      cache_len + 1, n_sm, blocks_per_sm, tile)


def plan_range(b: int, h: int, hkv: int, lo: int, hi: int, n_sm: int,
               blocks_per_sm: int, tile: int) -> dict:
    """`plan` over the slots [lo, hi) (non-empty: every split must hold a
    position)."""
    if lo >= hi:
        raise ValueError(f"swa_decode: empty range [{lo}, {hi})")
    rep = h // hkv
    group = head_group(rep)
    units = b * hkv * (-(-rep // group))
    n_valid = hi - lo
    slots = n_sm * blocks_per_sm
    n_split = max(1, min(slots // units, -(-n_valid // MIN_SPLIT)))
    split_len = -(-n_valid // n_split)
    split_len = -(-split_len // tile) * tile
    n_split = -(-n_valid // split_len)
    blocks = units * n_split
    return dict(lo=lo, hi=hi, group=group, n_split=n_split,
                split_len=split_len, units=units, blocks=blocks,
                blocks_per_sm=blocks_per_sm, waves=-(-blocks // slots))


def check_args(op: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cache_len: int, window: int) -> tuple[int, int, int, int, int]:
    """Raise unless the shapes, types and positions are ones the kernel
    takes; returns (B, S, H, Hkv, hd)."""
    b, s, h, hkv, hd = check_shapes(op, q, k, v)
    if not 0 <= cache_len < s:
        raise ValueError(f"{op}: cache_len {cache_len} outside the cache "
                         f"of {s} slots")
    if window < 1:
        raise ValueError(f"{op}: window {window} < 1")
    return b, s, h, hkv, hd


def check_range(op: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lo: int, hi: int) -> tuple[int, int, int, int, int]:
    """check_args for the partials mode's slots [lo, hi) of the block
    (empty when lo >= hi)."""
    b, s, h, hkv, hd = check_shapes(op, q, k, v)
    if lo < 0 or hi > s:
        raise ValueError(f"{op}: slots [{lo}, {hi}) outside the block of "
                         f"{s} slots")
    return b, s, h, hkv, hd


def check_shapes(op: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> tuple[int, int, int, int, int]:
    """Raise unless q (B, H, hd) and k / v (B, S, Hkv, hd) are shapes and
    types the kernel takes; returns (B, S, H, Hkv, hd)."""
    if q.ndim != 3 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{op}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, H, hd) and two "
                         "(B, S, Hkv, hd)")
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or h % hkv:
        raise ValueError(f"{op}: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (H must be a multiple of Hkv)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{op}: head dim {hd}, the kernel takes {HEAD_DIMS}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{op}: q, k, v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    return b, s, h, hkv, hd


def _check_aligned(op: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned")


def _launch_plan(device: torch.device, q: torch.Tensor, b: int, h: int,
                 hkv: int, hd: int, lo: int, hi: int):
    """(plan, split partials (2, n) and (n, hd), tickets, stream, group,
    bf16) of one launch over the slots [lo, hi)."""
    bf16 = q.dtype == torch.bfloat16
    group = head_group(h // hkv)
    per_sm, tile = _instance(device.index, hd, group, bf16)
    p = plan_range(b, h, hkv, lo, hi, _sm_count(device.index), per_sm, tile)
    n_part = b * h * p["n_split"] if p["n_split"] > 1 else 0
    part_ml = torch.empty((2, n_part), dtype=torch.float32, device=device)
    part_acc = torch.empty((n_part, hd), dtype=torch.float32, device=device)
    stream = _build.stream_handle(device)
    tickets = _tickets(device, stream, p["units"])
    return p, part_ml, part_acc, tickets, stream, group, bf16


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cache_len: int, window: int = NO_WINDOW) -> torch.Tensor:
    op = "swa_decode"
    cache_len, window = operator.index(cache_len), operator.index(window)
    device = _build.check_inputs(op, dtypes=DTYPES, q=q, k=k, v=v)
    b, s, h, hkv, hd = check_args(op, q, k, v, cache_len, window)
    _check_aligned(op, q=q, k=k, v=v)
    out = torch.empty((b, h, hd), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    p, part_ml, part_acc, tickets, stream, group, bf16 = _launch_plan(
        device, q, b, h, hkv, hd, max(0, cache_len - window + 1),
        cache_len + 1)
    lib = _build.load_library()
    with torch.cuda.device(device):
        rc = lib.swa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part_ml[0].data_ptr(), part_ml[1].data_ptr(),
            part_acc.data_ptr(), tickets.data_ptr(), b, s, h, hkv, hd,
            group, int(bf16), p["lo"], p["hi"], p["n_split"],
            p["split_len"], 1.0 / math.sqrt(hd), stream)
    _build.check_launch(lib, op, rc)
    _build.count_launch(swa_decode)
    return out


swa_decode.launches = 0


def swa_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lo: int, hi: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's partials mode: q (B, H, hd) over the slots [lo, hi) of one
    block k/v (B, S, Hkv, hd) -> (m (B, H), l (B, H), acc (B, H, hd)),
    float32, m in natural-log units (`ref.swa_decode_partial_ref`). One
    launch, planned as `swa_decode`'s over [lo, hi), with its tickets,
    streams and checks. An empty range (lo >= hi: a block wholly past the
    query's position) launches nothing, counts no launch and returns m =
    -inf, l = 0, acc = 0."""
    op = "swa_decode_partial"
    lo, hi = operator.index(lo), operator.index(hi)
    device = _build.check_inputs(op, dtypes=DTYPES, q=q, k=k, v=v)
    b, s, h, hkv, hd = check_range(op, q, k, v, lo, hi)
    _check_aligned(op, q=q, k=k, v=v)
    if lo >= hi or b * h == 0:
        return (torch.full((b, h), -torch.inf, device=device),
                torch.zeros((b, h), device=device),
                torch.zeros((b, h, hd), device=device))
    m = torch.empty((b, h), dtype=torch.float32, device=device)
    l = torch.empty((b, h), dtype=torch.float32, device=device)
    acc = torch.empty((b, h, hd), dtype=torch.float32, device=device)
    p, part_ml, part_acc, tickets, stream, group, bf16 = _launch_plan(
        device, q, b, h, hkv, hd, lo, hi)
    lib = _build.load_library()
    with torch.cuda.device(device):
        rc = lib.swa_decode_partial(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), part_acc.data_ptr(), tickets.data_ptr(),
            b, s, h, hkv, hd, group, int(bf16), p["lo"], p["hi"],
            p["n_split"], p["split_len"], 1.0 / math.sqrt(hd), stream)
    _build.check_launch(lib, op, rc)
    _build.count_launch(swa_decode_partial)
    return m, l, acc


swa_decode_partial.launches = 0

# (device, stream handle) -> that stream's int32 tickets
_ticket_arrays: dict[tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The int32 tickets of one stream of `device` (`stream` is its handle,
    the one the kernel launches on), one per (batch, kv head, head group)
    unit, zero between calls: the last block of a unit resets its own.
    Allocated once per stream and grown, zeroed, when a call needs more.

    Per stream, because a ticket slot is numbered from 0 in every call:
    calls on one stream run in order and so never share a slot, but two
    calls in flight on two streams would count and reset each other's.
    Growing is safe too: the array is allocated while `stream` is current
    (the caller launches on it), so PyTorch's caching allocator ties its
    block to that stream, and when the replaced array is dropped the block
    is reused only by later work on the same stream, which runs after
    every kernel already queued there that reads it. No other stream ever
    holds it."""
    key = (device, stream)
    t = _ticket_arrays.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ticket_arrays[key] = t
    return t
