"""Model parallelism over torch.distributed ranks: the port's `shard_map`.

The reference lays a model over a device mesh in two ways: GSPMD turns
`launch/sharding.param_shardings` into a compiled SPMD program, and
`shard_map` writes a layer explicitly (`moe_ffn_shmap`). The port has no
GSPMD, so it does what `shard_map` does, explicitly, under the "tp"
layout (`launch/sharding.py`):
  * each rank holds its shard of every parameter (`models.base
    .shard_params`): its heads and kv heads (wq / wk / wv columns, wo
    rows), its columns of the MLP, its experts, its rows of the
    vocabulary; norms and the router whole;
  * it runs the layer code on those local shapes;
  * it calls a collective where the reference's sharded program reduces:
    an all-reduce after every row-parallel output projection (attention's
    wo, the MLP's wo) and at the end of the expert-parallel MoE, an
    all-reduce in the vocabulary-parallel embedding, an all-gather of the
    vocabulary-parallel logits.

The reference's sequence-sharded variants (`attn_shard="seqkv"` /
`"shmap"`) keep the "tp" parameter layout and cut the KV sequence over
the ranks instead of the kv heads (the "seq" cache layout): each rank
attends over its block of the keys and `combine_partials` merges the
ranks' softmax states, as the reference's `shmap_attention` does with a
pmax and two psums.

Every collective of such a run goes through one `ModelParallel`, which
counts each kind's calls and the bytes each rank puts in. With no
ModelParallel (`mp=None`, the default of every entry point) nothing is
sharded and nothing is reduced. `launch.mesh.model_parallel` builds one in
each rank of a run; `launch.mesh.spawn_ranks` starts the ranks.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

# the arch types the "tp" layout runs on; the recurrent and encdec
# families' cache layouts come in a later slice
TP_ARCH_TYPES = ("dense", "moe")
# ModelConfig.attn_shard: "auto" (heads over the ranks) or one of the
# reference's sequence-sharded variants, each with the wire its attention
# combine over fresh keys crosses ("shmap" casts to bfloat16, as the
# reference's shmap_attention; "seqkv" reduces in float32, as its GSPMD)
SEQ_VARIANTS = {"seqkv": torch.float32, "shmap": torch.bfloat16}
ATTN_SHARDS = ("auto", *SEQ_VARIANTS)


@dataclasses.dataclass
class ModelParallel:
    """One rank's view of a model-parallel run: its rank on the ("data",
    "model") mesh `mesh` (`launch.mesh.MeshShape`, data of size 1), the
    world size, the transport ("nccl" or "gloo") and the rank's device;
    the collectives run on the default process group. `calls` and `bytes`
    count them by kind ("all_reduce_sum", "all_reduce_max",
    "all_gather"): calls, and the bytes of the tensor this rank puts in."""

    rank: int
    world: int
    mesh: Any
    backend: str
    device: torch.device = torch.device("cpu")
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += x.numel() * x.element_size()

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks, IN PLACE (the reference's psum); every
        rank then holds the same bits."""
        self._count("all_reduce_sum", x)
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """x's elementwise max over the ranks, in place (pmax)."""
        self._count("all_reduce_max", x)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' x concatenated along `dim` in rank order (the gather
        GSPMD inserts to make a cut tensor whole)."""
        x = x.contiguous()
        self._count("all_gather", x)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()


def check_tp(cfg, world: int) -> None:
    """Raise ValueError unless `world` ranks can run cfg under the "tp"
    layout as the port executes it: a dense or moe model whose heads, kv
    heads, vocabulary, dense MLP columns and experts `world` divides. (The
    reference's rules keep an undivided dim whole, and its cache rule
    splits a kv head across ranks (`sharding.py` cache_shardings); the
    port refuses both.)"""
    if cfg.arch_type not in TP_ARCH_TYPES:
        raise ValueError(f"{cfg.name}: the \"tp\" layout runs the "
                         f"{TP_ARCH_TYPES} families, not {cfg.arch_type!r}")
    if cfg.attn_shard not in ATTN_SHARDS:
        raise ValueError(f"{cfg.name}: attn_shard {cfg.attn_shard!r}, "
                         f"expected one of {ATTN_SHARDS}")
    dims = {"heads": cfg.n_heads, "kv heads": cfg.n_kv_heads,
            "vocab": cfg.vocab}
    if cfg.arch_type == "dense" or cfg.dense_residual:
        dims["ffn"] = cfg.d_ff
    if cfg.arch_type == "moe":
        dims["experts"] = cfg.n_experts
    bad = {k: v for k, v in dims.items() if v % world}
    if bad:
        raise ValueError(f"{cfg.name}: the \"tp\" layout over {world} ranks "
                         f"needs {world} to divide its {bad}")


def reduce_partial(mp: ModelParallel | None,
                   y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum on this rank, summed over the
    ranks (y itself without model parallelism)."""
    return y if mp is None else mp.all_reduce_sum(y)


def combine_partials(mp: ModelParallel | None, m: torch.Tensor,
                     l: torch.Tensor, acc: torch.Tensor,
                     wire: torch.dtype) -> torch.Tensor:
    """The attention output, float32, of softmax states over disjoint
    blocks of the keys: m and l (...), acc (..., hd), float32, m in
    natural-log units (-inf where a block holds no key of a row). M is the
    largest m; each state's l and acc are scaled by exp(m - M) (0 where m
    is -inf) and summed, acc in `wire`; returns acc / max(l, 1e-30).

    Across the ranks of mp (one state each): one `all_reduce_max` of m,
    then one `all_reduce_sum` of l and acc packed into one tensor when
    `wire` is float32; with a narrower wire acc crosses in it (the
    reference's `shmap_attention` casts to bfloat16) beside l in float32,
    two all-reduces. The same bits on every rank. With mp None, m, l and
    acc carry a leading axis of blocks (one process's states, stacked)
    and the same combine runs over it with no collective."""
    big = m.amax(0) if mp is None else mp.all_reduce_max(m.clone())
    scale = torch.where(torch.isfinite(m), torch.exp(m - big), 0.0)
    l = l * scale
    acc = acc * scale[..., None]
    if mp is None:
        l, acc = l.sum(0), acc.to(wire).sum(0).float()
    elif wire == torch.float32:
        both = mp.all_reduce_sum(torch.cat([l.reshape(-1), acc.reshape(-1)]))
        l, acc = both[:l.numel()].view(l.shape), both[l.numel():].view(
            acc.shape)
    else:
        l = mp.all_reduce_sum(l)
        acc = mp.all_reduce_sum(acc.to(wire)).float()
    return acc / torch.clamp(l, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# A rank's part of a laid-out tensor (layouts: launch/sharding.py)
# ---------------------------------------------------------------------------

def rank_coords(mesh, rank: int) -> dict[str, int]:
    """The coordinate of `rank` on each mesh axis, ranks numbered
    row-major over the axes (the last axis fastest)."""
    coords = {}
    for a in reversed(mesh.axis_names):
        rank, coords[a] = divmod(rank, mesh.shape[a])
    return coords


def local_slices(shape: tuple[int, ...], spec: tuple, mesh,
                 rank: int) -> list[tuple[int, int]]:
    """(start, length) along every dim of the part of a tensor of `shape`
    laid out by `spec` that `rank` holds: a dim cut over axes (a1, a2, ...)
    is cut into their product of equal blocks, block index the ranks'
    coordinates on those axes, row-major."""
    coords = rank_coords(mesh, rank)
    out = []
    for dim, axes in zip(shape, spec):
        n, idx = 1, 0
        for a in (axes,) if isinstance(axes, str) else tuple(axes or ()):
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"a dim of {dim} cannot be cut {n} ways "
                             f"(layout {spec})")
        out.append((idx * (dim // n), dim // n))
    return out
