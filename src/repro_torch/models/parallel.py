"""Model parallelism over torch.distributed ranks: the port's `shard_map`.

The reference lays a model over a device mesh in two ways: GSPMD turns
`launch/sharding.param_shardings` into a compiled SPMD program, and
`shard_map` writes a layer explicitly (`moe_ffn_shmap`). The port has no
GSPMD, so it does what `shard_map` does, explicitly, under the "tp"
layout (`launch/sharding.py`), for every family of the zoo:
  * each rank holds its shard of every parameter (`models.base
    .shard_params`): its heads and kv heads (wq / wk / wv columns, wo
    rows; RWKV-6's wr / wk / wv / wg columns and wo rows; Mamba2's heads),
    its columns of the MLP, its experts, its rows of the vocabulary where
    the ranks divide it; norms and the router whole. Where the
    reference's cut of a leaf is not a block a rank can compute on alone
    (Mamba2's fused in_proj / conv_w / conv_b; wk / wv where the ranks do
    not divide the kv heads, which the reference cuts within a head), the
    rank holds the pieces `rank_pieces` names instead: for wk / wv, the
    whole kv heads its query heads read (`kv_heads`), so that several
    ranks hold one kv head;
  * it runs the layer code on those local shapes;
  * it calls a collective where the reference's sharded program reduces:
    an all-reduce after every row-parallel output projection (attention's
    wo, the MLP's wo, Mamba2's out_proj, RWKV-6's time-mix wo and
    channel-mix wv) and at the end of the expert-parallel MoE, one in
    Mamba2's out_norm (the sum of squares over d_inner), an all-gather of
    RWKV-6's channel-mix output, an all-reduce in the vocabulary-parallel
    embedding and an all-gather of the vocabulary-parallel logits (none
    of those two where the vocabulary stays whole).

The reference's sequence-sharded variants (`attn_shard="seqkv"` /
`"shmap"`) keep the "tp" parameter layout and cut the KV sequence over
the ranks instead of the kv heads (the "seq" cache layout; every family:
zamba2's shared-block cache and seamless's self and cross K/V too, the
ssm family having no attention to cut): each rank attends over its block
of the keys and `combine_partials` merges the ranks' softmax states, as
the reference's `shmap_attention` does with a pmax and two psums.

Training (`zoo.train_step` with a `TrainLayout`, `check_train`) runs over
a ("data", "model") mesh under the reference's "tp" and "zero3" layouts
for every family, and "fsdp" for the dense and moe families, as GSPMD
partitions its unsharded step: the batch is cut over "data"; a leaf whose
`embed` dim the layout cuts over the data axes (and, under "zero3",
"model" too) is all-gathered where it is used (`gather_for_use`) and its
gradient reduce-scattered back to the rank's block; an op that saves the
gathered weight for the backward saves the shard instead, and the
backward gathers it again (`regather_saved`); a leaf the layout leaves
whole over "data" has its gradient summed over "data" after the backward
(`reduce_replicated_grads`). The model-axis collectives of the forward
have autograd forms (Megatron's pair: `reduce_partial` sums forward and
passes the gradient through, `enter_partial` passes forward and sums the
gradient, also on a whole leaf, or a piece of one, that each rank uses
on its own heads; `reduce_shared` sums both ways, for a sum each rank
uses on its own channels; `gather_last`), so that the "tp" partial sums
train. Serving under "zero3" (`serving.engine.serve_weights`) gathers a
sublayer's leaves where it runs them and narrows them to the rank's "tp"
pieces (`layout_use` with `serve_pieces`), so the "tp" code serves; the
head is never gathered (`gathered_logits`), nor the embedding where the
batch's tokens are fewer than its rows (`gathered_lookup`).

Every collective of such a run goes through one `ModelParallel`, which
counts each kind's calls and the bytes each rank puts in. With no
ModelParallel (`mp=None`, the default of every entry point) nothing is
sharded and nothing is reduced. `launch.mesh.model_parallel` builds one in
each rank of a run; `launch.mesh.spawn_ranks` starts the ranks.
`ModelParallel.counting(mesh, rank)` builds one rank of a mesh whose
transport only counts (backend "meta", on `meta` tensors, no process
group): the pod dry run (`launch/dryrun.py`) traces a rank's step with it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import weakref
from typing import Any

import torch
import torch.distributed as dist

# the arch types the "tp" layout runs on: every family of the zoo
TP_ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "encdec")
# ModelConfig.attn_shard: "auto" (heads over the ranks) or one of the
# reference's sequence-sharded variants, each with the wire its attention
# combine over fresh keys crosses ("shmap" casts to bfloat16, as the
# reference's shmap_attention; "seqkv" reduces in float32, as its GSPMD)
SEQ_VARIANTS = {"seqkv": torch.float32, "shmap": torch.bfloat16}
ATTN_SHARDS = ("auto", *SEQ_VARIANTS)


@dataclasses.dataclass
class ModelParallel:
    """One rank's view of a model-parallel run on the ("data", "model")
    mesh `mesh` (`launch.mesh.MeshShape`): `rank` and `world` are its
    coordinate on and the size of the "model" axis (what the layer code
    reads), `data_rank` / `data_world` those of "data"; the ranks are
    numbered row-major (`global_rank`). The transport ("nccl" or "gloo"),
    the rank's device, and the process groups of its mesh row (the ranks
    along "model") and column (along "data"): None is the default group.
    Only where both axes have more than one rank are there groups of their
    own; a collective over an axis of one rank is not made and not
    counted, so a collective on the default group is over an axis that
    spans every rank. `calls` and `bytes` count the collectives by kind
    ("all_reduce_sum", "all_reduce_max", "all_gather", "reduce_scatter"):
    calls, and the bytes of the tensor this rank puts in. Where `log` is a
    list, each call also appends (kind, bytes put in, the global ranks
    of its group, the bytes of one element) to it (the pod dry run prices
    each call by its group).

    Backend "meta" (`counting`) is a transport that only counts: every
    collective counts as above and returns what it would, shaped as the
    real one's, without moving data; it refuses a tensor that is not on
    `meta`, so it never stands in for a real transport."""

    rank: int
    world: int
    mesh: Any
    backend: str
    device: torch.device = torch.device("cpu")
    data_rank: int = 0
    data_world: int = 1
    model_group: Any = None
    data_group: Any = None
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # storage of a weight gathered for use -> what gathers it again
    # (`regather_saved`); None outside a training forward
    regather: dict | None = None
    log: list | None = None

    @classmethod
    def counting(cls, mesh, rank: int) -> "ModelParallel":
        """Global rank `rank` (row-major) of the ("data", "model") `mesh`
        over the counting transport: backend "meta", device `meta`, no
        process group; `log` collects every call."""
        if tuple(mesh.axis_names) != ("data", "model"):
            raise ValueError(f"a (\"data\", \"model\") mesh, not {mesh}")
        n_data, n_model = mesh.sizes
        data_rank, model_rank = divmod(rank, n_model)
        return cls(rank=model_rank, world=n_model, mesh=mesh, backend="meta",
                   device=torch.device("meta"), data_rank=data_rank,
                   data_world=n_data, log=[])

    @property
    def global_rank(self) -> int:
        return self.data_rank * self.world + self.rank

    def _count(self, kind: str, nbytes: int, members: list[int],
               itemsize: int) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += nbytes
        if self.log is not None:
            self.log.append((kind, nbytes, tuple(members), itemsize))

    def _wire(self, name: str, tensors: list[torch.Tensor], *args,
              **kw) -> None:
        """The one seam to the transport: dist.<name>(*args, **kw), or, on
        the counting transport, nothing (each of the call's `tensors` must
        be on `meta`)."""
        if self.backend != "meta":
            getattr(dist, name)(*args, **kw)
            return
        for t in tensors:
            if t.device.type != "meta":
                raise ValueError(f"the counting transport moves no data: "
                                 f"{name} on a {t.device.type} tensor")

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the "model" axis, IN PLACE (the reference's
        psum); every rank then holds the same bits."""
        return self._all_reduce(x, ("model",), "all_reduce_sum",
                                dist.ReduceOp.SUM)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """x's elementwise max over the "model" axis, in place (pmax)."""
        return self._all_reduce(x, ("model",), "all_reduce_max",
                                dist.ReduceOp.MAX)

    def _all_reduce(self, x, axes, kind, op) -> torch.Tensor:
        members = self.axis_ranks(axes)
        if len(members) == 1:
            return x
        self._count(kind, x.numel() * x.element_size(), members,
                    x.element_size())
        self._wire("all_reduce", [x], x, op=op, group=self._group(axes))
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The "model" axis' x concatenated along `dim` in rank order (the
        gather GSPMD inserts to make a cut tensor whole)."""
        return self.gather_axes(x, dim, ("model",))

    def axis_ranks(self, axes) -> list[int]:
        """The global ranks that differ from this one only on `axes` (a
        tuple of mesh axis names), in row-major order: the members of the
        collective over those axes, a cut dim's blocks in order."""
        rows = range(self.data_world) if "data" in axes else [self.data_rank]
        cols = range(self.world) if "model" in axes else [self.rank]
        return [d * self.world + m for d in rows for m in cols]

    def _group(self, axes):
        if "data" in axes and "model" in axes:
            return None
        return self.data_group if "data" in axes else self.model_group

    def all_reduce_axes(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x summed IN PLACE over the ranks along `axes`."""
        if axes == ("model",):
            return self.all_reduce_sum(x)
        return self._all_reduce(x, axes, "all_reduce_sum", dist.ReduceOp.SUM)

    def gather_axes(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """The blocks of x that the ranks along `axes` hold, concatenated
        along `dim` in their order (`axis_ranks`): a fresh contiguous
        tensor; over one rank, x itself."""
        members = self.axis_ranks(axes)
        if len(members) == 1:
            return x
        x = x.contiguous()
        self._count("all_gather", x.numel() * x.element_size(), members,
                    x.element_size())
        parts = [torch.empty_like(x) for _ in members]
        self._wire("all_gather", [x], parts, x, group=self._group(axes))
        return torch.cat(parts, dim=dim)

    def reduce_scatter_axes(self, g: torch.Tensor, dim: int,
                            axes) -> torch.Tensor:
        """The inverse of `gather_axes` for a gradient: this rank's block
        along `dim` (of the len(axis_ranks(axes)) blocks g is cut into) of
        g summed over the "data" ranks. The ranks along "model" of one data
        row hold the same rows of the batch, so g is the same on each of
        them: their blocks are not summed, each takes its own (ZeRO-3's
        cut over ("data", "model")). The data ranks sum the blocks the
        members of this rank's column hold: one reduce-scatter over the
        column."""
        members = self.axis_ranks(axes)
        n = g.shape[dim] // len(members)
        column = self.axis_ranks(("data",))
        col = [members.index(r) for r in column]
        if len(col) == 1:
            return g.narrow(dim, members.index(self.global_rank) * n, n)
        blocks = [g.narrow(dim, i * n, n).contiguous() for i in col]
        self._count("reduce_scatter", sum(b.numel() * b.element_size()
                                          for b in blocks), column,
                    g.element_size())
        out = torch.empty_like(blocks[0])
        self._wire("reduce_scatter", [g], out, blocks, op=dist.ReduceOp.SUM,
                   group=self.data_group)
        return out

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        if self.log is not None:
            self.log.clear()


def tp_dims(cfg) -> dict[str, int]:
    """The dims the "tp" layout cuts over the ranks for cfg's family, by
    name: RWKV-6's heads (d_model / rwkv_head_dim) and channel-mix ffn;
    the dense and moe families' `qout`, wq's H·hd columns (the reference's
    cut, which may split a head between two ranks: `q_heads`); the hybrid
    and encdec families' attention heads and kv heads; the dense MLP's ffn
    (a zamba2 shared block's, an encdec model's encoder and decoder);
    Mamba2's heads; the experts. A rank of the dense and moe families holds
    whole the kv heads its query heads read (`kv_heads`), where the ranks
    divide them or not."""
    if cfg.arch_type == "ssm":
        return {"heads": cfg.d_model // cfg.rwkv_head_dim, "ffn": cfg.d_ff}
    if cfg.arch_type in ("dense", "moe"):
        dims = {"qout": cfg.n_heads * cfg.hd}
    else:
        dims = {"heads": cfg.n_heads, "kv heads": cfg.n_kv_heads}
    if cfg.arch_type == "hybrid":
        dims["ssm heads"] = cfg.ssm_heads
    if cfg.arch_type != "moe" or cfg.dense_residual:
        dims["ffn"] = cfg.d_ff
    if cfg.arch_type == "moe":
        dims["experts"] = cfg.n_experts
    return dims


def check_tp(cfg, world: int) -> None:
    """Raise ValueError unless `world` ranks can run cfg under the "tp"
    layout as the port executes it: `world` divides every dim of
    `tp_dims(cfg)`. The vocabulary need not divide: the reference's rules
    keep an undivided dim whole, and so does the port (every rank then
    looks its tokens up and computes the whole logits). Nor need the
    query or kv heads of the dense and moe families: the reference's rules
    cut wq's columns (and wo's rows) into world equal blocks wherever
    world divides H·hd, and a rank attends the heads its block touches
    whole (`q_heads`, `layers.attention`); where the ranks do not divide
    the kv heads, the rules cut wk / wv and the cache within a head
    (`sharding.py` spec_from_axes, cache_shardings), which would need the
    scores summed across the ranks before the softmax, so each rank holds
    instead whole the kv heads its query heads read (`kv_heads`), and a kv
    head sits on several ranks (one kv head on every rank, for MQA). The
    sequence-sharded variants run every family (the ssm family, with no
    attention to cut, as "auto")."""
    if cfg.arch_type not in TP_ARCH_TYPES:
        raise ValueError(f"{cfg.name}: the \"tp\" layout runs the "
                         f"{TP_ARCH_TYPES} families, not {cfg.arch_type!r}")
    if cfg.attn_shard not in ATTN_SHARDS:
        raise ValueError(f"{cfg.name}: attn_shard {cfg.attn_shard!r}, "
                         f"expected one of {ATTN_SHARDS}")
    bad = {k: v for k, v in tp_dims(cfg).items() if v % world}
    if bad:
        raise ValueError(f"{cfg.name}: the \"tp\" layout over {world} ranks "
                         f"needs {world} to divide its {bad}")


@functools.lru_cache(maxsize=None)
def q_heads(h: int, world: int, rank: int) -> range:
    """The query heads that `rank` of `world` touches of an attention of h
    heads: its block of wq's h·hd columns (the reference's cut of `qout`;
    world divides h·hd) spans heads rank·h/world .. (rank + 1)·h/world, a
    head at either end partly (yi-34b's 56 heads over 16 ranks: 3.5 a
    rank, 4 touched). Where world divides h, its h / world heads whole."""
    return range(rank * h // world, -(-(rank + 1) * h // world))


def q_split(cfg, mp) -> bool:
    """Whether mp's ranks split cfg's query heads (world does not divide
    H): a rank's wq columns are then not whole heads, and its attention
    gathers q whole (`layers.attention`)."""
    return mp is not None and cfg.n_heads % mp.world != 0


@functools.lru_cache(maxsize=None)
def _kv_runs(h: int, hkv: int, world: int, rank: int) -> tuple:
    """((kv head, query heads), ...): the runs of `q_heads` that read the
    same kv head of a GQA attention of h query heads and hkv kv heads, in
    order."""
    group, runs = h // hkv, []
    for j in q_heads(h, world, rank):
        if runs and runs[-1][0] == j // group:
            runs[-1][1] += 1
        else:
            runs.append([j // group, 1])
    return tuple(map(tuple, runs))


@functools.lru_cache(maxsize=None)
def kv_rep(h: int, hkv: int, world: int) -> int:
    """How many of a rank's touched query heads read each kv head it holds
    (the same on every rank): the gcd of every rank's runs (`_kv_runs`);
    gcd(h / hkv, h / world) where world divides h."""
    return math.gcd(*(n for r in range(world)
                      for _, n in _kv_runs(h, hkv, world, r)))


def kv_heads(h: int, hkv: int, world: int, rank: int) -> list[int]:
    """The kv heads that `rank` of `world` holds of a GQA attention of h
    query heads and hkv kv heads (world divides h·hd), in the order it
    holds them. Its touched query heads (`q_heads`) fall into runs of rep
    = `kv_rep` heads, each run inside one kv head's group of h / hkv; it
    holds one kv head per run, so its touched query head j reads its local
    kv head j // rep, the reference's GQA on the rank's shapes (K8 takes
    one rep a launch). Where world divides hkv that is its block of hkv /
    world kv heads (the reference's cut); where hkv divides world, the one
    kv head its query heads read, which world / hkv ranks hold (every rank
    for MQA); otherwise a rank may hold a kv head twice (24 query / 2 kv
    heads over 3 ranks: [0, 0], [0, 1], [1, 1]), and where the ranks'
    touched heads straddle the groups unevenly, ranks may hold different
    counts (`kv_slots`)."""
    rep = kv_rep(h, hkv, world)
    return [kv for kv, n in _kv_runs(h, hkv, world, rank)
            for _ in range(n // rep)]


def kv_slots(h: int, hkv: int, world: int) -> int:
    """The most kv heads a rank holds (`kv_heads`): each rank's share of a
    gather of K / V, a rank that holds fewer padding its own."""
    return max(len(kv_heads(h, hkv, world, r)) for r in range(world))


def kv_gather_index(h: int, hkv: int, world: int) -> list[int] | None:
    """Where each kv head first stands among the ranks' `kv_heads` laid
    side by side in rank order, each rank's padded to `kv_slots`: the
    index that takes K / V gathered from every rank to the model's hkv kv
    heads, each once, in order. None where world divides hkv (the gather
    is that already)."""
    if hkv % world == 0:
        return None
    n = kv_slots(h, hkv, world)
    held = []
    for r in range(world):
        mine = kv_heads(h, hkv, world, r)
        held += mine + [-1] * (n - len(mine))
    return [held.index(j) for j in range(hkv)]


class _SumForward(torch.autograd.Function):
    """x summed over the ranks along `axes`; the gradient passes through
    (each rank's x is its own part of the sum)."""

    @staticmethod
    def forward(ctx, x, mp, axes):
        return mp.all_reduce_axes(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    """x as it is; the gradient summed over the ranks along `axes` (x is
    the same on each, and each computes its own part of what follows).
    With `piece` (start, length) along the last dim, only that part of x
    is the same on each rank, and only its gradient is summed."""

    @staticmethod
    def forward(ctx, x, mp, axes, piece):
        ctx.mp, ctx.axes, ctx.piece = mp, axes, piece
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        if ctx.piece is None:
            return ctx.mp.all_reduce_axes(g, ctx.axes), None, None, None
        part = g.narrow(-1, *ctx.piece)
        part.copy_(ctx.mp.all_reduce_axes(part.contiguous(), ctx.axes))
        return g, None, None, None


class _GatherLast(torch.autograd.Function):
    """The "model" ranks' x concatenated along the last dim; the gradient
    is this rank's block of it."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp, ctx.n = mp, x.shape[-1]
        return mp.all_gather(x, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.mp.rank * ctx.n, ctx.n), None


class _GatherForUse(torch.autograd.Function):
    """A leaf's shard gathered whole along `dim` over `axes`; the gradient
    reduce-scattered back to the shard (`ModelParallel
    .reduce_scatter_axes`). Saves nothing."""

    @staticmethod
    def forward(ctx, shard, mp, dim, axes):
        ctx.mp, ctx.dim, ctx.axes = mp, dim, axes
        return mp.gather_axes(shard, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mp.reduce_scatter_axes(g, ctx.dim, ctx.axes), None, None,
                None)


def sum_over(mp: ModelParallel, x: torch.Tensor, axes) -> torch.Tensor:
    """x summed over the ranks along `axes`, the gradient passed through
    (`_SumForward`); in place, as `all_reduce_axes`, where x carries no
    gradient."""
    if x.requires_grad:
        return _SumForward.apply(x, mp, axes)
    return mp.all_reduce_axes(x, axes)


def reduce_partial(mp: ModelParallel | None,
                   y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum on this rank, summed over the
    "model" ranks (y itself without model parallelism; `sum_over`)."""
    return y if mp is None else sum_over(mp, y, ("model",))


def enter_partial(mp: ModelParallel | None, x: torch.Tensor,
                  piece: tuple[int, int] | None = None) -> torch.Tensor:
    """x, the same on every "model" rank, as it enters a block whose ranks
    each compute their part (a column-parallel projection, the rank's
    experts, a whole leaf taken at the rank's heads): x itself, its
    gradient summed over the "model" ranks in the backward. With `piece`
    (start, length), only that part of x's last dim is the same on every
    rank (a Mamba2 mixer's B / C columns beside the rank's own) and only
    its gradient is summed. x itself without model parallelism or
    gradient."""
    if mp is None or mp.world == 1 or not x.requires_grad:
        return x
    return _SumBackward.apply(x, mp, ("model",), piece)


def reduce_shared(mp: ModelParallel, x: torch.Tensor) -> torch.Tensor:
    """x, a rank's partial sum, summed over the "model" ranks (in place
    where x carries no gradient), where each rank then uses only its own
    part of the sum (its channels): the gradient of x is the sum of the
    ranks' gradients of the sum. `reduce_partial` then `enter_partial`."""
    return enter_partial(mp, reduce_partial(mp, x))


def gather_last(mp: ModelParallel, x: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks of x's last dim (the vocabulary's logits, RWKV-6's
    channels) gathered in rank order; the gradient is the rank's block."""
    return _GatherLast.apply(x, mp)


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
    and the same combine runs over it with no collective.

    Differentiable as the reference's: the max carries no gradient (its
    `stop_gradient` around the pmax; the scale exp(m - M) is a constant of
    the backward), and where l or acc carries one (a training forward)
    the two sums are `reduce_shared`'s, each rank using only its own
    columns of the output: the cotangent of each sum, summed over the
    ranks, reaches every rank's l and acc, acc's crossing in `wire` as the
    transpose of the reference's bfloat16 psum does."""
    m = m.detach()
    big = m.amax(0) if mp is None else mp.all_reduce_max(m.clone())
    scale = torch.where(torch.isfinite(m), torch.exp(m - big), 0.0)
    l = l * scale
    acc = acc * scale[..., None]
    if mp is None:
        l, acc = l.sum(0), acc.to(wire).sum(0).float()
    elif l.requires_grad or acc.requires_grad:
        l = reduce_shared(mp, l)
        acc = reduce_shared(mp, acc.to(wire)).float()
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


def _flat(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes or ())


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
        for a in _flat(axes):
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"a dim of {dim} cannot be cut {n} ways "
                             f"(layout {spec})")
        out.append((idx * (dim // n), dim // n))
    return out


def mamba_pieces(di: int, n: int, nh: int, world: int,
                 rank: int) -> dict[str, list[tuple[int, int]]]:
    """The (start, length) pieces of a Mamba2 mixer's fused channel dims
    that `rank` of `world` holds, in the order it holds them (its heads
    are nh / world of nh, each d_inner / nh channels wide):
      "in_proj": of the columns [z (di) | x (di) | B (n) | C (n) | dt
                 (nh)], the z and x columns of its heads, B and C whole,
                 the dt columns of its heads;
      "conv":    of the conv channels [x (di) | B (n) | C (n)] (conv_w,
                 conv_b and the conv state), the x channels of its heads,
                 B and C whole.
    The reference cuts those dims into world equal blocks, which split
    the z / x / B / C / dt groups where they fall; no rank can compute on
    such a block alone."""
    dl, hl = di // world, nh // world
    return {"in_proj": [(rank * dl, dl), (di + rank * dl, dl), (2 * di, 2 * n),
                        (2 * di + 2 * n + rank * hl, hl)],
            "conv": [(rank * dl, dl), (di, 2 * n)]}


_MAMBA_FUSED = {"in_proj": "in_proj", "conv_w": "conv", "conv_b": "conv"}
_ATTN = {"wq", "wk", "wv", "wo"}


def _cuts_last(spec) -> bool:
    """Whether the layout `spec` cuts its last dim over "model"."""
    return "model" in _flat(spec[-1])


def rank_pieces(templates, layout, mesh, rank: int) -> dict:
    """What `rank` holds of every leaf of a parameter template tree under
    `layout` (`launch.sharding.param_layouts` on mesh): per leaf, per dim,
    the list of (start, length) pieces it holds along that dim, in order.
    A leaf the design holds as the reference lays it out has one piece a
    dim, its block (`local_slices`; a dim cut over "data" too, as
    "fsdp" / "zero3" cut `embed`). The exceptions, on the last dim, when
    the "model" axis has more than one rank and the layout cuts that dim
    over it ("tp", "fsdp"; "zero3" keeps it whole and computes whole on
    every rank): a Mamba2 mixer's in_proj, conv_w and conv_b (a template
    dict holding in_proj, conv_w, conv_b, out_proj and D; in_proj's
    layout decides for the three), whose last dim holds `mamba_pieces`;
    an attention's wk and wv (a template dict holding wq, wk, wv and wo,
    wk's `head_dim` set) where the ranks do not divide the kv heads,
    whose last dim holds the columns of the rank's `kv_heads`, one piece
    a head (k_norm stays whole).
    `models.base.shard_params`, `gather_params` and `materialize_shard`
    read this."""
    if not isinstance(templates, dict):
        return [[blk] for blk in local_slices(templates.shape, layout, mesh,
                                              rank)]
    out = {k: rank_pieces(templates[k], layout[k], mesh, rank)
           for k in templates}
    coord, world = rank_coords(mesh, rank)["model"], mesh.shape["model"]
    if world <= 1:
        return out
    if ({"in_proj", "out_proj", "D", *_MAMBA_FUSED} <= set(templates)
            and _cuts_last(layout["in_proj"])):
        di = templates["out_proj"].shape[-2]
        n = (templates["conv_w"].shape[-1] - di) // 2
        pieces = mamba_pieces(di, n, templates["D"].shape[-1], world, coord)
        for k, group in _MAMBA_FUSED.items():
            out[k] = out[k][:-1] + [pieces[group]]
    if (_ATTN <= set(templates) and templates["wk"].head_dim
            and _cuts_last(layout["wk"])):
        hd = templates["wk"].head_dim
        h, hkv = (templates[k].shape[-1] // hd for k in ("wq", "wk"))
        if hkv % world:
            cols = [(j * hd, hd) for j in kv_heads(h, hkv, world, coord)]
            for k in ("wk", "wv"):
                out[k] = out[k][:-1] + [cols]
    return out


def take_pieces(a: torch.Tensor, pieces: list) -> torch.Tensor:
    """The part of `a` that `pieces` (per dim, a list of (start, length))
    names: each dim narrowed to its pieces, several pieces concatenated in
    order. A dim held whole is left as it is, so a leaf held whole is `a`
    itself; a part of one piece a dim is a view."""
    out = a
    for dim, held in enumerate(pieces):
        if held == [(0, a.shape[dim])]:
            continue
        out = (out.narrow(dim, *held[0]) if len(held) == 1 else
               torch.cat([out.narrow(dim, s, m) for s, m in held], dim))
    return out


# ---------------------------------------------------------------------------
# Training over a ("data", "model") mesh
# ---------------------------------------------------------------------------

# the layouts `zoo.train_step` trains under (launch/sharding.py's rule
# sets), and the families each trains: "tp" and "zero3" every family,
# "fsdp" the dense and moe families (the others': ROADMAP item 29)
TRAIN_MODES = ("tp", "fsdp", "zero3")
TRAIN_ARCH_TYPES = {"tp": TP_ARCH_TYPES, "fsdp": ("dense", "moe"),
                    "zero3": TP_ARCH_TYPES}
# the layouts the engine serves under (`serving.engine.prefill` /
# `decode_step`), every family: the reference's dry run serves under "tp"
# and, with its "zero3" variant, under "zero3"
SERVE_MODES = ("tp", "zero3")
# the attn_shard each layout trains: the reference's "shmap" variant (its
# shard_map attention and MoE) under "tp" and "fsdp" for the dense and moe
# families, as its pod dry run combines them; never with "zero3"
TRAIN_ATTN_SHARDS = {"tp": ("auto", "shmap"), "fsdp": ("auto", "shmap"),
                     "zero3": ("auto",)}
SHMAP_TRAIN_ARCH_TYPES = ("dense", "moe")


def check_train(cfg, mesh, mode: str) -> None:
    """Raise ValueError unless cfg trains over the ("data", "model") mesh
    `mesh` under `mode`: a layout of TRAIN_MODES that trains cfg's family
    (`TRAIN_ARCH_TYPES`: "tp" and "zero3" every family; "fsdp" the dense
    and moe families, the ssm, hybrid and encdec families' being ROADMAP
    item 29), an attn_shard the layout trains (`TRAIN_ATTN_SHARDS`: "auto", or
    "shmap" under "tp" / "fsdp" for the dense and moe families), and a
    "model" axis that `check_tp` lets serve."""
    if mode not in TRAIN_MODES:
        raise ValueError(f"{cfg.name}: layout {mode!r}, expected one of "
                         f"{TRAIN_MODES}")
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"{cfg.name}: training runs on a (\"data\", "
                         f"\"model\") mesh, not {tuple(mesh.axis_names)}")
    if cfg.arch_type not in TRAIN_ARCH_TYPES[mode]:
        raise ValueError(f"{cfg.name}: training over ranks under {mode!r} "
                         f"runs the {TRAIN_ARCH_TYPES[mode]} families, not "
                         f"{cfg.arch_type!r} (ROADMAP item 29)")
    if cfg.attn_shard not in TRAIN_ATTN_SHARDS[mode] or (
            cfg.attn_shard != "auto"
            and cfg.arch_type not in SHMAP_TRAIN_ARCH_TYPES):
        raise ValueError(f"{cfg.name}: training over ranks under {mode!r} "
                         f"runs attn_shard {TRAIN_ATTN_SHARDS[mode]} (\"shmap"
                         f"\" for the {SHMAP_TRAIN_ARCH_TYPES} families), "
                         f"not {cfg.attn_shard!r}")
    check_tp(cfg, mesh.shape["model"])


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """The layout a training step runs under: `mode` ("tp", "fsdp" or
    "zero3") and `specs`, its layout tree on the run's mesh
    (`launch.sharding.param_layouts(templates, mesh, mode)`); a serving
    step takes one too (`SERVE_MODES`)."""

    mode: str
    specs: dict


def _spec_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_specs(specs: dict) -> dict:
    """The layouts of one layer's views of stacked leaves: the stacked
    layouts without their leading "layers" entry."""
    return _spec_map(lambda s: s[1:], specs)


def data_cut(spec) -> tuple[int, tuple[str, ...]] | None:
    """(dim, its axes) of the dim a layout cuts over "data" (fsdp's
    `embed` over ("data",), zero3's over ("data", "model")), or None."""
    for dim, axes in enumerate(spec):
        if "data" in _flat(axes):
            return dim, _flat(axes)
    return None


def gather_for_use(mp: ModelParallel, shard: torch.Tensor,
                   spec) -> torch.Tensor:
    """A leaf (or a layer's view of a stacked one) whole along the dim its
    layout `spec` cuts over "data", gathered from the ranks along its
    axes; its gradient is reduce-scattered back to the shard. Inside
    `regather_saved` the gathered weight is registered, so that an op that
    saves it for the backward saves the shard instead. A leaf not cut over
    "data" is the shard itself."""
    cut = data_cut(spec)
    if cut is None or len(mp.axis_ranks(cut[1])) == 1:
        return shard
    full = _GatherForUse.apply(shard, mp, *cut)
    if mp.regather is not None:
        mp.regather[_storage_key(full)] = (weakref.ref(full), shard.detach(),
                                           *cut)
    return full


def gather_tree(mp: ModelParallel, tree, specs):
    """`gather_for_use` over a (sub)tree of leaves and their layouts."""
    if isinstance(tree, dict):
        return {k: gather_tree(mp, v, specs[k]) for k, v in tree.items()}
    return gather_for_use(mp, tree, specs)


def _narrow_tree(tree, pieces):
    """`take_pieces` over a (sub)tree of leaves (its own keys: a subtree
    may leave leaves of `pieces` out)."""
    if isinstance(tree, dict):
        return {k: _narrow_tree(v, pieces[k]) for k, v in tree.items()}
    return take_pieces(tree, pieces)


def layout_use(mp: ModelParallel, specs: dict, stack: str = "blocks",
               pieces: dict | None = None):
    """use(p, key): what the layer code reads of p[key] (a sublayer of one
    layer of the stacked subtree `stack`, "blocks" or "enc_blocks", or a
    top-level leaf or subtree: the names are looked up among the top
    level's layouts and one layer's, and no name is in both) under the
    layout tree `specs`: its leaves cut over "data" gathered where used
    (`gather_tree`) and, with `pieces` (`serve_pieces`, a tree like
    specs), each then narrowed to its pieces."""
    s = {**specs, **layer_specs(specs[stack])}
    q = None if pieces is None else {**pieces, **layer_specs(pieces[stack])}

    def use(p, key):
        w = gather_tree(mp, p[key], s[key])
        return w if q is None else _narrow_tree(w, q[key])

    return use


def gathered_lookup(mp: ModelParallel, shard: torch.Tensor,
                    tokens: torch.Tensor, spec) -> torch.Tensor:
    """The embedding rows of `tokens` (this rank's rows of the batch) from
    a table (V, d) whose layout `spec` cuts d over "data" (zero3's) and of
    which the rank holds `shard` (V, its block of d): the data ranks'
    tokens gathered, each rank looks its block of d up for all of them and
    the blocks are gathered along d, so no rank gathers the table; the
    rank keeps its own rows, the table's bits. The tokens cross as
    int32."""
    _, axes = data_cut(spec)
    every = mp.gather_axes(tokens.to(torch.int32), 0, ("data",))
    rows = mp.gather_axes(shard[every], -1, axes)
    b = tokens.shape[0]
    return rows.narrow(0, mp.data_rank * b, b)


def gathered_logits(mp: ModelParallel, x: torch.Tensor, shard: torch.Tensor,
                    spec, tied: bool = False) -> torch.Tensor:
    """x (this rank's rows, (B, S, d)) through a head (d, V), or a tied
    embedding (V, d) transposed, whose layout `spec` cuts d over "data"
    (zero3's), of which the rank holds `shard`: the data ranks' x
    gathered, each rank's block of d times its shard in float32, the
    partial logits summed over the ranks that cut d; the rank keeps its
    own rows, in x's dtype. No rank gathers the head."""
    _, axes = data_cut(spec)
    w = shard.T if tied else shard
    every = mp.gather_axes(x, 0, ("data",))
    n = w.shape[0]
    at = mp.axis_ranks(axes).index(mp.global_rank) * n
    part = every.narrow(-1, at, n).float() @ w.float()
    logits = mp.all_reduce_axes(part, axes)
    b = x.shape[0]
    return logits.narrow(0, mp.data_rank * b, b).to(x.dtype)


def serve_pieces(templates, specs, tp_specs, mesh, rank: int):
    """What a rank serving under the layout tree `specs` ("zero3") narrows
    each leaf to, once gathered whole over "data" (`layout_use`), to run
    the "tp" layer code: per dim, its "tp" pieces (`rank_pieces` under
    tp_specs, "tp"'s layout tree) where `specs` keeps the dim whole or
    cuts it over "data" (which "tp" keeps whole: the gather makes it
    whole), and all of what it holds where `specs` cuts the dim over
    "model" alone (the experts, which both layouts cut alike). ValueError
    where the two layouts cut one dim otherwise. (Every rank along the
    gather's axes takes other "tp" pieces: the gather moves whole
    leaves.)"""
    def walk(tmpl, spec, tp, held):
        if isinstance(spec, dict):
            return {k: walk(tmpl[k], spec[k], tp[k], held[k]) for k in spec}
        out = []
        for dim, axes in enumerate(spec):
            axes = _flat(axes)
            if "data" in axes and tp[dim] != [(0, tmpl.shape[dim])]:
                raise ValueError(f"a dim cut over {axes} that \"tp\" "
                                 f"cuts to {tp[dim]}")
            if axes and "data" not in axes:
                if tp[dim] != held[dim]:
                    raise ValueError(f"a dim cut to {held[dim]} over "
                                     f"{axes} that \"tp\" cuts to "
                                     f"{tp[dim]}")
                out.append([(0, sum(m for _, m in held[dim]))])
            else:
                out.append(tp[dim])
        return out

    return walk(templates, specs,
                rank_pieces(templates, tp_specs, mesh, rank),
                rank_pieces(templates, specs, mesh, rank))


def _storage_key(t: torch.Tensor) -> int:
    """The identity of t's storage: the same for every view of it, unique
    among the storages alive at once, on every device (a `meta` storage
    has no data pointer: every one reads 0)."""
    return t.untyped_storage()._cdata


@contextlib.contextmanager
def regather_saved(mp: ModelParallel):
    """Within: a tensor an op saves for its backward that is (a view of) a
    weight `gather_for_use` gathered is saved as the shard, and gathered
    again (no gradient) when the backward reads it, so no gathered weight
    lives from its forward to its backward. The weight is known by its
    storage while it is alive (a weak reference: a storage freed and reused
    is not taken for it). Inside a block under remat (`zoo._remat`) the
    checkpoint's own hooks, the innermost, save nothing of the block: its
    recompute gathers its weights again; these hooks keep the leaves
    outside the blocks (the embedding, the head)."""
    reg: dict = {}

    def pack(t: torch.Tensor):
        entry = reg.get(_storage_key(t))
        if entry is None or entry[0]() is None:
            return t
        return entry[1:], tuple(t.shape), t.stride(), t.storage_offset()

    def unpack(saved):
        if isinstance(saved, torch.Tensor):
            return saved
        (shard, dim, axes), size, stride, offset = saved
        with torch.no_grad():
            full = mp.gather_axes(shard, dim, axes)
        return full.as_strided(size, stride, offset)

    mp.regather = reg
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        mp.regather = None


def reduce_replicated_grads(mp: ModelParallel, grads: list, specs: list
                            ) -> list:
    """The gradients of a step's leaves (in tree order, with their
    layouts), each leaf the layout does not cut over "data" (the norms;
    zero3's experts) summed over the "data" ranks: every rank's rows of
    the batch give it a part. One all-reduce of them packed; the others
    (reduce-scattered by `gather_for_use`) as they are."""
    if mp.data_world == 1:
        return grads
    idx = [i for i, s in enumerate(specs) if data_cut(s) is None]
    if not idx:
        return grads
    flat = mp.all_reduce_axes(torch.cat([grads[i].reshape(-1)
                                         for i in idx]), ("data",))
    out, at = list(grads), 0
    for i in idx:
        n = grads[i].numel()
        out[i] = flat[at:at + n].view(grads[i].shape).to(grads[i].dtype)
        at += n
    return out


def sum_held_kv(mp: ModelParallel, cfg, *grads: torch.Tensor
                ) -> list[torch.Tensor]:
    """The gradients of a rank's kv-head columns (each (..., n·hd), the
    columns of its `kv_heads`, as `rank_pieces` gives wk and wv where the
    ranks do not divide the kv heads), each summed over the "model" ranks
    that hold the same kv head: each holder computed the part its own
    query heads (or, under "shmap", the first holder the whole) give, so
    the sum is the unsharded gradient and the holders keep equal bits.
    Every rank scatters its held columns into the model's hkv kv heads;
    one all-reduce of them packed; each rank takes its own back."""
    hkv, hd = cfg.n_kv_heads, cfg.hd
    held = kv_heads(cfg.n_heads, hkv, mp.world, mp.rank)
    full = []
    for g in grads:
        whole = g.new_zeros(g.shape[:-1] + (hkv * hd,))
        for i, j in enumerate(held):
            whole[..., j * hd:(j + 1) * hd] += g[..., i * hd:(i + 1) * hd]
        full.append(whole)
    flat = mp.all_reduce_sum(torch.cat([t.reshape(-1) for t in full]))
    return [torch.cat([whole[..., j * hd:(j + 1) * hd] for j in held],
                      dim=-1)
            for whole in flat.view(len(full), *full[0].shape)]
