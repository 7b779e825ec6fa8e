"""Model-zoo configuration and the parameter-template system.

Every architecture is described by one frozen ModelConfig. Parameters are
declared as *templates* — (shape, logical axes, init) — from which
`materialize` makes real tensors. Layer parameters are STACKED on a
leading "layers" axis, as in the reference, so a parameter tree carries
over from it array by array (`zoo.params_from_numpy`); the forward passes
walk the layers in a Python loop over views of the stacks.

A parameter tree is a nested dict whose leaves are ParamTemplates or
tensors; `tree_leaves` visits the leaves in sorted-key order, the order
the reference's pytrees flatten in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch

from repro_torch.models.parallel import rank_pieces, take_pieces

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "encdec")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mlp_act: str = "swiglu"           # swiglu | gelu
    tie_embeddings: bool = False
    # local/global attention pattern (gemma3): window size + 1 global per N
    sliding_window: int = 0           # 0 = full attention everywhere
    global_every: int = 0             # e.g. 6 -> layers 5, 11, ... are global
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0                 # expert hidden size (d_ff if 0)
    dense_residual: bool = False      # arctic: dense MLP in parallel with MoE
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # RWKV6
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64
    # hybrid (zamba2): shared attention block applied every `attn_every` SSM
    # layers, weights shared across applications
    attn_every: int = 0
    # attention-activation partitioning policy of the reference's mesh
    # runs; the port reads none: its model-parallel runs take the plain
    # "tp" layout (models/parallel.py)
    attn_shard: str = "auto"
    # SSM sequence-mixing implementation: "scan" | "chunked"
    ssm_impl: str = "scan"
    # encoder-decoder (seamless)
    n_enc_layers: int = 0
    # modality frontend stub: inputs arrive as precomputed embeddings of this
    # many positions prepended to the text tokens (pixtral) or as the encoder
    # input (seamless). 0 = pure text.
    frontend_positions: int = 0
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def is_global_layer(self, i: int) -> bool:
        """gemma3-style 5:1 pattern: every `global_every`-th layer is global."""
        if not self.sliding_window or not self.global_every:
            return not self.sliding_window
        return (i + 1) % self.global_every == 0

    def param_count(self) -> int:
        """Total parameter count."""
        return sum(math.prod(t.shape) for t in tree_leaves(self.templates()))

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        total = 0
        for t in tree_leaves(self.templates()):
            n = math.prod(t.shape)
            if t.axes and "experts" in t.axes and self.n_experts:
                n = n * self.top_k // self.n_experts
            total += n
        return total

    def templates(self):
        from repro_torch.models import zoo
        return zoo.templates(self)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> Iterator:
    """The leaves of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves (and the matching leaves of `rest`, trees of the
    same keys), visited in sorted-key order (as tree_leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class ParamTemplate:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]      # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | small
    scale: float = 0.02
    # the width of one head along the last dim (attention's wk / wv), so
    # that `parallel.rank_pieces` can hold whole kv heads; 0 elsewhere
    head_dim: int = 0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"template shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


# Elements drawn per float32 temporary in `materialize`: a stacked leaf of a
# full-width model (e.g. 62 x 5376 x 21504) is filled in slices of about
# this size, so the float32 draw never needs the whole leaf at once.
_DRAW_CHUNK = 1 << 28


def _draw(t: ParamTemplate, generator: torch.Generator, dtype: torch.dtype,
          pieces: list) -> torch.Tensor:
    """The part `pieces` (per dim, a list of (start, length); see
    `parallel.rank_pieces`) of leaf t as `materialize` draws it: the leaf,
    viewed as (rows, the rest), is drawn in float32 slices of whole rows,
    each scaled and cut to the pieces before the cast; the generator
    advances over the whole leaf, so the next leaf's draw does not depend
    on the part. The row dim holds one piece."""
    device = generator.device
    shape = tuple(sum(m for _, m in held) for held in pieces)
    if t.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if t.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = t.shape[-1] if len(t.shape) > 1 else 1
    scale = t.scale if t.init == "normal" else t.scale / math.sqrt(fan_in)
    if len(t.shape) == 1:                  # one row of the whole leaf
        full, pieces = (1,) + t.shape, [[(0, 1)]] + pieces
    else:
        full = t.shape
    if len(pieces[0]) != 1:
        raise ValueError(f"a leaf of {t.shape} is drawn in whole rows: its "
                         f"first dim holds one piece, not {pieces[0]}")
    cols = math.prod(full[1:])
    out = torch.empty(tuple(sum(m for _, m in held) for held in pieces),
                      dtype=dtype, device=device)
    rows = max(1, _DRAW_CHUNK // max(cols, 1))
    r0, nr = pieces[0][0]
    for i in range(0, full[0], rows):
        n = min(rows, full[0] - i)
        draw = torch.randn((n, cols), generator=generator,
                           dtype=torch.float32, device=device)
        lo, hi = max(i, r0), min(i + n, r0 + nr)
        if lo >= hi:
            continue
        part = draw.mul_(scale)[lo - i:hi - i].view((hi - lo,) + full[1:])
        out[lo - r0:hi - r0].copy_(
            take_pieces(part, [[(0, hi - lo)]] + pieces[1:]))
    return out.view(shape)


def materialize(templates, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> dict:
    """Real parameters from a template tree, made on the generator's device
    by the reference's init rule (models/base.py `materialize`):
    normal -> scale * N(0, 1); small -> scale / sqrt(fan_in) * N(0, 1);
    zeros; ones. Each leaf is drawn in float32 and cast to `dtype`; leaves
    are drawn in sorted-key order, so a seed fixes the whole tree. The
    numbers differ from the reference's `jax.random` draw: tests carry the
    reference's tree over with `zoo.params_from_numpy` instead."""
    return tree_map(lambda t: _draw(t, generator, dtype,
                                    [[(0, n)] for n in t.shape]), templates)


def materialize_shard(templates, generator: torch.Generator,
                      dtype: torch.dtype, layout, mp) -> dict:
    """Rank mp's shard under `layout` (`launch.sharding.param_layouts` on
    mp.mesh) of what `materialize` makes from the same generator state,
    bit for bit, without holding any whole leaf: every rank draws the
    whole random stream and keeps its pieces (`parallel.rank_pieces`)."""
    return tree_map(lambda t, held: _draw(t, generator, dtype, held),
                    templates, rank_pieces(templates, layout, mp.mesh,
                                           mp.global_rank))


def shape_structs(templates, dtype: torch.dtype) -> dict:
    """The parameter tree as `meta` tensors of the templates' shapes in
    `dtype`: no storage is allocated (the reference's ShapeDtypeStruct
    tree for its dry runs). The cost report (`launch/dryrun.py`) traces a
    step on it."""
    return tree_map(
        lambda t: torch.empty(t.shape, dtype=dtype, device="meta"),
        templates)


def logical_specs(templates) -> dict:
    """Tree of logical-axis tuples, same structure as params."""
    return tree_map(lambda t: t.axes, templates)


def shard_params(params, templates, layout, mp) -> dict:
    """Rank mp's shard of the full parameter tree `params` (e.g. from
    `materialize` or `zoo.params_from_numpy`) under `layout`, a layout
    tree on mp.mesh (`launch.sharding.param_layouts`): each cut leaf is
    cut to the pieces this rank holds (`parallel.rank_pieces`: its block,
    a Mamba2 mixer's head-aligned pieces, or the columns of the kv heads
    its query heads read) and copied, so the full leaf can be freed; a
    whole leaf is the same tensor. Leaves are checked against the
    templates' shapes."""
    def one(a: torch.Tensor, t: ParamTemplate, held: list) -> torch.Tensor:
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"parameter of shape {tuple(a.shape)}, the "
                             f"template wants {t.shape}")
        out = take_pieces(a, held)
        if out is a:
            return a
        return out.clone() if out.untyped_storage().data_ptr() \
            == a.untyped_storage().data_ptr() else out

    return tree_map(one, params, templates,
                    rank_pieces(templates, layout, mp.mesh, mp.global_rank))


def gather_params(shards, templates, layout, mp) -> dict:
    """The inverse of `shard_params` on every rank of a model-parallel
    run: each cut dim of a leaf all-gathered from the ranks along the
    mesh axes its layout cuts it over (a rank's kv-head or Mamba2 pieces:
    along "model"; fsdp's `embed` along "data", zero3's along every axis),
    and every rank's pieces put back where `parallel.rank_pieces` takes
    them from (a piece held by several ranks, as a Mamba2 mixer's B / C
    columns on every rank or a kv head's wk / wv columns on each rank
    whose query heads read it, is the same bits on each, written once per
    holder); whole leaves as they are. Ranks holding pieces of unequal
    lengths along a dim pad theirs for the gather."""
    held = [rank_pieces(templates, layout, mp.mesh, r)
            for r in range(mp.mesh.size)]

    def one(a: torch.Tensor, t: ParamTemplate, spec, *ranks) -> torch.Tensor:
        out = a
        for dim, mine in enumerate(ranks[mp.global_rank]):
            if mine == [(0, t.shape[dim])]:
                continue
            axes = spec[dim] or "model"
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            members = mp.axis_ranks(axes)
            covered = torch.zeros(t.shape[dim], dtype=torch.bool)
            for rank in members:
                for s, m in ranks[rank][dim]:
                    covered[s:s + m] = True
            if not bool(covered.all()):
                raise ValueError(f"a dim of {t.shape[dim]} cut to "
                                 f"{[m for _, m in mine]} is not covered "
                                 f"by the {len(members)} ranks along "
                                 f"{axes}")
            # ranks may hold unequal lengths (kv heads their touched query
            # heads read, `parallel.kv_slots`): each gathers its own padded
            # to the longest
            n = max(sum(m for _, m in ranks[rank][dim]) for rank in members)
            mine_padded = out if n == out.shape[dim] else torch.cat(
                [out, out.new_zeros(out.shape[:dim] + (n - out.shape[dim],)
                                    + out.shape[dim + 1:])], dim)
            parts = mp.gather_axes(mine_padded, dim, axes).split(n, dim)
            whole = out.new_empty(out.shape[:dim] + (t.shape[dim],)
                                  + out.shape[dim + 1:])
            for part, rank in zip(parts, members):
                at = 0
                for s, m in ranks[rank][dim]:
                    whole.narrow(dim, s, m).copy_(part.narrow(dim, at, m))
                    at += m
            out = whole
        return out

    return tree_map(one, shards, templates, layout, *held)


def stack_templates(t: ParamTemplate, n: int) -> ParamTemplate:
    """Add a leading stacked-layers dim."""
    return dataclasses.replace(t, shape=(n,) + t.shape,
                               axes=("layers",) + t.axes)


def stack_tree(tree, n: int):
    return tree_map(lambda t: stack_templates(t, n), tree)


def unstack(tree, n: int) -> list[dict]:
    """The per-layer views of a stacked tree: element i is the tree of
    layer i (one `unbind` per leaf, no copies)."""
    leaves = {}

    def collect(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                collect(path + (k,), v)
        else:
            leaves[path] = node.unbind(0)

    collect((), tree)
    layers = []
    for i in range(n):
        layer: dict = {}
        for path, views in leaves.items():
            d = layer
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = views[i]
        layers.append(layer)
    return layers
