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
    # runs; the port runs on one card and reads only "auto"
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

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"template shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


# Elements drawn per float32 temporary in `materialize`: a stacked leaf of a
# full-width model (e.g. 62 x 5376 x 21504) is filled in slices of about
# this size, so the float32 draw never needs the whole leaf at once.
_DRAW_CHUNK = 1 << 28


def materialize(templates, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> dict:
    """Real parameters from a template tree, made on the generator's device
    by the reference's init rule (models/base.py `materialize`):
    normal -> scale * N(0, 1); small -> scale / sqrt(fan_in) * N(0, 1);
    zeros; ones. Each leaf is drawn in float32 and cast to `dtype`; leaves
    are drawn in sorted-key order, so a seed fixes the whole tree. The
    numbers differ from the reference's `jax.random` draw: tests carry the
    reference's tree over with `zoo.params_from_numpy` instead."""
    device = generator.device

    def one(t: ParamTemplate) -> torch.Tensor:
        if t.init == "zeros":
            return torch.zeros(t.shape, dtype=dtype, device=device)
        if t.init == "ones":
            return torch.ones(t.shape, dtype=dtype, device=device)
        fan_in = t.shape[-1] if len(t.shape) > 1 else 1
        scale = t.scale if t.init == "normal" else t.scale / math.sqrt(fan_in)
        out = torch.empty(t.shape, dtype=dtype, device=device)
        flat = out.view(t.shape[0], -1) if len(t.shape) > 1 else out.view(1, -1)
        rows = max(1, _DRAW_CHUNK // max(flat.shape[1], 1))
        for i in range(0, flat.shape[0], rows):
            part = flat[i:i + rows]
            draw = torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device)
            part.copy_(draw.mul_(scale))
        return out

    return tree_map(one, templates)


def shape_structs(templates, dtype: torch.dtype) -> dict:
    """The parameter tree as `meta` tensors of the templates' shapes in
    `dtype`: no storage is allocated (the reference's ShapeDtypeStruct
    tree for its dry runs). The cost report (`launch/dryrun.py`) traces a
    step on it."""
    return tree_map(
        lambda t: torch.empty(t.shape, dtype=dtype, device="meta"),
        templates)


def stack_templates(t: ParamTemplate, n: int) -> ParamTemplate:
    """Add a leading stacked-layers dim."""
    return ParamTemplate((n,) + t.shape, ("layers",) + t.axes, t.init, t.scale)


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
