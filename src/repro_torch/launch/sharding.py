"""Logical-axis -> mesh-axis rules and the per-dim layout of every tensor
(the reference's src/repro/launch/sharding.py).

Parameters carry logical axis names (models/base.ParamTemplate); these
rules translate them into layouts on a mesh. A layout (the reference's
PartitionSpec) is a tuple with one entry per dim: None (replicated), a
mesh axis name, or a tuple of names (the dim cut over their product).

Three rule sets, as in the reference:
  "tp"    — Megatron-style tensor parallel: heads / ffn / vocab / experts
            over `model`; everything else replicated. The serving default,
            and the one the port executes (`models.parallel`).
  "fsdp"  — tp + parameters also cut over the data axes on the `embed`
            dim (weight-gathered FSDP).
  "zero3" — parameters cut over ALL mesh axes on the embed dim, no tensor
            parallelism; experts stay expert-parallel.

A mesh here is anything with `.axis_names` and a `.shape` mapping of axis
name to size (`launch.mesh.MeshShape`); nothing in this module touches a
device or a process group.
"""

from __future__ import annotations

import math
from typing import Callable

TP_RULES = {
    "qout": "model",
    "kvout": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "embed": None,
    "layers": None,
}

# serving-cache entries laid out as (..., B, S, Hkv, hd)
KV_ENTRIES = ("k", "v", "gk", "gv", "lk", "lv", "tlk", "tlv", "cross_k",
              "cross_v", "attn_k", "attn_v")


def _tree_map(fn: Callable, tree):
    """fn over the leaves of a nested dict (a template or spec tree)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes carrying batch parallelism (the reference's mesh.data_axes)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _batch_axes(mesh):
    """The data axes as one layout entry: a name, a tuple, or None."""
    d = data_axes(mesh)
    return d if len(d) > 1 else (d[0] if d else None)


def fsdp_rules(mesh) -> dict:
    r = dict(TP_RULES)
    r["embed"] = _batch_axes(mesh)
    return r


def zero3_rules(mesh) -> dict:
    """ZeRO-3: parameters cut over every mesh axis on the embed dim, no
    tensor parallelism; MoE experts stay expert-parallel."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    return {"qout": None, "kvout": None, "ff": None, "vocab": None,
            "experts": "model", "embed": axes, "layers": None}


def rules_for(mesh, mode: str) -> dict:
    if mode == "fsdp":
        return fsdp_rules(mesh)
    if mode == "zero3":
        return zero3_rules(mesh)
    return dict(TP_RULES)


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _fits(dim: int, axes, mesh) -> bool:
    """A dim is cut only when the axes' size divides it (else it stays
    replicated, as the reference's jit in_shardings require)."""
    return axes is None or dim % _axes_size(mesh, axes) == 0


def _flat(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes or ())


def spec_from_axes(axes: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    """A mesh axis appears at most once per layout: the first logical axis
    that claims it wins (MoE expert weights (experts, embed, ff) cut
    `experts` over model and leave `ff` replicated)."""
    out, used = [], set()
    for a, dim in zip(axes, shape):
        mesh_axes = rules.get(a) if a is not None else None
        flat = _flat(mesh_axes)
        if any(m in used for m in flat) or not _fits(dim, mesh_axes, mesh):
            out.append(None)
        else:
            out.append(mesh_axes)
            used.update(flat)
    return tuple(out)


def param_layouts(templates, mesh, mode: str = "tp") -> dict:
    """The layout tree matching the parameter tree (the reference's
    `param_shardings`)."""
    rules = rules_for(mesh, mode)
    return _tree_map(lambda t: spec_from_axes(t.axes, t.shape, rules, mesh),
                     templates)


# ---------------------------------------------------------------------------
# Data layouts: batch over (pod, data); caches batch-cut on their batch dim
# (after the stacked layer dims); the kv-head dim over model.
# ---------------------------------------------------------------------------

def _shape(spec) -> tuple[int, ...]:
    """A spec's shape: a (shape, dtype) pair (`configs.shapes`,
    `serving.engine.cache_shapes`) or a bare shape."""
    if len(spec) == 2 and isinstance(spec[0], tuple):
        return spec[0]
    return tuple(spec)


def batch_layouts(batch_specs: dict, mesh, *, batch_dim: int = 0) -> dict:
    """Tokens / targets / frontend: the batch dim over (pod, data) where
    their size divides it."""
    ba = _batch_axes(mesh)

    def one(s):
        shape = _shape(s)
        spec = [None] * len(shape)
        if shape[batch_dim] % _axes_size(mesh, ba) == 0:
            spec[batch_dim] = ba
        return tuple(spec)

    return {k: one(s) for k, s in batch_specs.items()}


def cache_layouts(cache_specs: dict, mesh, policy: str = "heads") -> dict:
    """Serving caches, by entry name (the reference's `cache_shardings`).

    KV-like entries (KV_ENTRIES), (..., B, S, Hkv, hd): the batch dim over
    the data axes when it divides and is > 1; policy "heads" puts Hkv over
    model, falling back to hd when the head count does not divide (the
    within-head split); policy "seq" puts the KV sequence over model where
    it divides (else as "heads"). SSM / RWKV states ("ssm", "wkv"): the
    head dim over model. Shift / conv states: the channel dim."""
    ba = _batch_axes(mesh)
    n_data = _axes_size(mesh, ba)
    n_model = mesh.shape["model"]

    def one(name, s):
        shape = _shape(s)
        spec = [None] * len(shape)
        if name in KV_ENTRIES:
            bdim = len(shape) - 4
            if shape[bdim] % n_data == 0 and shape[bdim] > 1:
                spec[bdim] = ba
            if policy == "seq" and shape[-3] % n_model == 0:
                spec[-3] = "model"
            elif shape[-2] % n_model == 0:
                spec[-2] = "model"
            elif shape[-1] % n_model == 0:
                spec[-1] = "model"
        elif name in ("ssm", "wkv"):
            if shape[1] % n_data == 0 and shape[1] > 1:
                spec[1] = ba
            if shape[2] % n_model == 0:
                spec[2] = "model"
        else:
            if shape[1] % n_data == 0 and shape[1] > 1:
                spec[1] = ba
            if shape[-1] % n_model == 0:
                spec[-1] = "model"
        return tuple(spec)

    return {k: one(k, s) for k, s in cache_specs.items()}


def replicated(mesh) -> tuple:
    """The layout of a tensor held whole on every rank of `mesh` (the
    reference's `PartitionSpec()`: no dim cut)."""
    return ()
