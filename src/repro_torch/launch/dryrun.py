"""Dry-run cost report: trace every (architecture x input shape) step of
the port on `meta` tensors (no allocation) and price it at one H100's
peaks. The port of the reference's `launch/dryrun.py`, which lowers and
compiles each jitted step on a 256-chip TPU pod mesh instead.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--variant auto] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --pod [--multi-pod | --both-meshes] --all --variant auto

One step runs once (`rank_record`), through the port's own entry points
(`zoo.train_step` with Adam, `engine.prefill`, `engine.decode_step`), on
parameters, optimizer state, batch and cache made as `meta` tensors of
the step's shapes (`step_inputs`), under two counters:

  * `FlopCounterMode` counts the FLOPs of every matmul-like op (the
    reference's dot FLOPs of the compiled HLO); K8 (`ops.swa_decode`), the
    one kernel on a traced step, adds its own 4 B H n_valid hd;
  * `StepCounter` counts the bytes the step reads of the tensors that
    existed before it, again at each read (an op reading a weight, K8
    reading n_valid slots of K and V, a gather only the rows it takes),
    the bytes it writes in place into them (a cache) and the bytes of its
    outputs, and the peak of the storages it holds live.

One JSON per combo under dryrun_torch/ holds the reference's record: the
step's meta keys, `memory` (argument / output / peak temp bytes), `cost`
(flops, bytes accessed), `bytes_per_device` (the larger of bytes accessed
and `roofline.streaming_floor_bytes`), `roofline` (`roofline.terms`) and
`fits_one_card`. Nothing of it runs on the launchers' timed paths.

`--pod` is the reference's pod dry run: one rank's step on its 256- or
512-chip production mesh (`pod_record`), under its variant and shard
mode (`pod_variant`, `shard_mode`), on that rank's own `meta` inputs
(`step_inputs` with its ModelParallel) over a transport that counts
every collective and moves nothing (`ModelParallel.counting`); one rank
of each class of ranks with equal inputs is traced (`rank_classes`), and
the record adds the collectives (`roofline.collectives`) and their term.
Files are {arch}__{shape}__pod1|pod2[__variant].json. With several combos
the CLI traces them in a pool of spawned processes.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as CFG
from repro_torch.configs import shapes as SH
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.launch import sharding as SHD
from repro_torch.launch.mesh import MeshShape, production_mesh
from repro_torch.models import base as MB
from repro_torch.models import zoo as Z
from repro_torch.models.base import ModelConfig
from repro_torch.models.parallel import (SERVE_MODES, ModelParallel,
                                         TrainLayout, _kv_runs, check_train,
                                         local_slices, q_heads, rank_pieces)
from repro_torch.optim import adam
from repro_torch.serving import engine as E

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "dryrun_torch"
VARIANTS = ("baseline", "chunked", "auto")

_aten = torch.ops.aten
# ops that read only the rows they take of their first input
_GATHERS = {_aten.embedding.default, _aten.index.Tensor,
            _aten.index_select.default}
# ops that overwrite their first input without reading it
_OVERWRITES = {_aten.copy_.default, _aten.index_put_.default,
               _aten.fill_.Scalar, _aten.zero_.default}
# an op whose output shares its input's storage reads nothing
_ALIASES = {_aten._unsafe_view.default}


def recommended_variant(cfg: ModelConfig, shape_name: str) -> str:
    """The chunked form for the recurrent families at the full-sequence
    steps (its Python loop runs over chunks, the scan's over tokens), else
    the baseline. The reference's mesh variants (seqkv, shmap, zero3) have
    no meaning on one card."""
    step = SH.SHAPES[shape_name].step
    if cfg.arch_type in ("ssm", "hybrid") and step in ("train", "prefill"):
        return "chunked"
    return "baseline"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_id(t: torch.Tensor) -> int:
    """The address of t's storage: the same for every view of it, unique
    among storages alive at once (a `meta` tensor has no data pointer)."""
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """Bytes read of and written into the step's inputs, and the peak of
    the storages the step holds live.

    `inputs` are the tensors that exist before the step (parameters,
    optimizer state, batch, cache). A view reads nothing; any other op
    adds the bytes of each argument that is (a view of) an input, at each
    call: a gather the rows it takes, an in-place write into an input the
    bytes it writes (and, but for a pure overwrite, reads). Every storage
    an op makes is live from then until it is freed (a finalizer on the
    storage); `peak` is the most bytes live at once. A kernel on `meta`
    tensors reports through `kernel_work` (`ops.kernel_work_sink`)."""

    def __init__(self, inputs: list[torch.Tensor]):
        super().__init__()
        self.inputs = {_storage_id(t) for t in inputs}
        self.read = 0
        self.written = 0
        self.kernel_flops = 0
        self.kernel_calls: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._owned: dict[int, int] = {}
        self._mutates: dict = {}

    def _is_input(self, x) -> bool:
        return isinstance(x, torch.Tensor) and _storage_id(x) in self.inputs

    def _mutates_first(self, func) -> bool:
        if func not in self._mutates:
            args = func._schema.arguments
            info = args[0].alias_info if args else None
            self._mutates[func] = bool(info is not None and info.is_write)
        return self._mutates[func]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func in _ALIASES):
            self._charge(func, args, kwargs, out)
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._hold(t)
        return out

    def _charge(self, func, args, kwargs, out) -> None:
        first, rest = (args[0], args[1:]) if args else (None, ())
        if isinstance(first, torch.Tensor):
            if self._is_input(first):
                if func in _GATHERS:
                    self.read += out.numel() * first.element_size()
                elif self._mutates_first(func):
                    n = (args[2].numel() * first.element_size()
                         if func == _aten.index_put_.default
                         else _nbytes(first))
                    self.written += n
                    if func not in _OVERWRITES:
                        self.read += n
                else:
                    self.read += _nbytes(first)
        else:
            rest = (first, rest)
        for t in pytree.tree_leaves((rest, kwargs)):
            if self._is_input(t):
                self.read += _nbytes(t)

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.inputs or key in self._owned:
            return
        n = storage.nbytes()
        self._owned[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._owned.pop(key, None)
        self.live -= n

    def kernel_work(self, name: str, operations: int, reads, out) -> None:
        """A kernel's call on `meta` tensors: its operations, and the bytes
        it reads of each input tensor (charged where it is a step input)."""
        self.kernel_flops += operations
        self.kernel_calls[name] += 1
        for t, n in reads:
            if self._is_input(t):
                self.read += n


def _meta(spec: tuple) -> torch.Tensor:
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device="meta")


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts (an `engine.KVCache` too), lists
    and tuples."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def step_record(cfg: ModelConfig, step: str, *, batch: int, seq_len: int,
                cache_len: int | None = None, enc_len: int = 0,
                variant: str = "baseline", shape: str | None = None) -> dict:
    """Trace one train / prefill / decode step of cfg at `batch` x
    `seq_len` on one card (`rank_record` with no ModelParallel) and return
    its cost record. Decode runs one token at `cache_len` (default
    seq_len - 1, the last slot) against a cache of seq_len positions;
    `enc_len` is an encdec model's encoder frames (`shapes
    .step_batch_specs` / `step_cache_specs`). variant "chunked" takes the
    recurrent families' chunked form."""
    if variant == "chunked":
        cfg = dataclasses.replace(cfg, ssm_impl="chunked")
    elif variant != "baseline":
        raise ValueError(f"variant {variant!r}: baseline or chunked")
    rec = rank_record(cfg, step, batch=batch, seq_len=seq_len,
                      cache_len=cache_len, enc_len=enc_len)
    rec.update(
        cache_bytes=rec.pop("argument_bytes").get("cache", 0),
        arch=cfg.name, shape=shape or f"{step}_b{batch}_s{seq_len}",
        step=step, tokens=batch if step == "decode" else batch * seq_len,
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        n_layers=cfg.n_layers + cfg.n_enc_layers, d_model=cfg.d_model,
        n_experts=cfg.n_experts, top_k=cfg.top_k, n_chips=1,
        variant=variant, batch=batch, seq_len=seq_len, enc_len=enc_len)
    rec["bytes_per_device"] = max(rec["cost"]["bytes accessed"],
                                  roofline.streaming_floor_bytes(rec, 1))
    rec["roofline"] = roofline.terms(rec, n_chips=1)
    rec["status"] = "ok"
    return rec


def _trace(run, inputs: list[torch.Tensor]) -> dict:
    """Run `run` once under the counters, `inputs` the tensors that exist
    before it: the record's `memory`, `cost`, `dot_flops_per_device`,
    `kernel_calls`, `fits_one_card` and `trace_s`."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, StepCounter(inputs) as sc, \
            ops.kernel_work_sink(sc.kernel_work):
        result = run()
    trace_s = time.perf_counter() - t0
    in_ids = {_storage_id(t) for t in inputs}
    out_bytes = sum(_nbytes(t) for t in _tensors(result)
                    if _storage_id(t) not in in_ids)
    arg_bytes = _storage_bytes(inputs)
    total_flops = float(flops.get_total_flops() + sc.kernel_flops)
    return {"memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": sc.peak},
            "cost": {"flops": total_flops,
                     "bytes accessed": float(sc.read + sc.written
                                             + out_bytes)},
            "dot_flops_per_device": total_flops,
            "kernel_calls": dict(sc.kernel_calls),
            "fits_one_card": arg_bytes + sc.peak <= roofline.CARD_BYTES,
            "trace_s": round(trace_s, 3)}


def _storage_bytes(tensors: list[torch.Tensor]) -> int:
    """The bytes of the distinct storages that `tensors` lie in."""
    return sum({_storage_id(t): t.untyped_storage().nbytes()
                for t in tensors}.values())


# ---------------------------------------------------------------------------
# The pod dry run: one rank's step on the production mesh
# ---------------------------------------------------------------------------

# The reference's pod policy (src/repro/launch/dryrun.py:44-72): training
# above this many parameters cuts the weights over the data axes too.
FSDP_PARAM_THRESHOLD = 20_000_000_000
POD_MODEL = 16                # the production mesh's "model" axis
POD_VARIANTS = ("baseline", "seqkv", "shmap", "chunked", "zero3", "auto")


def pod_variant(cfg: ModelConfig, shape_name: str) -> str:
    """The reference's `recommended_variant` on its 16-way model axis:
    "chunked" for the ssm and hybrid families' train and prefill steps;
    "shmap" for a train or prefill step whose query heads, kv heads or
    experts 16 does not divide; "seqkv" for every decode; else
    "baseline"."""
    step = SH.SHAPES[shape_name].step
    if cfg.arch_type in ("ssm", "hybrid") and step in ("train", "prefill"):
        return "chunked"
    mis_sharded = (cfg.n_heads % POD_MODEL or cfg.n_kv_heads % POD_MODEL
                   or (cfg.n_experts and cfg.n_experts % POD_MODEL))
    if step in ("train", "prefill") and mis_sharded:
        return "shmap"
    if step == "decode":
        return "seqkv"
    return "baseline"


def shard_mode(cfg: ModelConfig, step: str, variant: str = "baseline"
               ) -> str:
    """The reference's `_shard_mode`: "zero3" where the variant asks for
    it, "fsdp" for a train step above FSDP_PARAM_THRESHOLD parameters,
    else "tp"."""
    if variant == "zero3":
        return "zero3"
    if step == "train" and cfg.param_count() > FSDP_PARAM_THRESHOLD:
        return "fsdp"
    return "tp"


def pod_config(cfg: ModelConfig, variant: str) -> ModelConfig:
    """cfg as the reference's `lower_one` runs it under `variant`: the
    sequence-sharded variants set attn_shard, "chunked" the recurrent
    families' chunked form; "baseline" and "zero3" leave it as it is."""
    if variant in ("seqkv", "shmap"):
        return dataclasses.replace(cfg, attn_shard=variant)
    if variant == "chunked":
        return dataclasses.replace(cfg, ssm_impl="chunked")
    if variant not in ("baseline", "zero3"):
        raise ValueError(f"variant {variant!r}: one of {POD_VARIANTS[:-1]}")
    return cfg


def fold_mesh(mesh) -> MeshShape:
    """A mesh as `ModelParallel` takes it, ("data", "model"): every data
    axis ("pod", "data") folded into one "data" axis of their product,
    pod-major, the order in which the layout rules number a dim's blocks
    cut over ("pod", "data"). A rank's pieces are the same on both
    (`parallel.rank_pieces`)."""
    n_model = mesh.shape["model"]
    return MeshShape(("data", "model"), (mesh.size // n_model, n_model))


def _meta_block(shape, spec, mesh, rank: int, dtype) -> torch.Tensor:
    return torch.empty([m for _, m in local_slices(tuple(shape), spec, mesh,
                                                   rank)],
                       dtype=dtype, device="meta")


def _meta_pieces(tmpl, pieces, dtype) -> dict:
    """A fresh `meta` tensor of each leaf's held pieces (`rank_pieces`)."""
    return MB.tree_map(lambda t, held: torch.empty(
        [sum(m for _, m in dim) for dim in held], dtype=dtype,
        device="meta"), tmpl, pieces)


def _enc_frames(cfg: ModelConfig, step: str, max_len: int,
                enc_len: int) -> int:
    """An encdec model's cache frames (`shapes.step_cache_specs`' rule)."""
    if cfg.arch_type != "encdec" or enc_len:
        return enc_len
    return max_len if step == "prefill" else SH.DECODE_ENC_LEN


def step_inputs(cfg: ModelConfig, step: str, mp=None, *, batch: int,
                seq_len: int, max_len: int | None = None, enc_len: int = 0,
                specs: dict | None = None, param_dtype=None,
                cache_cfg: ModelConfig | None = None) -> dict:
    """A step's arguments, each a fresh `meta` tensor (a view of a whole
    leaf would charge its storage): the parameters in param_dtype (default
    cfg.dtype), Adam's step and m and v of the same at train, the
    `batch` x `seq_len` batch (`shapes.step_batch_specs`), and at prefill
    / decode the cache of max_len positions (default seq_len;
    `engine.init_cache`, in the layout cache_cfg's attn_shard gives,
    default cfg's). Without mp, the whole of each (`shape_structs`, the
    cache's K/V leaves tagged "heads"); with mp (a ModelParallel, the
    counting transport's for a pod rank), that rank's part: its pieces of
    every parameter under the layout tree `specs` (`parallel
    .rank_pieces`), its block of the batch (`sharding.batch_layouts`: a
    batch the data ranks do not divide stays whole), its part of the
    cache of its rows (`init_cache(mp=)`)."""
    tmpl = Z.templates(cfg)
    dtype = param_dtype or cfg.dtype
    max_len = seq_len if max_len is None else max_len
    bspecs = SH.step_batch_specs(cfg, step, batch, seq_len, enc_len)
    if mp is None:
        def params():
            return MB.shape_structs(tmpl, dtype)
        rows = {k: _meta(v) for k, v in bspecs.items()}
    else:
        pieces = rank_pieces(tmpl, specs, mp.mesh, mp.global_rank)

        def params():
            return _meta_pieces(tmpl, pieces, dtype)
        lay = SHD.batch_layouts(bspecs, mp.mesh)
        rows = {k: _meta_block(shape, lay[k], mp.mesh, mp.global_rank, dt)
                for k, (shape, dt) in bspecs.items()}
    out = {"params": params(), "batch": rows}
    if step == "train":
        out["opt_state"] = {
            "step": torch.empty((), dtype=torch.int32, device="meta"),
            "m": params(), "v": params()}
    else:
        out["cache"] = E.init_cache(
            cache_cfg or cfg, rows["tokens"].shape[0], max_len,
            _enc_frames(cfg, step, max_len, enc_len), device="meta", mp=mp)
    return out


def rank_record(cfg: ModelConfig, step: str, mp=None, *, batch: int,
                seq_len: int, layout: TrainLayout | None = None,
                max_len: int | None = None, cache_len: int | None = None,
                enc_len: int = 0, param_dtype=None,
                cache_cfg: ModelConfig | None = None) -> dict:
    """Trace one train / prefill / decode step of cfg through the port's
    entry points (`zoo.train_step` with Adam, `engine.prefill`,
    `engine.decode_step`) on its inputs (`step_inputs`: the global batch x
    seq_len, the cache of max_len positions, default seq_len; decode at
    cache_len, default max_len - 1) and return its record: `memory` (per
    device), `argument_bytes` by kind, `cost`, `kernel_calls` (the card's
    launches), and `dtype`, the one its matmuls run in (param_dtype's,
    default cfg.dtype's). With no mp the step is the whole one-card step.
    With mp, the counting transport of a rank (`ModelParallel.counting`),
    it is that rank's: a train step under `layout` (a `TrainLayout` on
    mp.mesh), a prefill or decode step under `layout` (its
    `parallel.SERVE_MODES`: "zero3" gathers each sublayer's weights where
    it runs them, `engine.serve_weights`) or, with none, with the "tp"
    parameters; and the record adds its collectives as the transport
    counts them (`calls`, `bytes`: bytes put in) and as the reference
    records them
    (`collectives`: result bytes by kind, `roofline.collectives`)."""
    if step not in ("train", "prefill", "decode"):
        raise ValueError(f"step {step!r}: train, prefill or decode")
    specs = None
    if mp is not None and step == "train" and layout is None:
        raise ValueError("a train step over ranks needs its layout")
    if mp is not None:
        specs = (layout.specs if layout is not None else
                 SHD.param_layouts(Z.templates(cfg), mp.mesh, "tp"))
    max_len = seq_len if max_len is None else max_len
    args = step_inputs(cfg, step, mp, batch=batch, seq_len=seq_len,
                       max_len=max_len, enc_len=enc_len, specs=specs,
                       param_dtype=param_dtype, cache_cfg=cache_cfg)
    if step == "train":
        extra = () if mp is None else (mp, layout)

        def run():
            return Z.train_step(args["params"], args["opt_state"],
                                args["batch"], cfg, adam(1e-4).update,
                                *extra)
    elif step == "prefill":
        def run():
            return E.prefill(args["params"], cfg, args["batch"],
                             args["cache"], mp, layout)
    else:
        cache_len = max_len - 1 if cache_len is None else cache_len

        def run():
            return E.decode_step(args["params"], cfg,
                                 args["batch"]["tokens"], args["cache"],
                                 cache_len, mp, layout)
    if mp is not None:
        mp.reset_counts()
    rec = _trace(run, _tensors(args))
    rec.update(
        argument_bytes={k: _storage_bytes(_tensors(v))
                        for k, v in args.items()},
        dtype=str(param_dtype or cfg.dtype).removeprefix("torch."),
        cache_len=cache_len)
    if mp is not None:
        rec.update(calls=dict(mp.calls), bytes=dict(mp.bytes),
                   collectives=roofline.collectives(mp.log))
    return rec


def _filled(cfg: ModelConfig, step: str, seq_len: int, cache_len: int,
            enc_len: int) -> int:
    """The positions a step leaves in the self K/V: at prefill its
    prompt's (an encdec decoder's tokens; a vlm's frontend and tokens), at
    decode cache_len + 1."""
    if step == "decode":
        return cache_len + 1
    specs = SH.step_batch_specs(cfg, step, 1, seq_len, enc_len)
    keys = ("tokens",) if cfg.arch_type == "encdec" else tuple(specs)
    return sum(specs[k][0][1] for k in keys)


def rank_classes(cfg: ModelConfig, step: str, mesh, specs: dict, *,
                 batch: int, seq_len: int, max_len: int,
                 cache_len: int | None = None, enc_len: int = 0,
                 cache_cfg: ModelConfig | None = None) -> list[list[int]]:
    """The global ranks of the ("data", "model") `mesh` in classes of
    equal inputs, each in order of its first rank, from what the code
    reads of a rank: the shapes of its pieces of every leaf under the
    layout tree `specs` (`rank_pieces`) and, at prefill / decode, under
    "tp" (a "zero3" rank runs the "tp" code on its "tp" pieces,
    `parallel.serve_pieces`), its touched query heads and the
    runs of them that read one kv head (`parallel.q_heads`, `_kv_runs`),
    and, for each K/V leaf the cache cuts over its slots, how many of the
    rank's slots hold a position after the step (its range of K8's
    partials at decode, the slots it writes at prefill). Every rank of a
    class runs the same step on the same shapes: one trace stands for
    all."""
    tmpl = Z.templates(cfg)
    world = mesh.shape["model"]
    probe = ModelParallel.counting(mesh, 0)
    seq = {}
    trees = [specs]
    if step != "train":
        trees.append(SHD.param_layouts(tmpl, mesh, "tp"))
        ccfg = cache_cfg or cfg
        frames = _enc_frames(cfg, step, max_len, enc_len)
        fill = _filled(cfg, step, seq_len,
                       max_len - 1 if cache_len is None else cache_len,
                       enc_len)
        shapes = E.cache_shapes(ccfg, 1, max_len, frames)
        seq = {k: (shapes[k][0][-3], shapes[k][0][-3]
                   if k.startswith("cross") else fill)
               for k, cut in E.cache_cuts(ccfg, 1, max_len, probe,
                                          frames).items() if cut == "seq"}
    attn = cfg.arch_type != "ssm" and (cfg.n_heads * cfg.hd) % world == 0
    classes: dict = {}
    for r in range(mesh.size):
        m = r % world
        key = [tuple(tuple(sum(n for _, n in dim) for dim in leaf)
                     for leaf in MB.tree_leaves(rank_pieces(tmpl, tree,
                                                            mesh, r)))
               for tree in trees]
        if attn:
            key.append((len(q_heads(cfg.n_heads, world, m)),
                        tuple(n for _, n in _kv_runs(
                            cfg.n_heads, cfg.n_kv_heads, world, m))))
        for k, (slots, filled) in sorted(seq.items()):
            n = slots // world
            key.append((k, min(max(min(filled, slots) - m * n, 0), n)))
        classes.setdefault(tuple(key), []).append(r)
    return list(classes.values())


def rank_class_records(cfg: ModelConfig, step: str, mesh, *, batch: int,
                       seq_len: int, mode: str = "tp",
                       max_len: int | None = None,
                       cache_len: int | None = None, enc_len: int = 0,
                       param_dtype=None,
                       cache_cfg: ModelConfig | None = None) -> list[dict]:
    """`rank_record` of the first rank of each of `rank_classes` of the
    ("data", "model") `mesh` under the layout `mode` (a train step's, or a
    prefill or decode step's, `parallel.SERVE_MODES`), each with its
    class's `ranks`."""
    tmpl = Z.templates(cfg)
    if step == "train":
        check_train(cfg, mesh, mode)
    elif mode not in SERVE_MODES:
        raise ValueError(f"{cfg.name}: the port serves over ranks under "
                         f"{SERVE_MODES}, not {mode!r}")
    layout = TrainLayout(mode, SHD.param_layouts(tmpl, mesh, mode))
    specs = layout.specs
    max_len = seq_len if max_len is None else max_len
    out = []
    for ranks in rank_classes(cfg, step, mesh, specs, batch=batch,
                              seq_len=seq_len, max_len=max_len,
                              cache_len=cache_len, enc_len=enc_len,
                              cache_cfg=cache_cfg):
        rec = rank_record(cfg, step, ModelParallel.counting(mesh, ranks[0]),
                          batch=batch, seq_len=seq_len, layout=layout,
                          max_len=max_len, cache_len=cache_len,
                          enc_len=enc_len, param_dtype=param_dtype,
                          cache_cfg=cache_cfg)
        out.append(dict(rec, ranks=ranks))
    return out


# the class record's keys the pod record's headline carries
_HEADLINE = ("memory", "argument_bytes", "cost", "dot_flops_per_device",
             "kernel_calls", "calls", "bytes", "collectives",
             "fits_one_card")


def pod_record(arch: str, shape_name: str, *, multi_pod: bool = False,
               variant: str = "baseline") -> dict:
    """The pod dry run of one (arch, assigned shape): the reference's
    `run_one` on its 256-chip (data 16, model 16) or 512-chip (pod 2, data
    16, model 16) mesh (`launch.mesh.production_mesh`, folded by
    `fold_mesh`) under `variant` (`pod_config`) and the reference's shard
    mode (`shard_mode`). Each class of ranks (`rank_classes`) is traced
    once (`rank_record`); the record carries every class with its ranks,
    and its headline figures (`memory`, `cost`, `collectives`, ...,
    `roofline`) are those of the class with the largest bound, the rank a
    step waits for. Under "zero3" the recurrent families' train and
    prefill steps take the chunked form (`ssm_impl` in the record). A
    combo `shapes.applicable` rules out is recorded as skipped with its
    reason."""
    base = CFG.get(arch)
    sh = SH.SHAPES[shape_name]
    mesh = production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    mode = shard_mode(base, sh.step, variant)
    rec = {"arch": arch, "shape": shape_name, "step": sh.step,
           "shard_mode": mode, "multi_pod": multi_pod, "n_chips": n_chips,
           "variant": variant,
           "mesh": dict(zip(mesh.axis_names, mesh.sizes))}
    ok, why = SH.applicable(base, shape_name)
    if not ok:
        return dict(rec, status="skipped", skipped=why)
    cfg = pod_config(base, variant)
    if variant == "zero3" and recommended_variant(cfg, shape_name) != \
            "baseline":
        # the reference lowers the scan form here (one compiled loop
        # body); the port's scan is a Python loop over the positions, which
        # a trace of 4k or 32k of them cannot afford: it traces the chunked
        # form, the same function, as "auto" does
        cfg = dataclasses.replace(cfg, ssm_impl="chunked")
        rec["ssm_impl"] = "chunked"
    t0 = time.perf_counter()
    classes = rank_class_records(cfg, sh.step, fold_mesh(mesh),
                                 batch=sh.global_batch, seq_len=sh.seq_len,
                                 mode=mode)
    cache_bytes = 0
    if sh.step != "train":
        cache_bytes = sum(math.prod(shape) * dt.itemsize for shape, dt in
                          SH.step_cache_specs(cfg, sh.step, sh.global_batch,
                                              sh.seq_len).values())
    rec.update(
        dtype=str(cfg.dtype).removeprefix("torch."),
        tokens=(sh.global_batch if sh.step == "decode"
                else sh.global_batch * sh.seq_len),
        cache_bytes=cache_bytes, params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        n_layers=cfg.n_layers + cfg.n_enc_layers, d_model=cfg.d_model,
        n_experts=cfg.n_experts, top_k=cfg.top_k)
    floor = roofline.streaming_floor_bytes(rec, n_chips)
    for c in classes:
        c["bytes_per_device"] = max(c["cost"]["bytes accessed"], floor)
        c["roofline"] = roofline.terms(dict(rec, **c), n_chips=n_chips)
        c["bound_s"], c["bound_by"] = roofline.bound(dict(rec, **c))
    slow = max(classes, key=lambda c: c["bound_s"])
    rec.update({k: slow[k] for k in _HEADLINE}, cache_len=slow["cache_len"],
               bytes_per_device=slow["bytes_per_device"],
               roofline=slow["roofline"], slowest_ranks=slow["ranks"],
               classes=classes,
               trace_s=round(time.perf_counter() - t0, 3), status="ok")
    return rec


def run_pod(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: Path = DEFAULT_OUT, variant: str = "baseline") -> dict:
    """`pod_record` of one combo, written to out_dir as
    {arch}__{shape}__pod1|pod2[__variant].json."""
    rec = pod_record(arch, shape_name, multi_pod=multi_pod, variant=variant)
    _save(rec, arch, shape_name, out_dir,
          "pod2" if multi_pod else "pod1")
    return rec


def pod_summary(rec: dict) -> str:
    """One line of a pod record: its mode, per-device argument and peak
    GB, whether that fits one card, the three terms and the dominant one,
    and its classes of ranks."""
    mem, t = rec["memory"], rec["roofline"]
    return (f"{rec['shard_mode']}, arg "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB peak "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB a device, "
            f"fits_one_card {rec['fits_one_card']}; compute "
            f"{t['t_compute_s'] * 1e3:.4f} ms memory "
            f"{t['t_memory_s'] * 1e3:.4f} ms collective "
            f"{t['t_collective_s'] * 1e3:.4f} ms ({t['dominant']}); "
            f"collectives {rec['collectives']['total_bytes']:.4e} B; "
            f"{len(rec['classes'])} class(es) of ranks (trace "
            f"{rec['trace_s']} s)")


def run_one(arch: str, shape_name: str, *, out_dir: Path = DEFAULT_OUT,
            variant: str = "baseline") -> dict:
    """The record of one (arch, assigned shape), written to out_dir; a
    combo `shapes.applicable` rules out is recorded as skipped."""
    cfg = CFG.get(arch)
    sh = SH.SHAPES[shape_name]
    ok, why = SH.applicable(cfg, shape_name)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "step": sh.step,
               "n_chips": 1, "variant": variant, "status": "skipped",
               "skipped": why}
    else:
        rec = step_record(cfg, sh.step, batch=sh.global_batch,
                          seq_len=sh.seq_len, variant=variant,
                          shape=shape_name)
        rec["arch"] = arch
    _save(rec, arch, shape_name, out_dir, "h100")
    return rec


def _save(rec: dict, arch: str, shape_name: str, out_dir: Path,
          where: str) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = ("" if rec.get("variant", "baseline") == "baseline"
              else f"__{rec['variant']}")
    path = out_dir / f"{arch}__{shape_name}__{where}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))


def summary(rec: dict) -> str:
    """One line of a record: FLOPs, bytes accessed, the bound and what
    bounds it, argument and peak temp GB, whether it fits one card."""
    bound, by = roofline.bound(rec)
    mem = rec["memory"]
    return (f"flops {rec['cost']['flops']:.4e} bytes "
            f"{rec['cost']['bytes accessed']:.4e} bound {bound * 1e3:.4f} ms "
            f"({by}) arg {mem['argument_size_in_bytes'] / 1e9:.3f} GB temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB fits_one_card "
            f"{rec['fits_one_card']} (trace {rec['trace_s']} s)")


def _combo(pod: bool, arch: str, shape: str, multi_pod: bool,
           variant: str, out: Path) -> tuple[dict, str]:
    """One combo of the CLI: its record and the variant it ran."""
    if variant == "auto":
        variant = (pod_variant if pod else recommended_variant)(
            CFG.get(arch), shape)
    if pod:
        return run_pod(arch, shape, multi_pod=multi_pod, out_dir=out,
                       variant=variant), variant
    return run_one(arch, shape, out_dir=out, variant=variant), variant


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=CFG.all_archs())
    ap.add_argument("--shape", default=None, choices=list(SH.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=POD_VARIANTS,
                    help="baseline|chunked|auto on one card (auto = "
                         "recommended_variant per arch/shape); with --pod "
                         "also seqkv|shmap|zero3 (auto = pod_variant, the "
                         "reference's recommended_variant)")
    ap.add_argument("--pod", action="store_true",
                    help="trace a rank's step on the 256-chip production "
                         "mesh (the reference's pod dry run)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --pod: the 512-chip mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="with --pod: the 256- and the 512-chip mesh")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if not args.pod and (args.multi_pod or args.both_meshes
                         or args.variant not in VARIANTS):
        ap.error(f"--multi-pod, --both-meshes and --variant "
                 f"{args.variant} need --pod")
    out = Path(args.out)
    archs = CFG.all_archs() if (args.all or not args.arch) else [args.arch]
    shape_names = (list(SH.SHAPES) if (args.all or not args.shape)
                   else [args.shape])
    pods = ([False, True] if args.both_meshes else [args.multi_pod]
            if args.pod else [False])
    combos = [(a, s, m) for a in archs for s in shape_names for m in pods]
    failures = 0
    t0 = time.perf_counter()
    # several combos: one spawned process each, up to a core each and 8
    workers = min(len(combos), os.cpu_count() or 1, 8)
    pool = (concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
        if workers > 1 else None)
    try:
        if pool is not None:
            futures = {c: pool.submit(_combo, args.pod, *c, args.variant,
                                      out) for c in combos}
        for c in combos:
            a, s, m = c
            tag = f"{a} x {s}" + (f" x {'2pod' if m else '1pod'}"
                                  if args.pod else "")
            try:
                rec, v = (futures[c].result() if pool is not None
                          else _combo(args.pod, *c, args.variant, out))
                if rec["status"] == "skipped":
                    print(f"[skip] {tag}: {rec['skipped']}", flush=True)
                else:
                    print(f"[ ok ] {tag} ({v}): "
                          f"{(pod_summary if args.pod else summary)(rec)}",
                          flush=True)
            except (OSError, ValueError, KeyError, TypeError,
                    RuntimeError, NotImplementedError) as ex:
                # the classes a combo's failure raises: a config or shape
                # bug (KeyError / TypeError / ValueError), an op that
                # cannot run on meta (RuntimeError / NotImplementedError),
                # the report's IO (OSError)
                failures += 1
                print(f"[FAIL] {tag}: {type(ex).__name__}: {str(ex)[:400]}",
                      flush=True)
                traceback.print_exception(ex, limit=3)
    finally:
        if pool is not None:
            pool.shutdown()
    print(f"[done] {len(combos)} combos in {time.perf_counter() - t0:.1f} s "
          f"({workers} process(es)), {failures} failed")
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
