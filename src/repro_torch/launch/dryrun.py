"""Dry-run cost report: trace every (architecture x input shape) step of
the port on `meta` tensors (no allocation) and price it at one H100's
peaks. The port of the reference's `launch/dryrun.py`, which lowers and
compiles each jitted step on a 256-chip TPU pod mesh instead.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--variant auto] [--out DIR]

One step runs once, through the port's own entry points (`zoo.train_step`
with Adam, `engine.prefill`, `engine.decode_step`), on parameters,
optimizer state, batch and cache made as `meta` tensors of the step's
shapes, under two counters:

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
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
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
from repro_torch.models import base as MB
from repro_torch.models import zoo as Z
from repro_torch.models.base import ModelConfig
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
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def step_inputs(cfg: ModelConfig, step: str, *, batch: int, seq_len: int,
                enc_len: int = 0) -> dict:
    """The step's arguments as `meta` tensors: params (`shape_structs` in
    cfg.dtype), Adam state at train, the batch (`shapes.step_batch_specs`)
    and the cache at prefill / decode (`shapes.step_cache_specs`)."""
    params = MB.shape_structs(Z.templates(cfg), cfg.dtype)
    specs = SH.step_batch_specs(cfg, step, batch, seq_len, enc_len)
    out = {"params": params,
           "batch": {k: _meta(v) for k, v in specs.items()}}
    if step == "train":
        out["opt_state"] = {
            "step": torch.empty((), dtype=torch.int32, device="meta"),
            "m": MB.shape_structs(Z.templates(cfg), cfg.dtype),
            "v": MB.shape_structs(Z.templates(cfg), cfg.dtype)}
    else:
        out["cache"] = {k: _meta(v) for k, v in SH.step_cache_specs(
            cfg, step, batch, seq_len, enc_len).items()}
    return out


def step_record(cfg: ModelConfig, step: str, *, batch: int, seq_len: int,
                cache_len: int | None = None, enc_len: int = 0,
                variant: str = "baseline", shape: str | None = None) -> dict:
    """Trace one train / prefill / decode step of cfg at `batch` x
    `seq_len` on `meta` tensors and return its cost record. Decode runs
    one token at `cache_len` (default seq_len - 1, the last slot) against
    a cache of seq_len positions; `enc_len` is an encdec model's encoder
    frames (`shapes.step_batch_specs` / `step_cache_specs`). variant
    "chunked" takes the recurrent families' chunked form."""
    if step not in ("train", "prefill", "decode"):
        raise ValueError(f"step {step!r}: train, prefill or decode")
    if variant == "chunked":
        cfg = dataclasses.replace(cfg, ssm_impl="chunked")
    elif variant != "baseline":
        raise ValueError(f"variant {variant!r}: baseline or chunked")
    args = step_inputs(cfg, step, batch=batch, seq_len=seq_len,
                       enc_len=enc_len)
    inputs = _tensors(args)
    if step != "train":     # its layout tags: every K/V leaf "heads"
        cache = E.KVCache(args["cache"], E.cache_cuts(
            cfg, batch, seq_len, None, enc_len))
    if step == "train":
        def run():
            return Z.train_step(args["params"], args["opt_state"],
                                args["batch"], cfg, adam(1e-4).update)
    elif step == "prefill":
        def run():
            return E.prefill(args["params"], cfg, args["batch"], cache)
    else:
        cache_len = seq_len - 1 if cache_len is None else cache_len

        def run():
            return E.decode_step(args["params"], cfg, args["batch"]["tokens"],
                                 cache, cache_len)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, StepCounter(inputs) as sc, \
            ops.kernel_work_sink(sc.kernel_work):
        result = run()
    trace_s = time.perf_counter() - t0
    in_ids = {_storage_id(t) for t in inputs}
    out_bytes = sum(_nbytes(t) for t in _tensors(result)
                    if _storage_id(t) not in in_ids)
    arg_bytes = sum({_storage_id(t): t.untyped_storage().nbytes()
                     for t in inputs}.values())
    total_flops = float(flops.get_total_flops() + sc.kernel_flops)
    rec = {
        "arch": cfg.name, "shape": shape or f"{step}_b{batch}_s{seq_len}",
        "step": step, "dtype": str(cfg.dtype).removeprefix("torch."),
        "tokens": batch if step == "decode" else batch * seq_len,
        "cache_bytes": sum(_nbytes(t) for t in _tensors(args.get("cache"))),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "n_layers": cfg.n_layers + cfg.n_enc_layers,
        "d_model": cfg.d_model,
        "n_experts": cfg.n_experts, "top_k": cfg.top_k,
        "n_chips": 1, "variant": variant, "trace_s": round(trace_s, 3),
        "batch": batch, "seq_len": seq_len, "cache_len": cache_len,
        "enc_len": enc_len,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": sc.peak},
        "cost": {"flops": total_flops,
                 "bytes accessed": float(sc.read + sc.written + out_bytes)},
        "dot_flops_per_device": total_flops,
        "kernel_calls": dict(sc.kernel_calls),
    }
    rec["bytes_per_device"] = max(rec["cost"]["bytes accessed"],
                                  roofline.streaming_floor_bytes(rec, 1))
    rec["roofline"] = roofline.terms(rec, n_chips=1)
    rec["fits_one_card"] = arg_bytes + sc.peak <= roofline.CARD_BYTES
    rec["status"] = "ok"
    return rec


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
    _save(rec, arch, shape_name, out_dir)
    return rec


def _save(rec: dict, arch: str, shape_name: str, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = ("" if rec.get("variant", "baseline") == "baseline"
              else f"__{rec['variant']}")
    path = out_dir / f"{arch}__{shape_name}__h100{suffix}.json"
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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=CFG.all_archs())
    ap.add_argument("--shape", default=None, choices=list(SH.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS,
                    help="baseline|chunked|auto (auto = recommended_variant "
                         "per arch/shape)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    out = Path(args.out)
    archs = CFG.all_archs() if (args.all or not args.arch) else [args.arch]
    shape_names = (list(SH.SHAPES) if (args.all or not args.shape)
                   else [args.shape])
    failures = 0
    t0 = time.perf_counter()
    for a in archs:
        for s in shape_names:
            tag = f"{a} x {s}"
            try:
                v = args.variant
                if v == "auto":
                    v = recommended_variant(CFG.get(a), s)
                rec = run_one(a, s, out_dir=out, variant=v)
                if rec["status"] == "skipped":
                    print(f"[skip] {tag}: {rec['skipped']}")
                else:
                    print(f"[ ok ] {tag} ({v}): {summary(rec)}")
            except (OSError, ValueError, KeyError, TypeError,
                    RuntimeError, NotImplementedError) as ex:
                # the classes a combo's failure raises: a config or shape
                # bug (KeyError / TypeError / ValueError), an op that
                # cannot run on meta (RuntimeError / NotImplementedError),
                # the report's IO (OSError)
                failures += 1
                print(f"[FAIL] {tag}: {type(ex).__name__}: {str(ex)[:400]}")
                traceback.print_exc(limit=3)
    print(f"[done] {len(archs) * len(shape_names)} combos in "
          f"{time.perf_counter() - t0:.1f} s, {failures} failed")
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
