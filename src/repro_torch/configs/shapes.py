"""The four assigned input shapes and per-(arch, shape) input specs.

  train_4k     seq_len=4096    global_batch=256   train_step
  prefill_32k  seq_len=32768   global_batch=32    serve prefill
  decode_32k   seq_len=32768   global_batch=128   serve decode (1 new token)
  long_500k    seq_len=524288  global_batch=1     long-context decode

Decode shapes run `engine.decode_step`: ONE token against a cache of
seq_len. long_500k needs sub-quadratic attention: it runs for the ssm and
hybrid archs (rwkv6, zamba2) and for gemma3 (sliding-window local layers
with ring-buffer caches, O(S) per token on the global layers); it is
skipped for the pure full-attention archs (yi, qwen3, starcoder2, dbrx,
arctic, pixtral, seamless).

Modality stubs, as in the reference: seamless's audio frontend and
pixtral's ViT arrive as precomputed frame / patch embeddings. For
seamless the `seq_len` of a shape is the audio (encoder) stream's at train
and prefill and the decoder self-attention cache's at decode (with a
4096-frame encoder context); its text decoder length is seq_len / 8,
within [16, 1024], at train and prefill.

A spec is a (shape, dtype) tuple, as `engine.cache_shapes` gives them;
`cache_len` is a host int (the engine's decode takes a Python int), its
spec `((), int)`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig
from repro_torch.serving.engine import cache_shapes


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    step: str            # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

SUBQUADRATIC_ARCHS = {"zamba2-1.2b", "rwkv6-1.6b", "gemma3-27b"}

# an encdec model's encoder context at the decode shapes
DECODE_ENC_LEN = 4096


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.name not in SUBQUADRATIC_ARCHS:
        return False, ("pure full-attention architecture: 524288-token decode "
                       "requires a sub-quadratic/sliding-window variant "
                       "(see configs/shapes.py)")
    return True, ""


def _tokens(shape) -> tuple:
    return tuple(shape), torch.int32


def batch_specs(cfg: ModelConfig, shape_name: str) -> dict[str, tuple]:
    """The step's data inputs (no cache)."""
    sh = SHAPES[shape_name]
    return step_batch_specs(cfg, sh.step, sh.global_batch, sh.seq_len)


def step_batch_specs(cfg: ModelConfig, step: str, b: int, s: int,
                     enc_len: int = 0) -> dict[str, tuple]:
    """The data inputs of a train / prefill / decode step at batch b and
    sequence length s. An encdec model's frontend at train and prefill
    has enc_len frames and its decoder s tokens where enc_len is given;
    else (the assigned shapes' rule) s frames and s / 8 tokens within
    [16, 1024]."""
    d = cfg.d_model
    if step == "decode":
        return {"tokens": _tokens((b, 1))}
    if cfg.arch_type == "encdec":
        frames, s_dec = (enc_len, s) if enc_len else (s, min(max(s // 8, 16),
                                                             1024))
        out = {"frontend": ((b, frames, d), cfg.dtype),
               "tokens": _tokens((b, s_dec))}
        if step == "train":
            out["targets"] = _tokens((b, s_dec))
        return out
    if cfg.frontend_positions:          # vlm: patches + text = seq_len total
        p = cfg.frontend_positions
        out = {"frontend": ((b, p, d), cfg.dtype),
               "tokens": _tokens((b, s - p))}
        if step == "train":
            out["targets"] = _tokens((b, s - p))
        return out
    out = {"tokens": _tokens((b, s))}
    if step == "train":
        out["targets"] = _tokens((b, s))
    return out


def cache_specs(cfg: ModelConfig, shape_name: str) -> dict[str, tuple]:
    """The serving cache of a prefill or decode shape: an encdec model's
    encoder context is DECODE_ENC_LEN frames at decode, seq_len at
    prefill."""
    sh = SHAPES[shape_name]
    return step_cache_specs(cfg, sh.step, sh.global_batch, sh.seq_len)


def step_cache_specs(cfg: ModelConfig, step: str, b: int, max_len: int,
                     enc_len: int = 0) -> dict[str, tuple]:
    """The serving cache of a prefill or decode step of max_len
    positions; an encdec model's encoder context is enc_len frames where
    given, else max_len at prefill and DECODE_ENC_LEN at decode."""
    if cfg.arch_type == "encdec" and not enc_len:
        enc_len = max_len if step == "prefill" else DECODE_ENC_LEN
    return cache_shapes(cfg, b, max_len, enc_len)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Everything the step function takes besides params / opt state."""
    sh = SHAPES[shape_name]
    specs: dict = {"batch": batch_specs(cfg, shape_name)}
    if sh.step in ("prefill", "decode"):
        specs["cache"] = cache_specs(cfg, shape_name)
    if sh.step == "decode":
        specs["cache_len"] = ((), int)
    return specs
