"""Architecture zoo, dense family: parameter templates and the forward pass.

Dense — llama-style GQA (yi, qwen3, starcoder2, gemma3 local:global) and
pixtral's dense decoder over [patch embeds ; token embeds] (frontend
stubbed, as in the reference). The moe, ssm, hybrid and encdec families
are not ported yet (ROADMAP Queue 1 item 12).

Parameters keep the reference's tree (src/repro/models/zoo.py), with layer
params STACKED on a leading axis; the forward walks the layers in a
Python loop over per-layer views (`base.unstack`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.base import (ModelConfig, ParamTemplate as P,
                                     stack_tree, unstack)

BIG_WINDOW = 1 << 30     # "no window" sentinel of the per-layer schedule


def _not_ported(cfg: ModelConfig) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: the {cfg.arch_type} family is not ported to PyTorch "
        "yet (ROADMAP Queue 1 item 12); the port runs the dense family")


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

def _attn_templates(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = {
        "wq": P((d, h * hd), ("embed", "qout")),
        "wk": P((d, hkv * hd), ("embed", "kvout")),
        "wv": P((d, hkv * hd), ("embed", "kvout")),
        "wo": P((h * hd, cfg.d_model), ("qout", "embed")),
    }
    if cfg.qk_norm:
        t["q_norm"] = P((hd,), (None,), "zeros")
        t["k_norm"] = P((hd,), (None,), "zeros")
    return t


def _mlp_templates(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"wg": P((d, ff), ("embed", "ff")),
                "wi": P((d, ff), ("embed", "ff")),
                "wo": P((ff, cfg.d_model), ("ff", "embed"))}
    return {"wi": P((d, ff), ("embed", "ff")),
            "wo": P((ff, cfg.d_model), ("ff", "embed"))}


def _dense_block_templates(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": P((d,), (None,), "zeros"),
        "attn": _attn_templates(cfg),
        "ln2": P((d,), (None,), "zeros"),
        "mlp": _mlp_templates(cfg),
    }


def templates(cfg: ModelConfig) -> dict:
    if cfg.arch_type != "dense":
        raise _not_ported(cfg)
    d = cfg.d_model
    t: dict[str, Any] = {
        "embed": P((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": P((d,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        t["head"] = P((d, cfg.vocab), ("embed", "vocab"))
    t["blocks"] = stack_tree(_dense_block_templates(cfg), cfg.n_layers)
    return t


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The port's parameter tree from numpy arrays of the reference's tree
    (e.g. `jax.device_get` of its `materialize`), checked leaf by leaf
    against this config's templates. Values arrive bit for bit: a bfloat16
    array (numpy's `ml_dtypes.bfloat16`, which torch.from_numpy rejects)
    crosses as its uint16 bit pattern."""
    def one(a, t: P) -> torch.Tensor:
        a = np.asarray(a)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{cfg.name}: parameter of shape {a.shape}, "
                             f"the template wants {t.shape}")
        if a.dtype.name == "bfloat16":
            out = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                   .copy()).view(torch.bfloat16)
        else:
            out = torch.from_numpy(np.array(a))
        return out.to(device)

    def walk(node, tmpl):
        if isinstance(tmpl, dict):
            if not isinstance(node, dict) or set(node) != set(tmpl):
                raise ValueError(
                    f"{cfg.name}: parameter tree keys "
                    f"{sorted(node) if isinstance(node, dict) else node!r} "
                    f"do not match the template's {sorted(tmpl)}")
            return {k: walk(node[k], tmpl[k]) for k in tmpl}
        return one(node, tmpl)

    return walk(tree, templates(cfg))


# ---------------------------------------------------------------------------
# Per-layer window schedule (gemma3 5:1 local:global)
# ---------------------------------------------------------------------------

def window_schedule(cfg: ModelConfig, n_layers: int | None = None) -> np.ndarray:
    n = n_layers or cfg.n_layers
    if not cfg.sliding_window:
        return np.full(n, BIG_WINDOW, np.int32)
    win = np.full(n, cfg.sliding_window, np.int32)
    if cfg.global_every:
        for i in range(n):
            if cfg.is_global_layer(i):
                win[i] = BIG_WINDOW
    return win


# ---------------------------------------------------------------------------
# Forward pass (full sequence). Returns logits.
# batch: {"tokens": (B,S)} (+ "frontend": (B,P,d) for the vlm)
# ---------------------------------------------------------------------------

def _dense_block_fwd(p, cfg, x, positions, window, kv_cache=None,
                     cache_len=None, mode="decode"):
    h, cache = Lyr.attention(p["attn"], cfg, Lyr.rms_norm(x, p["ln1"]),
                             positions=positions, window=window,
                             kv_cache=kv_cache, cache_len=cache_len, mode=mode)
    x = x + h
    x = x + Lyr.mlp(Lyr.rms_norm(x, p["ln2"]), p["mlp"], cfg.mlp_act)
    return x, cache


def embed_inputs(params, cfg, batch):
    tok_emb = params["embed"][batch["tokens"]]
    if cfg.frontend_positions:
        fe = batch["frontend"].to(tok_emb.dtype)     # (B, P, d) stub embeds
        return torch.cat([fe, tok_emb], dim=1)
    return tok_emb


def forward(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Returns (logits, aux_loss); the dense family has no aux loss."""
    if cfg.arch_type != "dense":
        raise _not_ported(cfg)
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    wins = window_schedule(cfg)
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, _ = _dense_block_fwd(p, cfg, x, positions, int(wins[i]))
    x = Lyr.rms_norm(x, params["final_norm"])
    return _lm_head(params, cfg, x), torch.zeros((), device=x.device)


def _lm_head(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w.to(x.dtype)
