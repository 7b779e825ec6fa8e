"""Architecture zoo, dense and moe families: parameter templates and the
forward pass.

Dense — llama-style GQA (yi, qwen3, starcoder2, gemma3 local:global) and
pixtral's dense decoder over [patch embeds ; token embeds] (frontend
stubbed, as in the reference). Moe — token-choice top-k MoE (dbrx; arctic
adds a dense residual MLP beside the experts), whose forward also returns
the Switch aux loss summed over the layers. The ssm, hybrid and encdec
families are not ported yet (ROADMAP Queue 1 item 12).

Parameters keep the reference's tree (src/repro/models/zoo.py), with layer
params STACKED on a leading axis; the forward walks the layers in a
Python loop over per-layer views (`base.unstack`). `lm_loss` and
`train_step` are the reference's next-token objective and optimizer step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.base import (ModelConfig, ParamTemplate as P,
                                     stack_tree, tree_leaves, tree_map,
                                     unstack)

BIG_WINDOW = 1 << 30     # "no window" sentinel of the per-layer schedule


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless cfg's family is ported: the keys of _BLOCK_TEMPLATES
    are the one list of ported families."""
    if cfg.arch_type not in _BLOCK_TEMPLATES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} family is not ported to "
            "PyTorch yet (ROADMAP Queue 1 item 12); the port runs the "
            f"{' and '.join(_BLOCK_TEMPLATES)} families")


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


def _moe_templates(cfg: ModelConfig) -> dict:
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    return {
        "router": P((d, e), ("embed", None)),
        "w_gate": P((e, d, ff), ("experts", "embed", "ff")),
        "w_in": P((e, d, ff), ("experts", "embed", "ff")),
        "w_out": P((e, ff, d), ("experts", "ff", "embed")),
    }


def _dense_block_templates(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": P((d,), (None,), "zeros"),
        "attn": _attn_templates(cfg),
        "ln2": P((d,), (None,), "zeros"),
        "mlp": _mlp_templates(cfg),
    }


def _moe_block_templates(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    t = {
        "ln1": P((d,), (None,), "zeros"),
        "attn": _attn_templates(cfg),
        "ln2": P((d,), (None,), "zeros"),
        "moe": _moe_templates(cfg),
    }
    if cfg.dense_residual:
        t["dense_mlp"] = _mlp_templates(cfg)
    return t


_BLOCK_TEMPLATES = {"dense": _dense_block_templates,
                    "moe": _moe_block_templates}


def templates(cfg: ModelConfig) -> dict:
    check_ported(cfg)
    d = cfg.d_model
    t: dict[str, Any] = {
        "embed": P((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": P((d,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        t["head"] = P((d, cfg.vocab), ("embed", "vocab"))
    t["blocks"] = stack_tree(_BLOCK_TEMPLATES[cfg.arch_type](cfg),
                             cfg.n_layers)
    return t


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The port's parameter tree from numpy arrays of the reference's tree
    (e.g. `jax.device_get` of its `materialize`), checked leaf by leaf
    against this config's templates (a moe config's stacked expert leaves,
    (L, E, d, ff), included). Values arrive bit for bit: a bfloat16
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


def _moe_block_fwd(p, cfg, x, positions, window, kv_cache=None,
                   cache_len=None, mode="decode"):
    """The dense block with the MLP replaced by the experts (plus arctic's
    dense residual MLP on the same normed input): (x, cache, aux)."""
    h, cache = Lyr.attention(p["attn"], cfg, Lyr.rms_norm(x, p["ln1"]),
                             positions=positions, window=window,
                             kv_cache=kv_cache, cache_len=cache_len, mode=mode)
    x = x + h
    xn = Lyr.rms_norm(x, p["ln2"])
    moe_out, aux = Lyr.moe_ffn(p["moe"], cfg, xn)
    if cfg.dense_residual:
        moe_out = moe_out + Lyr.mlp(xn, p["dense_mlp"], cfg.mlp_act)
    return x + moe_out, cache, aux


def _block_fwd(p, cfg, x, positions, window, kv_cache=None, cache_len=None,
               mode="decode"):
    """One layer of a dense or moe model: (x, cache, aux), aux the moe
    block's Switch loss and 0.0 for a dense block."""
    if cfg.arch_type == "moe":
        return _moe_block_fwd(p, cfg, x, positions, window, kv_cache,
                              cache_len, mode)
    x, cache = _dense_block_fwd(p, cfg, x, positions, window, kv_cache,
                                cache_len, mode)
    return x, cache, 0.0


def embed_inputs(params, cfg, batch):
    tok_emb = params["embed"][batch["tokens"]]
    if cfg.frontend_positions:
        fe = batch["frontend"].to(tok_emb.dtype)     # (B, P, d) stub embeds
        return torch.cat([fe, tok_emb], dim=1)
    return tok_emb


def forward(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Returns (logits, aux_loss): the moe family's aux summed over the
    layers (float32), 0 for the dense family."""
    check_ported(cfg)
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux_total = torch.zeros((), device=x.device)
    wins = window_schedule(cfg)
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, _, aux = _block_fwd(p, cfg, x, positions, int(wins[i]))
        aux_total = aux_total + aux
    x = Lyr.rms_norm(x, params["final_norm"])
    return _lm_head(params, cfg, x), aux_total


def _lm_head(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss / train step
# ---------------------------------------------------------------------------

def lm_loss(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """Mean next-token NLL over batch["targets"] (float32 logits) plus the
    weighted aux loss; a vlm's frontend positions carry no target."""
    logits, aux = forward(params, cfg, batch)
    if cfg.frontend_positions:
        logits = logits[:, cfg.frontend_positions:]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["targets"][..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + aux_weight * aux


def train_step(params, opt_state, batch, cfg: ModelConfig, opt_update):
    """One optimizer step on the parameter tree: (params, opt_state, loss).
    Each update is cast to its parameter's dtype before it is added."""
    leaves = tree_map(lambda p_: p_.detach().requires_grad_(True), params)
    loss = lm_loss(leaves, cfg, batch)
    grads = iter(torch.autograd.grad(loss, list(tree_leaves(leaves))))
    grads = tree_map(lambda _: next(grads), leaves)
    updates, opt_state = opt_update(grads, opt_state, params)
    params = tree_map(lambda p_, u: p_ + u.to(p_.dtype), params, updates)
    return params, opt_state, loss.detach()
