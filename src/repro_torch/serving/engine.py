"""Serving engine, dense and moe families: cache construction, prefill and
single-token decode (the reference's src/repro/serving/engine.py).

Caches are dicts of tensors with the per-layer state STACKED on a leading
axis, in the reference's layout (M = max cache length):
  dense, moe     : {"k","v"}: (L, B, M, Hkv, hd)
  dense, gemma3  : {"gk","gv"}: (n_groups, B, M, Hkv, hd)   global layers
                   {"lk","lv"}: (n_groups, g-1, B, W, Hkv, hd) local rings
                   {"tlk","tlv"}: (tail, B, W, Hkv, hd)     local tail
with W = min(sliding_window, M): a local layer keeps only a window-sized
ring buffer (slot = position % W).

Prefill and decode write the cache IN PLACE and return it; its contents
equal the reference's. `cache_len` is a host int, so a decode step
launches its work without waiting for the card. Every decode step runs K8
once per layer (`layers.decode_attention`). A moe layer's capacity comes
from the tokens of the call (B * S at prefill, B at decode), as in the
reference: choices past an expert's capacity are dropped.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as Lyr
from repro_torch.models import zoo as Z
from repro_torch.models.base import ModelConfig, unstack


def _windowed(cfg: ModelConfig) -> bool:
    return bool(cfg.arch_type == "dense" and cfg.sliding_window
                and cfg.global_every)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every tensor of the serving cache."""
    Z.check_ported(cfg)
    L, b = cfg.n_layers, batch
    hkv, hd = cfg.n_kv_heads, cfg.hd
    if _windowed(cfg):
        g = cfg.global_every
        n_groups, tail = divmod(L, g)
        w = min(cfg.sliding_window, max_len)
        shapes = {"gk": (n_groups, b, max_len, hkv, hd),
                  "gv": (n_groups, b, max_len, hkv, hd),
                  "lk": (n_groups, g - 1, b, w, hkv, hd),
                  "lv": (n_groups, g - 1, b, w, hkv, hd),
                  "tlk": (tail, b, w, hkv, hd),
                  "tlv": (tail, b, w, hkv, hd)}
    else:
        shapes = {"k": (L, b, max_len, hkv, hd),
                  "v": (L, b, max_len, hkv, hd)}
    return {k: (s, cfg.dtype) for k, s in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict[str, torch.Tensor]:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in cache_shapes(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# Prefill: consume the full prompt, fill the cache, return last-token logits.
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch, cache
            ) -> tuple[torch.Tensor, dict]:
    x = Z.embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x = _run_layers(params, cfg, x, positions, cache, 0, "prefill")
    x = Lyr.rms_norm(x[:, -1:], params["final_norm"])
    return Z._lm_head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Decode: one token against the populated cache.
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                cache_len: int) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) int; cache_len: host int (current cache fill)."""
    x = params["embed"][tokens]
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int64,
                           device=x.device)
    x = _run_layers(params, cfg, x, positions, cache, cache_len, "decode")
    x = Lyr.rms_norm(x, params["final_norm"])
    return Z._lm_head(params, cfg, x), cache


def _run_layers(params, cfg, x, positions, cache, cache_len, mode):
    Z.check_ported(cfg)
    if _windowed(cfg):
        return _dense_serve_windowed(params, cfg, x, positions, cache,
                                     cache_len, mode)
    wins = Z.window_schedule(cfg)
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, _, _ = Z._block_fwd(
            p, cfg, x, positions, int(wins[i]),
            kv_cache={"k": cache["k"][i], "v": cache["v"][i]},
            cache_len=cache_len, mode=mode)
    return x


# ---------------------------------------------------------------------------
# Dense with local:global pattern (gemma3): per group (g-1) ring-buffer
# local layers + 1 full-cache global layer, then the local tail.
# ---------------------------------------------------------------------------

def _dense_serve_windowed(params, cfg, x, positions, cache, cache_len, mode):
    g = cfg.global_every
    n_groups = cfg.n_layers // g
    w = cache["lk"].shape[3]
    layers = unstack(params["blocks"], cfg.n_layers)

    def local_block(x, p, lk, lv):
        h, _ = Lyr.attention(
            p["attn"], cfg, Lyr.rms_norm(x, p["ln1"]), positions=positions,
            kv_cache={"k": lk, "v": lv}, cache_len=cache_len, mode=mode,
            ring_window=w)
        x = x + h
        return x + Lyr.mlp(Lyr.rms_norm(x, p["ln2"]), p["mlp"], cfg.mlp_act)

    for gi in range(n_groups):
        for li in range(g - 1):
            x = local_block(x, layers[gi * g + li], cache["lk"][gi, li],
                            cache["lv"][gi, li])
        x, _ = Z._dense_block_fwd(
            layers[gi * g + g - 1], cfg, x, positions, Lyr.NO_WINDOW,
            kv_cache={"k": cache["gk"][gi], "v": cache["gv"][gi]},
            cache_len=cache_len, mode=mode)
    for ti, p in enumerate(layers[n_groups * g:]):
        x = local_block(x, p, cache["tlk"][ti], cache["tlv"][ti])
    return x
