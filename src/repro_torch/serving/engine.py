"""Serving engine: cache construction, prefill and single-token decode for
every family of the zoo (the reference's src/repro/serving/engine.py).

Caches are dicts of tensors with the per-layer state STACKED on a leading
axis, in the reference's layout (M = max cache length):
  dense, moe     : {"k","v"}: (L, B, M, Hkv, hd)
  dense, gemma3  : {"gk","gv"}: (n_groups, B, M, Hkv, hd)   global layers
                   {"lk","lv"}: (n_groups, g-1, B, W, Hkv, hd) local rings
                   {"tlk","tlv"}: (tail, B, W, Hkv, hd)     local tail
  ssm (rwkv6)    : {"tm_shift","cm_shift"}: (L, B, d), "wkv": (L, B, nh,
                   hd, hd) float32
  hybrid (zamba2): {"conv": (L, B, kw-1, di+2n), "ssm": (L, B, nh, hd, N)
                   float32, "attn_k","attn_v": (G, B, M, Hkv, hd)}, G the
                   shared block's applications (zoo.shared_applications)
  encdec (seamless): the dense {"k","v"} + {"cross_k","cross_v"}: (L, B,
                   S_enc, Hkv, hd), the encoder's projected K/V per layer
with W = min(sliding_window, M): a local layer keeps only a window-sized
ring buffer (slot = position % W). Every tensor is in cfg.dtype unless
marked float32.

Prefill and decode write the cache IN PLACE and return it; its contents
equal the reference's. `cache_len` is a host int, so a decode step
launches its work without waiting for the card. Every decode step runs K8
once per attention layer (`layers.decode_attention`): once per layer of a
dense or moe model, once per shared-block application of a hybrid, never
for the ssm family, and twice per decoder layer of an encdec model — its
self attention and its cross attention over the cached cross K/V. An
encdec prefill runs the encoder once and writes each layer's cross K/V
into the cache; its frontend must span the cache's S_enc frames. A moe
layer's capacity comes from the tokens of the call (B * S at prefill, B
at decode), as in the reference: choices past an expert's capacity are
dropped. The recurrent layers' prefill starts
from zero state whatever the cache holds, as the reference's does; a
layer's new state is written over its old one after the layer has read
it.

Model parallelism (`mp`, `models.parallel.ModelParallel`; every family,
params a rank's shard from `models.base.shard_params`): the cache takes
one of the reference's layouts (`launch.sharding.cache_layouts` computes
the same) leaf by leaf, and prefill and decode run the zoo's blocks with
mp.
Under "heads" (cfg.attn_shard "auto") each rank holds its kv heads of
every K/V entry (gemma3's rings, zamba2's attn_k / attn_v and seamless's
cross K/V included) and K8 runs on every rank over its local heads; where
the ranks do not divide a dense or moe model's kv heads, a rank's kv
heads are the ones its query heads read, whole, and several ranks hold
each (`parallel.kv_heads`), where the reference cuts hd; the
recurrent states hold the rank's heads ("wkv", "ssm") as the reference
cuts them, and two leaves are held otherwise (`local_cache_shapes`):
Mamba2's "conv" at the channels of the rank's heads plus B / C whole, and
RWKV-6's "tm_shift" / "cm_shift" whole (every rank's token shift reads the
whole previous x). Under "seq" (cfg.attn_shard "seqkv" or "shmap", the
reference's decode layout; every family, the ssm family having no K/V
leaf) a K/V leaf whose slots the ranks divide holds the rank's block of
them (positions, a ring's slots, or seamless's encoder frames) with every
kv head, and decode combines K8's partials over the blocks across the
ranks (`layers.seq_decode_attention`); a leaf they do not divide keeps the
"heads" cut, so one cache can mix both: `init_cache` tags each K/V leaf
with its layout (`KVCache.cuts`), and attention reads each leaf's tag.
Where the ranks split a dense or moe model's query heads (yi-34b's 56
over 16 ranks), a rank's kv heads are those its touched query heads read
(`parallel.q_heads`). Every rank returns the same, whole logits.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as Lyr
from repro_torch.models import zoo as Z
from repro_torch.models.base import ModelConfig, unstack
from repro_torch.models.parallel import (SEQ_VARIANTS, check_tp, kv_heads,
                                         reduce_partial)


def _windowed(cfg: ModelConfig) -> bool:
    return bool(cfg.arch_type == "dense" and cfg.sliding_window
                and cfg.global_every)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: int = 0
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every tensor of the serving cache; enc_len is an
    encdec model's encoder length S_enc (ignored by the other families)."""
    L, b, d = cfg.n_layers, batch, cfg.d_model
    hkv, hd = cfg.n_kv_heads, cfg.hd
    f32 = torch.float32
    if cfg.arch_type == "ssm":
        nh, rhd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"tm_shift": ((L, b, d), cfg.dtype),
                "wkv": ((L, b, nh, rhd, rhd), f32),
                "cm_shift": ((L, b, d), cfg.dtype)}
    if cfg.arch_type == "hybrid":
        g = Z.shared_applications(cfg)
        di, n = cfg.ssm_d_inner, cfg.ssm_state
        return {"conv": ((L, b, cfg.ssm_conv - 1, di + 2 * n), cfg.dtype),
                "ssm": ((L, b, cfg.ssm_heads, cfg.ssm_head_dim, n), f32),
                "attn_k": ((g, b, max_len, hkv, hd), cfg.dtype),
                "attn_v": ((g, b, max_len, hkv, hd), cfg.dtype)}
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
        if cfg.arch_type == "encdec":
            shapes.update(cross_k=(L, b, enc_len, hkv, hd),
                          cross_v=(L, b, enc_len, hkv, hd))
    return {k: (s, cfg.dtype) for k, s in shapes.items()}


# the recurrent families' state leaves: every other leaf is a K/V leaf
_STATES = ("tm_shift", "cm_shift", "wkv", "ssm", "conv")


def cache_policy(cfg: ModelConfig) -> str:
    """The cache layout a model-parallel run of cfg takes: the reference's
    decode layout, "seq" under its sequence-sharded variants, else
    "heads"."""
    return "seq" if cfg.attn_shard in SEQ_VARIANTS else "heads"


def local_cache_shapes(cfg: ModelConfig, batch: int, max_len: int, mp,
                       enc_len: int = 0
                       ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """cache_shapes of the part one rank of `mp` holds under the layout
    `cache_policy(cfg)`, leaf by leaf. A K/V leaf, (..., S, Hkv, hd), as
    the reference's rule (`launch.sharding.cache_layouts`): under "seq" a
    leaf whose S the ranks divide is cut into blocks of S / world slots
    with every kv head; any other holds the rank's kv heads
    (`parallel.kv_heads`), whole: its block of Hkv / world where the ranks
    divide the kv heads, as the reference's rule, and otherwise the kv
    heads its query heads read, (..., S, 1, hd) for starcoder2-3b's 2 over
    4 ranks, where the reference's rule cuts hd instead (a within-head
    split no rank can attend with alone). "wkv" / "ssm" have their head
    dim (2) cut, as the reference's. Two leaves differ from the
    reference's channel cut, which splits them where no rank can compute
    on its block: "conv" holds the x channels of the rank's heads and B / C
    whole (`parallel.mamba_pieces`: d_inner / world + 2 N), and
    "tm_shift" / "cm_shift" are whole."""
    check_tp(cfg, mp.world)
    n = mp.world
    held = len(kv_heads(cfg.n_heads, cfg.n_kv_heads, n, mp.rank))
    cuts = cache_cuts(cfg, batch, max_len, mp, enc_len)

    def one(k, s):
        if k in ("tm_shift", "cm_shift"):
            return s
        if k in ("wkv", "ssm"):
            return s[:2] + (s[2] // n,) + s[3:]
        if k == "conv":
            return s[:-1] + (cfg.ssm_d_inner // n + 2 * cfg.ssm_state,)
        if cuts[k] == "seq":
            return s[:-3] + (s[-3] // n,) + s[-2:]
        return s[:-2] + (held, s[-1])

    return {k: (one(k, s), dt) for k, (s, dt) in cache_shapes(
        cfg, batch, max_len, enc_len).items()}


def cache_cuts(cfg: ModelConfig, batch: int, max_len: int, mp,
               enc_len: int = 0) -> dict[str, str]:
    """The layout tag of every K/V leaf of the cache (every leaf but the
    recurrent states, `_STATES`) under mp: "seq" (a block of its slots,
    every kv head) where `cache_policy(cfg)` is "seq" and more than one
    rank divides its slots, else "heads" (the rank's kv heads; every leaf
    without mp)."""
    seq = mp is not None and mp.world > 1 and cache_policy(cfg) == "seq"
    return {k: "seq" if seq and s[-3] % mp.world == 0 else "heads"
            for k, (s, _) in cache_shapes(cfg, batch, max_len,
                                          enc_len).items()
            if k not in _STATES}


class KVCache(dict):
    """The serving cache: its tensors by name (a dict), and `cuts`, each
    K/V leaf's layout tag (`cache_cuts`), kept beside the tensors so that
    each rank's cache bytes are its layout's alone. Prefill and decode
    read each leaf's tag (`layers.seq_cut`)."""

    def __init__(self, tensors: dict, cuts: dict[str, str]):
        super().__init__(tensors)
        self.cuts = dict(cuts)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               *, device="cuda", mp=None) -> KVCache:
    """The zeroed serving cache; under mp this rank's part of it
    (`local_cache_shapes`), its K/V leaves tagged with their layouts."""
    shapes = (cache_shapes(cfg, batch, max_len, enc_len) if mp is None
              else local_cache_shapes(cfg, batch, max_len, mp, enc_len))
    return KVCache({k: torch.zeros(s, dtype=dt, device=device)
                    for k, (s, dt) in shapes.items()},
                   cache_cuts(cfg, batch, max_len, mp, enc_len))


def _kv(cache: KVCache, k: str, v: str, *idx) -> dict:
    """A layer's K/V leaves cache[k][idx] / cache[v][idx] and their
    layout tag, as `layers.attention` takes them."""
    return {"k": cache[k][idx], "v": cache[v][idx], "cut": cache.cuts[k]}


# ---------------------------------------------------------------------------
# Prefill: consume the full prompt, fill the cache, return last-token logits.
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch, cache, mp=None
            ) -> tuple[torch.Tensor, dict]:
    if mp is not None:
        check_tp(cfg, mp.world)
    if cfg.arch_type == "encdec":
        return _prefill_encdec(params, cfg, batch, cache, mp)
    x = Z.embed_inputs(params, cfg, batch, mp)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x = _run_layers(params, cfg, x, positions, cache, 0, "prefill", mp)
    x = Lyr.rms_norm(x[:, -1:], params["final_norm"])
    return Z._lm_head(params, cfg, x, mp), cache


# ---------------------------------------------------------------------------
# Decode: one token against the populated cache.
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                cache_len: int, mp=None) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) int; cache_len: host int (current cache fill)."""
    if mp is not None:
        check_tp(cfg, mp.world)
    x = Z.embed_tokens(params, cfg, tokens, mp)
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int64,
                           device=x.device)
    if cfg.arch_type == "encdec":
        x = _decode_encdec(params, cfg, x, positions, cache, cache_len, mp)
    else:
        x = _run_layers(params, cfg, x, positions, cache, cache_len,
                        "decode", mp)
    x = Lyr.rms_norm(x, params["final_norm"])
    return Z._lm_head(params, cfg, x, mp), cache


def _run_layers(params, cfg, x, positions, cache, cache_len, mode, mp=None):
    if cfg.arch_type == "ssm":
        return _rwkv_run(params, cfg, x, cache, mode, mp)
    if cfg.arch_type == "hybrid":
        return _hybrid_run(params, cfg, x, positions, cache, cache_len, mode,
                           mp)
    if _windowed(cfg):
        return _dense_serve_windowed(params, cfg, x, positions, cache,
                                     cache_len, mode, mp)
    wins = Z.window_schedule(cfg)
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, _, _ = Z._block_fwd(
            p, cfg, x, positions, int(wins[i]),
            kv_cache=_kv(cache, "k", "v", i), cache_len=cache_len,
            mode=mode, mp=mp)
    return x


# ---------------------------------------------------------------------------
# Dense with local:global pattern (gemma3): per group (g-1) ring-buffer
# local layers + 1 full-cache global layer, then the local tail.
# ---------------------------------------------------------------------------

def _dense_serve_windowed(params, cfg, x, positions, cache, cache_len, mode,
                          mp=None):
    g = cfg.global_every
    n_groups = cfg.n_layers // g
    w = cache["lk"].shape[3]
    if Lyr.seq_cut(mp, cache.cuts["lk"]):
        w *= mp.world                   # the rank holds a block of the ring
    layers = unstack(params["blocks"], cfg.n_layers)

    def local_block(x, p, kv):
        h, _ = Lyr.attention(
            p["attn"], cfg, Lyr.rms_norm(x, p["ln1"]), positions=positions,
            kv_cache=kv, cache_len=cache_len, mode=mode, ring_window=w,
            mp=mp)
        x = x + reduce_partial(mp, h)
        return x + reduce_partial(mp, Lyr.mlp(Lyr.rms_norm(x, p["ln2"]),
                                              p["mlp"], cfg.mlp_act))

    for gi in range(n_groups):
        for li in range(g - 1):
            x = local_block(x, layers[gi * g + li],
                            _kv(cache, "lk", "lv", gi, li))
        x, _ = Z._dense_block_fwd(
            layers[gi * g + g - 1], cfg, x, positions, Lyr.NO_WINDOW,
            kv_cache=_kv(cache, "gk", "gv", gi), cache_len=cache_len,
            mode=mode, mp=mp)
    for ti, p in enumerate(layers[n_groups * g:]):
        x = local_block(x, p, _kv(cache, "tlk", "tlv", ti))
    return x


# ---------------------------------------------------------------------------
# The recurrent families: rwkv6 (ssm) and zamba2 (hybrid). Prefill runs each
# recurrent layer from zero state; decode from the cached one.
# ---------------------------------------------------------------------------

def _layer_state(cache, keys, i, mode) -> dict | None:
    return {k: cache[k][i] for k in keys} if mode == "decode" else None


def _write_state(cache, i, new: dict) -> None:
    for k, v in new.items():
        cache[k][i].copy_(v)


def _rwkv_run(params, cfg, x, cache, mode, mp=None):
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, new = Z._rwkv_block_fwd(
            p, cfg, x, _layer_state(cache, ("tm_shift", "wkv", "cm_shift"),
                                    i, mode), mp)
        _write_state(cache, i, new)
    return x


def _hybrid_run(params, cfg, x, positions, cache, cache_len, mode, mp=None):
    """zamba2: the mamba layers with their conv / ssm state, and after each
    whole group of `attn_every` the shared block on its own KV cache
    attn_k[g] / attn_v[g] (one set of weights for every application)."""
    emb0 = x
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, new = Z._mamba_block_fwd(
            p, cfg, x, _layer_state(cache, ("conv", "ssm"), i, mode), mp)
        _write_state(cache, i, new)
        if (i + 1) % cfg.attn_every == 0:
            g = i // cfg.attn_every
            x, _ = Z._shared_attn_fwd(
                params["shared_attn"], cfg, x, emb0, positions,
                kv_cache=_kv(cache, "attn_k", "attn_v", g),
                cache_len=cache_len, mode=mode, mp=mp)
    return x


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless): the encoder runs once at prefill; each layer's
# projected cross K/V live in the cache for decode.
# ---------------------------------------------------------------------------

def _prefill_encdec(params, cfg, batch, cache, mp=None):
    """The encoder over batch["frontend"], then the decoder over
    batch["tokens"]: each layer writes its self K/V (prefill mode) and its
    cross K/V, cast to the cache's dtype, into cache["cross_k"][i] /
    ["cross_v"][i]: under mp the rank's kv heads or, where the leaf is cut
    over its frames (its tag "seq", `layers.seq_cut`), the rank's block of
    the frames with every kv head (the rank's heads gathered whole). Its
    own cross attention attends the uncast K/V of its heads, as the
    reference's does (no cache, no sequence cut)."""
    frames = batch["frontend"].shape[1]
    seq = Lyr.seq_cut(mp, cache.cuts["cross_k"])
    enc_len = cache["cross_k"].shape[2] * (mp.world if seq else 1)
    if frames != enc_len:
        raise ValueError(f"a cache of {enc_len} encoder frames cannot take "
                         f"a frontend of {frames}")
    enc_out = Z.encode(params, cfg, batch["frontend"], mp)
    x = Z.embed_tokens(params, cfg, batch["tokens"], mp)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        ck, cv = Z.cross_kv(p, cfg, enc_out, mp)
        x, _ = Z._decoder_block_fwd(
            p, cfg, x, positions, (ck, cv, "heads"),
            kv_cache=_kv(cache, "k", "v", i), cache_len=0, mode="prefill",
            mp=mp)
        if seq:
            n = cache["cross_k"].shape[2]
            ck, cv = (t[:, mp.rank * n:(mp.rank + 1) * n] for t in
                      Lyr._gather_heads(mp, cfg, None, ck, cv))
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
    x = Lyr.rms_norm(x[:, -1:], params["final_norm"])
    return Z._lm_head(params, cfg, x, mp), cache


def _decode_encdec(params, cfg, x, positions, cache, cache_len, mp=None):
    """One token through the decoder: self attention through K8 at
    cache_len, cross attention through K8 over the cached cross K/V."""
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, _ = Z._decoder_block_fwd(
            p, cfg, x, positions, (cache["cross_k"][i], cache["cross_v"][i],
                                   cache.cuts["cross_k"]),
            kv_cache=_kv(cache, "k", "v", i), cache_len=cache_len,
            mode="decode", mp=mp)
    return x
