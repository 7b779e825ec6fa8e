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
With a "zero3" layout (`serve_weights`) a rank holds its zero3 shard and
runs the "tp" code on each sublayer's leaves gathered and narrowed where
the step reads them, into the "tp" cache; its logits are those of its
rows of the batch.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable

import torch

from repro_torch.launch import sharding as SHD
from repro_torch.models import layers as Lyr
from repro_torch.models import zoo as Z
from repro_torch.models.base import ModelConfig, unstack
from repro_torch.models.parallel import (SERVE_MODES, SEQ_VARIANTS, check_tp,
                                         data_cut, gathered_logits,
                                         gathered_lookup, kv_heads,
                                         layout_use, reduce_partial,
                                         serve_pieces)


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
# What a step reads of its parameters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeWeights:
    """How a serving step reads its parameters (`serve_weights`): use(p,
    key) a sublayer of a layer of "blocks" or a top-level leaf or subtree
    as the "tp" layer code takes it, enc_use a layer of "enc_blocks"
    likewise (`parallel.layout_use`); `embed` and `logits` the embedding
    lookup and the head. specs: the "zero3" layout tree (None under "tp"),
    under which a rank never gathers the head (`parallel.gathered_logits`
    sums the ranks' float32 partial logits instead) and gathers the
    embedding only where the batch's tokens outnumber its rows (a long
    prefill): else `parallel.gathered_lookup` moves the tokens' rows, the
    table's bits."""

    use: Callable = operator.getitem
    enc_use: Callable = operator.getitem
    mp: Any = None
    specs: dict | None = None

    def _cut(self, key: str) -> bool:
        return (self.specs is not None
                and data_cut(self.specs[key]) is not None)

    def embed(self, params, cfg, tokens):
        # the rows of every data rank's tokens, or the table: the fewer
        if (self._cut("embed")
                and tokens.numel() * self.mp.data_world < cfg.vocab):
            return gathered_lookup(self.mp, params["embed"], tokens,
                                   self.specs["embed"])
        return Z.embed_tokens({"embed": self.use(params, "embed")}, cfg,
                              tokens, self.mp)

    def logits(self, params, cfg, x):
        w = "embed" if cfg.tie_embeddings else "head"
        if self._cut(w):
            return gathered_logits(self.mp, x, params[w], self.specs[w],
                                   tied=cfg.tie_embeddings)
        return Z._lm_head({w: self.use(params, w)}, cfg, x, self.mp)


def serve_weights(cfg: ModelConfig, mp=None, layout=None) -> ServeWeights:
    """How a step of cfg reads a rank's parameters under `layout`. With no
    layout, or under "tp", the rank's shard as it is held. Under "zero3"
    (`parallel.SERVE_MODES`; layout a `parallel.TrainLayout` on mp's mesh)
    the rank holds its zero3 shard: each layer's leaves the layout cuts
    over "data" are gathered whole where the step reads them, then
    narrowed to the rank's "tp" pieces (`parallel.serve_pieces`), and the
    "tp" code runs on them (the cache is the "tp" cache); the gathered
    weights die with the sublayer that read them, before the next one
    gathers. The embedding and the head are read as `ServeWeights` says."""
    if layout is None or layout.mode == "tp":
        return ServeWeights(mp=mp)
    if mp is None or layout.mode not in SERVE_MODES:
        raise ValueError(f"{cfg.name}: the engine serves over ranks under "
                         f"{SERVE_MODES}, not {layout.mode!r}"
                         + ("" if mp is not None else " without ranks"))
    tmpl = Z.templates(cfg)
    pieces = serve_pieces(tmpl, layout.specs,
                          SHD.param_layouts(tmpl, mp.mesh, "tp"), mp.mesh,
                          mp.global_rank)
    enc_use = (layout_use(mp, layout.specs, "enc_blocks", pieces)
               if cfg.arch_type == "encdec" else operator.getitem)
    return ServeWeights(layout_use(mp, layout.specs, "blocks", pieces),
                        enc_use, mp, layout.specs)


# ---------------------------------------------------------------------------
# Prefill: consume the full prompt, fill the cache, return last-token logits.
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch, cache, mp=None, layout=None
            ) -> tuple[torch.Tensor, dict]:
    """layout: the parameters' layout under mp (`serve_weights`; None is
    "tp")."""
    if mp is not None:
        check_tp(cfg, mp.world)
    w = serve_weights(cfg, mp, layout)
    if cfg.arch_type == "encdec":
        return _prefill_encdec(params, cfg, batch, cache, mp, w)
    x = Z.embed_inputs(params, cfg, batch, mp,
                       tok_emb=w.embed(params, cfg, batch["tokens"]))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x = _run_layers(params, cfg, x, positions, cache, 0, "prefill", mp,
                    w.use)
    x = Lyr.rms_norm(x[:, -1:], params["final_norm"])
    return w.logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Decode: one token against the populated cache.
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                cache_len: int, mp=None, layout=None
                ) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) int; cache_len: host int (current cache fill);
    layout as `prefill`'s."""
    if mp is not None:
        check_tp(cfg, mp.world)
    w = serve_weights(cfg, mp, layout)
    x = w.embed(params, cfg, tokens)
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int64,
                           device=x.device)
    if cfg.arch_type == "encdec":
        x = _decode_encdec(params, cfg, x, positions, cache, cache_len, mp,
                           w.use)
    else:
        x = _run_layers(params, cfg, x, positions, cache, cache_len,
                        "decode", mp, w.use)
    x = Lyr.rms_norm(x, params["final_norm"])
    return w.logits(params, cfg, x), cache


def _run_layers(params, cfg, x, positions, cache, cache_len, mode, mp=None,
                use=operator.getitem):
    if cfg.arch_type == "ssm":
        return _rwkv_run(params, cfg, x, cache, mode, mp, use)
    if cfg.arch_type == "hybrid":
        return _hybrid_run(params, cfg, x, positions, cache, cache_len, mode,
                           mp, use)
    if _windowed(cfg):
        return _dense_serve_windowed(params, cfg, x, positions, cache,
                                     cache_len, mode, mp, use)
    wins = Z.window_schedule(cfg)
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, _, _ = Z._block_fwd(
            p, cfg, x, positions, int(wins[i]),
            kv_cache=_kv(cache, "k", "v", i), cache_len=cache_len,
            mode=mode, mp=mp, use=use)
    return x


# ---------------------------------------------------------------------------
# Dense with local:global pattern (gemma3): per group (g-1) ring-buffer
# local layers + 1 full-cache global layer, then the local tail.
# ---------------------------------------------------------------------------

def _dense_serve_windowed(params, cfg, x, positions, cache, cache_len, mode,
                          mp=None, use=operator.getitem):
    g = cfg.global_every
    n_groups = cfg.n_layers // g
    w = cache["lk"].shape[3]
    if Lyr.seq_cut(mp, cache.cuts["lk"]):
        w *= mp.world                   # the rank holds a block of the ring
    layers = unstack(params["blocks"], cfg.n_layers)

    def local_block(x, p, kv):
        h, _ = Lyr.attention(
            use(p, "attn"), cfg, Lyr.rms_norm(x, p["ln1"]),
            positions=positions, kv_cache=kv, cache_len=cache_len,
            mode=mode, ring_window=w, mp=mp)
        x = x + reduce_partial(mp, h)
        return x + reduce_partial(mp, Lyr.mlp(Lyr.rms_norm(x, p["ln2"]),
                                              use(p, "mlp"), cfg.mlp_act))

    for gi in range(n_groups):
        for li in range(g - 1):
            x = local_block(x, layers[gi * g + li],
                            _kv(cache, "lk", "lv", gi, li))
        x, _ = Z._dense_block_fwd(
            layers[gi * g + g - 1], cfg, x, positions, Lyr.NO_WINDOW,
            kv_cache=_kv(cache, "gk", "gv", gi), cache_len=cache_len,
            mode=mode, mp=mp, use=use)
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


def _rwkv_run(params, cfg, x, cache, mode, mp=None, use=operator.getitem):
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, new = Z._rwkv_block_fwd(
            p, cfg, x, _layer_state(cache, ("tm_shift", "wkv", "cm_shift"),
                                    i, mode), mp, use)
        _write_state(cache, i, new)
    return x


def _hybrid_run(params, cfg, x, positions, cache, cache_len, mode, mp=None,
                use=operator.getitem):
    """zamba2: the mamba layers with their conv / ssm state, and after each
    whole group of `attn_every` the shared block on its own KV cache
    attn_k[g] / attn_v[g] (one set of weights for every application)."""
    emb0 = x
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, new = Z._mamba_block_fwd(
            p, cfg, x, _layer_state(cache, ("conv", "ssm"), i, mode), mp,
            use)
        _write_state(cache, i, new)
        if (i + 1) % cfg.attn_every == 0:
            g = i // cfg.attn_every
            x, _ = Z._shared_attn_fwd(
                use(params, "shared_attn"), cfg, x, emb0, positions,
                kv_cache=_kv(cache, "attn_k", "attn_v", g),
                cache_len=cache_len, mode=mode, mp=mp)
    return x


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless): the encoder runs once at prefill; each layer's
# projected cross K/V live in the cache for decode.
# ---------------------------------------------------------------------------

def _prefill_encdec(params, cfg, batch, cache, mp=None, w=ServeWeights()):
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
    enc_out = Z.encode(params, cfg, batch["frontend"], mp, w.enc_use)
    x = w.embed(params, cfg, batch["tokens"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        p = Z.ready_cross(p, w.use)
        ck, cv = Z.cross_kv(p, cfg, enc_out, mp)
        x, _ = Z._decoder_block_fwd(
            p, cfg, x, positions, (ck, cv, "heads"),
            kv_cache=_kv(cache, "k", "v", i), cache_len=0, mode="prefill",
            mp=mp, use=w.use)
        if seq:
            n = cache["cross_k"].shape[2]
            ck, cv = (t[:, mp.rank * n:(mp.rank + 1) * n] for t in
                      Lyr._gather_heads(mp, cfg, None, ck, cv))
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
    x = Lyr.rms_norm(x[:, -1:], params["final_norm"])
    return w.logits(params, cfg, x), cache


# a decode step's cross attention reads the cached cross K/V, and of its
# weights only these
_CROSS_DECODE = ("wq", "wo", "q_norm")


def _decode_encdec(params, cfg, x, positions, cache, cache_len, mp=None,
                   use=operator.getitem):
    """One token through the decoder: self attention through K8 at
    cache_len, cross attention through K8 over the cached cross K/V."""
    for i, p in enumerate(unstack(params["blocks"], cfg.n_layers)):
        x, _ = Z._decoder_block_fwd(
            Z.ready_cross(p, use, _CROSS_DECODE), cfg, x, positions,
            (cache["cross_k"][i], cache["cross_v"][i],
             cache.cuts["cross_k"]),
            kv_cache=_kv(cache, "k", "v", i), cache_len=cache_len,
            mode="decode", mp=mp, use=use)
    return x
