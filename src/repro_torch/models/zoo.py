"""Architecture zoo: parameter templates and the forward pass.

Dense — llama-style GQA (yi, qwen3, starcoder2, gemma3 local:global) and
pixtral's dense decoder over [patch embeds ; token embeds] (frontend
stubbed, as in the reference). Moe — token-choice top-k MoE (dbrx; arctic
adds a dense residual MLP beside the experts), whose forward also returns
the Switch aux loss summed over the layers. Ssm — RWKV-6 (attention-free).
Hybrid — zamba2: a Mamba2 backbone and one *shared* attention block applied
after every `attn_every` layers (weights reused, input [h ; embed0]). The
ssm and hybrid forwards return an aux loss of 0. Encdec — seamless: a
bidirectional encoder over the frontend's frame embeddings, and a causal
decoder whose every layer adds cross attention over the encoder's output;
its aux loss is 0 too.

Parameters keep the reference's tree (src/repro/models/zoo.py), with layer
params STACKED on a leading axis; the forward walks the layers in a
Python loop over per-layer views (`base.unstack`). `lm_loss` and
`train_step` are the reference's next-token objective and optimizer step.

Model parallelism (`mp`, a `models.parallel.ModelParallel`; every
family): the params are a rank's shard under the "tp" layout
(`base.shard_params`); attention runs on the rank's heads, or under
cfg.attn_shard "seqkv" / "shmap" over the rank's block of the keys
(`layers.attention`); each block sums attention's and the MLP's output
projections over the ranks, the moe block runs `layers.moe_ffn_shmap`
(arctic's dense MLP row-parallel beside it); an RWKV-6 layer runs the
rank's heads and sums its time mix's wo (its channel mix reduces and
gathers itself, `layers.rwkv6_channelmix`), a Mamba2 layer runs the
rank's heads and sums out_proj, zamba2's shared block (proj_in whole)
and seamless's encoder and decoder layers (self attention, cross
attention over the rank's heads of the cross K/V, the MLP) sum each
output projection. Where the ranks divide the vocabulary the embedding
is a masked lookup of the rank's vocabulary rows summed over the ranks
(exact: one rank holds each row, the others add zeros) and the head's
logits of the rank's vocabulary columns are gathered to the full
vocabulary; where they do not (seamless's 256,206 over 4), both leaves
are whole and every rank looks its tokens up and computes the whole
logits, with no collective.

Training over a ("data", "model") mesh (`train_step` with mp and a
`parallel.TrainLayout`; "tp" and "zero3" for every family, "fsdp" for the
dense and moe families, `parallel.check_train`): the params are a rank's
shard under the layout, the batch its rows (the "data" axis). Each block
gathers the leaves of a sublayer (its attention, MLP, experts) that the
layout cuts over "data" where it runs them (`parallel.gather_for_use`),
and "tp" / "fsdp" run the heads, the MLP, the recurrent mixers' heads and
the vocabulary cut over "model" as serving does, through the collectives'
autograd forms (the model-replicated input of each sublayer, zamba2's
shared block's and seamless's encoder, cross attention and cross K/V
included, through `parallel.enter_partial`); "zero3" computes them whole
on every rank and keeps the experts over "model". The loss is the
reference's over the whole batch: each rank's NLL summed over "data"
(`parallel.sum_over`), the aux over the whole batch (`layers
.moe_dispatch`; 0 for the families without experts).
"""

from __future__ import annotations

import operator
from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.parallel import (check_tp, check_train, enter_partial,
                                         gather_last, layout_use,
                                         reduce_partial,
                                         reduce_replicated_grads,
                                         regather_saved, sum_over,
                                         sum_held_kv)
from repro_torch.models.base import (ModelConfig, ParamTemplate as P,
                                     stack_tree, tree_leaves, tree_map,
                                     unstack)

BIG_WINDOW = 1 << 30     # "no window" sentinel of the per-layer schedule


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

def _attn_templates(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = {
        "wq": P((d, h * hd), ("embed", "qout")),
        "wk": P((d, hkv * hd), ("embed", "kvout"), head_dim=hd),
        "wv": P((d, hkv * hd), ("embed", "kvout"), head_dim=hd),
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


def _mamba_templates(cfg: ModelConfig) -> dict:
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = di + 2 * n
    return {
        "in_proj": P((d, 2 * di + 2 * n + nh), ("embed", "ff")),
        "conv_w": P((cfg.ssm_conv, conv_ch), (None, "ff")),
        "conv_b": P((conv_ch,), ("ff",), "zeros"),
        "dt_bias": P((nh,), (None,), "zeros"),
        "A_log": P((nh,), (None,), "ones"),
        "D": P((nh,), (None,), "ones"),
        "out_norm": P((di,), ("ff",), "zeros"),
        "out_proj": P((di, d), ("ff", "embed")),
    }


def _rwkv_block_templates(cfg: ModelConfig) -> dict:
    d, r = cfg.d_model, cfg.rwkv_lora_dim
    tm = {
        "wr": P((d, d), ("embed", "qout")),
        "wk": P((d, d), ("embed", "qout")),
        "wv": P((d, d), ("embed", "qout")),
        "wg": P((d, d), ("embed", "qout")),
        "wo": P((d, d), ("qout", "embed")),
        "w0": P((d,), (None,), "zeros"),
        "u": P((d,), (None,), "zeros"),
        "ln_x": P((cfg.rwkv_head_dim,), (None,), "zeros"),
    }
    for nm in ["r", "k", "v", "w", "g"]:
        tm[f"mu_{nm}"] = P((d,), (None,), "zeros")
    for nm in ["lr", "lk", "lv", "lw", "lg", "ww"]:
        tm[f"{nm}_A"] = P((d, r), ("embed", None))
        tm[f"{nm}_B"] = P((r, d), (None, "embed"), "zeros")
    cm = {
        "mu_k": P((d,), (None,), "zeros"),
        "mu_r": P((d,), (None,), "zeros"),
        "wk": P((d, cfg.d_ff), ("embed", "ff")),
        "wv": P((cfg.d_ff, d), ("ff", "embed")),
        "wr": P((d, d), ("embed", "qout")),
    }
    return {"ln1": P((d,), (None,), "zeros"), "tm": tm,
            "ln2": P((d,), (None,), "zeros"), "cm": cm}


def _mamba_block_templates(cfg: ModelConfig) -> dict:
    return {"ln": P((cfg.d_model,), (None,), "zeros"),
            "mixer": _mamba_templates(cfg)}


def _shared_attn_templates(cfg: ModelConfig) -> dict:
    """zamba2's shared block: input [h ; embed0] (2d) -> proj -> attn + mlp."""
    d = cfg.d_model
    return {
        "proj_in": P((2 * d, d), ("embed", None)),
        "ln1": P((d,), (None,), "zeros"),
        "attn": _attn_templates(cfg),
        "ln2": P((d,), (None,), "zeros"),
        "mlp": _mlp_templates(cfg),
    }


def _decoder_block_templates(cfg: ModelConfig) -> dict:
    """An encdec decoder layer: the dense block, then cross attention on
    its own norm (its wk / wv project the encoder's output)."""
    d = cfg.d_model
    return {**_dense_block_templates(cfg),
            "ln_cross": P((d,), (None,), "zeros"),
            "cross": _attn_templates(cfg)}


_BLOCK_TEMPLATES = {"dense": _dense_block_templates,
                    "moe": _moe_block_templates,
                    "ssm": _rwkv_block_templates,
                    "hybrid": _mamba_block_templates,
                    "encdec": _decoder_block_templates}


def shared_applications(cfg: ModelConfig) -> int:
    """How often a hybrid model applies its shared attention block: once
    after each whole group of `attn_every` layers; the layers of a partial
    last group (the tail) follow the last application."""
    return cfg.n_layers // cfg.attn_every


def templates(cfg: ModelConfig) -> dict:
    if cfg.arch_type not in _BLOCK_TEMPLATES:
        raise ValueError(cfg.arch_type)
    d = cfg.d_model
    t: dict[str, Any] = {
        "embed": P((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": P((d,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        t["head"] = P((d, cfg.vocab), ("embed", "vocab"))
    t["blocks"] = stack_tree(_BLOCK_TEMPLATES[cfg.arch_type](cfg),
                             cfg.n_layers)
    if cfg.arch_type == "hybrid":
        t["shared_attn"] = _shared_attn_templates(cfg)
    if cfg.arch_type == "encdec":
        t["enc_blocks"] = stack_tree(_dense_block_templates(cfg),
                                     cfg.n_enc_layers)
        t["enc_norm"] = P((d,), (None,), "zeros")
    return t


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The port's parameter tree from numpy arrays of the reference's tree
    (e.g. `jax.device_get` of its `materialize`), checked leaf by leaf
    against this config's templates (a moe config's stacked expert leaves,
    (L, E, d, ff), a hybrid's unstacked `shared_attn` and an encdec's
    `enc_blocks` included).
    Values arrive bit for bit: a bfloat16 array (numpy's
    `ml_dtypes.bfloat16`, which torch.from_numpy rejects) crosses as its
    uint16 bit pattern."""
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
                     cache_len=None, mode="decode", mp=None,
                     use=operator.getitem):
    """One dense layer: (x, cache). use(p, key): a sublayer's weights where
    they are used (as held, or gathered by a training layout)."""
    h, cache = Lyr.attention(use(p, "attn"), cfg,
                             enter_partial(mp, Lyr.rms_norm(x, p["ln1"])),
                             positions=positions, window=window,
                             kv_cache=kv_cache, cache_len=cache_len, mode=mode,
                             mp=mp)
    x = x + reduce_partial(mp, h)
    x = x + reduce_partial(mp, Lyr.mlp(
        enter_partial(mp, Lyr.rms_norm(x, p["ln2"])), use(p, "mlp"),
        cfg.mlp_act))
    return x, cache


def _moe_block_fwd(p, cfg, x, positions, window, kv_cache=None,
                   cache_len=None, mode="decode", mp=None,
                   use=operator.getitem, ep=None):
    """The dense block with the MLP replaced by the experts (plus arctic's
    dense residual MLP on the same normed input): (x, cache, aux). Under
    mp the experts are expert-parallel (`layers.moe_ffn_shmap`), their sum
    crossing the wire in the activations' dtype (the reference's plain
    "tp" layout) or, under cfg.attn_shard "shmap", in bfloat16 (the
    reference's `moe_ffn_shmap`, which that variant selects, with its
    per-"data"-rank capacity and aux; in one process, within
    `layers.one_process_mesh`, `layers.moe_ffn_blocks`). `ep`, where
    given, is what the experts run over instead of mp (zero3 in training:
    attention and the dense MLP whole, mp None; the experts over
    "model")."""
    one = Lyr.one_process_shape(cfg) if mp is None and ep is None else None
    ep = mp if ep is None else ep
    # the reference's "shmap" variant runs its shard_map MoE wherever the
    # model axis divides the experts (its zoo.py:231-232), one model rank
    # included
    per_shard = (cfg.attn_shard == "shmap" and ep is not None
                 and cfg.n_experts % ep.world == 0)
    h, cache = Lyr.attention(use(p, "attn"), cfg,
                             enter_partial(mp, Lyr.rms_norm(x, p["ln1"])),
                             positions=positions, window=window,
                             kv_cache=kv_cache, cache_len=cache_len, mode=mode,
                             mp=mp)
    x = x + reduce_partial(mp, h)
    xn = Lyr.rms_norm(x, p["ln2"])
    if (one is not None and cfg.attn_shard == "shmap"
            and cfg.n_experts % one[1] == 0):
        moe_out, aux = Lyr.moe_ffn_blocks(use(p, "moe"), cfg, xn, *one)
    elif not per_shard and (ep is None or ep.world == 1):
        moe_out, aux = Lyr.moe_ffn(use(p, "moe"), cfg, xn, ep)
    else:
        wire = torch.bfloat16 if cfg.attn_shard == "shmap" else xn.dtype
        moe_out, aux = Lyr.moe_ffn_shmap(use(p, "moe"), cfg, xn, ep,
                                         wire=wire)
    if cfg.dense_residual:
        moe_out = moe_out + reduce_partial(
            mp, Lyr.mlp(enter_partial(mp, xn), use(p, "dense_mlp"),
                        cfg.mlp_act))
    return x + moe_out, cache, aux


def _block_fwd(p, cfg, x, positions, window, kv_cache=None, cache_len=None,
               mode="decode", mp=None, use=operator.getitem, ep=None):
    """One layer of a dense or moe model (an encdec decoder layer's self
    attention and MLP, as the neural scorer runs it): (x, cache, aux), aux
    the moe block's Switch loss and 0.0 for the others."""
    if cfg.arch_type == "moe":
        return _moe_block_fwd(p, cfg, x, positions, window, kv_cache,
                              cache_len, mode, mp, use, ep)
    x, cache = _dense_block_fwd(p, cfg, x, positions, window, kv_cache,
                                cache_len, mode, mp, use)
    return x, cache, 0.0


def _chunked(cfg, x) -> bool:
    """The recurrent blocks take the chunked form for cfg.ssm_impl ==
    "chunked" and more than one position, else the sequential scan."""
    return cfg.ssm_impl == "chunked" and x.shape[1] > 1


def _rwkv_block_fwd(p, cfg, x, state=None, mp=None, use=operator.getitem):
    """One RWKV-6 layer: (x, new state {"tm_shift", "wkv", "cm_shift"});
    use(p, key) as the dense block's."""
    st_tm = None if state is None else {"shift": state["tm_shift"],
                                        "wkv": state["wkv"]}
    tm = (Lyr.rwkv6_timemix_chunked if _chunked(cfg, x)
          else Lyr.rwkv6_timemix)
    h, new_tm = tm(use(p, "tm"), cfg, Lyr.rms_norm(x, p["ln1"]), st_tm,
                   mp=mp)
    x = x + reduce_partial(mp, h)
    st_cm = None if state is None else {"shift": state["cm_shift"]}
    h, new_cm = Lyr.rwkv6_channelmix(use(p, "cm"), Lyr.rms_norm(x, p["ln2"]),
                                     st_cm, mp)
    x = x + h
    return x, {"tm_shift": new_tm["shift"], "wkv": new_tm["wkv"],
               "cm_shift": new_cm["shift"]}


def _mamba_block_fwd(p, cfg, x, state=None, mp=None, use=operator.getitem):
    """One Mamba2 layer: (x, new state {"conv", "ssm"}); use(p, key) as
    the dense block's."""
    impl = Lyr.mamba2_chunked if _chunked(cfg, x) else Lyr.mamba2_scan
    h, new_state = impl(use(p, "mixer"), cfg, Lyr.rms_norm(x, p["ln"]),
                        state, mp=mp)
    return x + reduce_partial(mp, h), new_state


def _shared_attn_fwd(p, cfg, x, emb0, positions, kv_cache=None,
                     cache_len=None, mode="decode", mp=None):
    """zamba2's shared block on [x ; emb0] @ proj_in, with no window. Its
    weights (proj_in whole) serve every application; in training autograd
    sums their gradients over the applications, and under mp the ln1 /
    ln2 outputs enter the rank's heads and MLP columns through
    `enter_partial`, as a dense block's."""
    inp = torch.cat([x, emb0], dim=-1) @ p["proj_in"]
    h, cache = Lyr.attention(p["attn"], cfg,
                             enter_partial(mp, Lyr.rms_norm(inp, p["ln1"])),
                             positions=positions, window=BIG_WINDOW,
                             kv_cache=kv_cache, cache_len=cache_len, mode=mode,
                             mp=mp)
    x = x + reduce_partial(mp, h)
    x = x + reduce_partial(mp, Lyr.mlp(
        enter_partial(mp, Lyr.rms_norm(x, p["ln2"])), p["mlp"], cfg.mlp_act))
    return x, cache


def vocab_cut(cfg, w: torch.Tensor, dim: int) -> bool:
    """Whether w's vocabulary dim `dim` is a rank's block of it (the "tp"
    layout cuts it where the ranks divide it) rather than whole."""
    return w.shape[dim] != cfg.vocab


def embed_tokens(params, cfg, tokens, mp=None) -> torch.Tensor:
    """The embedding rows of `tokens`. Under mp with the vocabulary cut,
    the rank holds the rows of its block of the vocabulary: it looks up
    the tokens inside it, zeros for the others, and the sum over the
    ranks is the lookup; with it whole, the plain lookup."""
    emb = params["embed"]
    if mp is None or not vocab_cut(cfg, emb, 0):
        return emb[tokens]
    v_loc = emb.shape[0]
    local = tokens - mp.rank * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = emb[torch.where(inside, local, 0)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_partial(mp, rows)


def embed_inputs(params, cfg, batch, mp=None, tok_emb=None):
    """The embedded tokens (`tok_emb` where given), a vlm's frontend
    positions before them."""
    if tok_emb is None:
        tok_emb = embed_tokens(params, cfg, batch["tokens"], mp)
    if cfg.frontend_positions and cfg.arch_type != "encdec":
        fe = batch["frontend"].to(tok_emb.dtype)     # (B, P, d) stub embeds
        return torch.cat([fe, tok_emb], dim=1)
    return tok_emb


def forward(params, cfg: ModelConfig, batch, mp=None, layout=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux_loss): the moe family's aux summed over the
    layers (float32), 0 for the other families. mp: a rank's shard of the
    model (module docstring); the logits are whole.

    layout (with mp, a `parallel.TrainLayout`; `parallel.check_train`):
    params are the rank's shard and batch its rows of a training run. Each
    sublayer's leaves cut over "data" are gathered where they run
    (`parallel.layout_use`: a layer's attention, MLP, experts, RWKV-6's
    time and channel mix, a Mamba2 mixer, zamba2's shared block at each
    application, seamless's cross attention with its cross K/V), the
    embedding and the head where they are used; the heads, the MLP, the
    recurrent mixers' heads and the vocabulary are cut over "model" as in
    serving unless the layout is "zero3" (computed whole on every rank,
    the experts still over "model"); the aux is the whole batch's."""
    tp, use, enc_use = mp, operator.getitem, operator.getitem
    if layout is not None:
        check_train(cfg, mp.mesh, layout.mode)
        tp = None if layout.mode == "zero3" else mp
        use = layout_use(mp, layout.specs)
        if cfg.arch_type == "encdec":
            enc_use = layout_use(mp, layout.specs, "enc_blocks")
    elif mp is not None:
        check_tp(cfg, mp.world)
    if cfg.arch_type == "encdec":
        return _forward_encdec(params, cfg, batch, tp, use, enc_use)
    x = embed_inputs({"embed": use(params, "embed")}, cfg, batch, tp)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux_total = torch.zeros((), device=x.device)
    layers = unstack(params["blocks"], cfg.n_layers)
    if cfg.arch_type == "ssm":
        for p in layers:
            x, _ = _rwkv_block_fwd(p, cfg, x, mp=tp, use=use)
    elif cfg.arch_type == "hybrid":
        x = _hybrid_forward(params, cfg, x, layers, positions, tp, use)
    else:
        wins = window_schedule(cfg)
        for i, p in enumerate(layers):
            x, _, aux = _block_fwd(p, cfg, x, positions, int(wins[i]),
                                   mp=tp, use=use, ep=mp)
            aux_total = aux_total + aux
    x = Lyr.rms_norm(x, params["final_norm"])
    w = "embed" if cfg.tie_embeddings else "head"
    return _lm_head({w: use(params, w)}, cfg, x, tp), aux_total


def _hybrid_forward(params, cfg, x, layers, positions, mp=None,
                    use=operator.getitem):
    """zamba2: the mamba layers, the shared block after each whole group
    of `attn_every` of them (its second input emb0 the embedded input),
    the tail's layers after the last application. use(p, key) as the
    dense block's: the shared block's weights are read (gathered) anew at
    each application."""
    emb0 = x
    for i, p in enumerate(layers):
        x, _ = _mamba_block_fwd(p, cfg, x, mp=mp, use=use)
        if (i + 1) % cfg.attn_every == 0:
            x, _ = _shared_attn_fwd(use(params, "shared_attn"), cfg, x,
                                    emb0, positions, mp=mp)
    return x


def _lm_head(params, cfg, x, mp=None):
    """Logits over the vocabulary; under mp with the vocabulary cut the
    rank's columns gathered from every rank in rank order (the argmax of
    the whole row then keeps the lowest index on ties, as without mp);
    with it whole every rank computes the whole logits."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    if mp is None or not vocab_cut(cfg, w, -1):
        return x @ w.to(x.dtype)
    return gather_last(mp, enter_partial(mp, x) @ w.to(x.dtype))


def _promoted(x, w):
    """x in the dtype a JAX product x @ w is taken in: the larger of the
    two (the frontend arrives in cfg.dtype, the launcher's weights are
    float32 whatever cfg.dtype says)."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


def encode(params, cfg, frontend: torch.Tensor, mp=None,
           use=operator.getitem) -> torch.Tensor:
    """The encoder over the frontend's frame embeddings (B, S_enc, d), cast
    to cfg.dtype as in the reference: non-causal attention with rope at
    positions 0..S_enc-1 and the MLP in each layer, then enc_norm. Under mp
    each layer runs the rank's heads and MLP columns (its normed inputs
    through `enter_partial`) and sums both output projections over the
    ranks; under the sequence-sharded variants its attention, with no
    cache, runs over the ranks' blocks of the frames where they divide
    S_enc (`layers.attention`); the output is whole. use(p, key) reads an
    encoder layer's attention and MLP (`parallel.layout_use` of
    "enc_blocks")."""
    x = frontend.to(cfg.dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for p in unstack(params["enc_blocks"], cfg.n_enc_layers):
        attn = use(p, "attn")
        xn = _promoted(Lyr.rms_norm(x, p["ln1"]), attn["wq"])
        h, _ = Lyr.attention(attn, cfg, enter_partial(mp, xn),
                             positions=positions, causal=False, mp=mp)
        del attn
        x = x + reduce_partial(mp, h)
        x = x + reduce_partial(mp, Lyr.mlp(
            enter_partial(mp, Lyr.rms_norm(x, p["ln2"])), use(p, "mlp"),
            cfg.mlp_act))
    return Lyr.rms_norm(x, params["enc_norm"])


def cross_kv(p, cfg, enc_out, mp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross K and V, each (B, S_enc, Hkv, hd): its
    cross wk / wv applied to the encoder's output (a rank's shard: its kv
    heads; the whole encoder output enters them through
    `enter_partial`)."""
    b, s, _ = enc_out.shape
    enc_out = enter_partial(mp, _promoted(enc_out, p["cross"]["wk"]))
    shape = (b, s, p["cross"]["wk"].shape[1] // cfg.hd, cfg.hd)
    return ((enc_out @ p["cross"]["wk"]).reshape(shape),
            (enc_out @ p["cross"]["wv"]).reshape(shape))


def _decoder_block_fwd(p, cfg, x, positions, kv, kv_cache=None,
                       cache_len=None, mode="decode", mp=None,
                       use=operator.getitem):
    """One encdec decoder layer: the dense block (no window; use(p, key)
    as its), then cross attention over the encoder's kv = (k, v, their
    layout tag) on rms_norm(x, ln_cross): under mp the rank's query heads
    over its kv heads ("heads"), or at decode over a cross K/V cut over
    its frames ("seq"; `layers.cross_attention`). p["cross"] is read as
    it is: the caller has made it ready (`ready_cross`)."""
    x, cache = _dense_block_fwd(p, cfg, x, positions, BIG_WINDOW, kv_cache,
                                cache_len, mode, mp, use)
    h, _ = Lyr.attention(p["cross"], cfg,
                         enter_partial(mp, Lyr.rms_norm(x, p["ln_cross"])),
                         positions=positions, causal=False, cross_kv=kv,
                         mp=mp)
    return x + reduce_partial(mp, h), cache


def ready_cross(p, use, keys=None) -> dict:
    """A decoder layer's views p with its cross attention's weights read
    once (use(p, "cross"), `parallel.layout_use`) for both its cross K/V
    and its cross attention; `keys` keeps only those leaves (a decode step
    reads the cached cross K/V, not cross wk / wv)."""
    cross = p["cross"] if keys is None else {k: v for k, v in
                                             p["cross"].items() if k in keys}
    return dict(p, cross=use({"cross": cross}, "cross"))


def _forward_encdec(params, cfg, batch, mp=None, use=operator.getitem,
                    enc_use=operator.getitem):
    """seamless: the encoder over batch["frontend"], then the decoder over
    batch["tokens"] with each layer's cross attention over the encoder's
    output; aux 0. (The reference's jax.checkpoint is remat, not
    semantics.) use / enc_use read a decoder / encoder layer's sublayers
    and the top level's leaves (`parallel.layout_use`)."""
    enc_out = encode(params, cfg, batch["frontend"], mp, enc_use)
    x = embed_tokens({"embed": use(params, "embed")}, cfg, batch["tokens"],
                     mp)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for p in unstack(params["blocks"], cfg.n_layers):
        p = ready_cross(p, use)
        x, _ = _decoder_block_fwd(p, cfg, x, positions,
                                  (*cross_kv(p, cfg, enc_out, mp), "heads"),
                                  mp=mp, use=use)
    x = Lyr.rms_norm(x, params["final_norm"])
    w = "embed" if cfg.tie_embeddings else "head"
    return (_lm_head({w: use(params, w)}, cfg, x, mp),
            torch.zeros((), device=x.device))


# ---------------------------------------------------------------------------
# Loss / train step
# ---------------------------------------------------------------------------

def lm_loss(params, cfg: ModelConfig, batch, aux_weight: float = 0.01,
            mp=None, layout=None):
    """Mean next-token NLL over batch["targets"] (float32 logits) plus the
    weighted aux loss; a vlm's frontend positions carry no target (an
    encdec's frontend is the encoder's input, not part of the logits).
    With mp and a layout (a rank of a training run, batch its rows): the
    mean over the whole batch, each "data" rank's NLL summed over them
    (`parallel.sum_over`: its gradient reaches this rank's rows only), so
    every rank returns the unsharded loss and the sum over the ranks of
    their gradients is its gradient."""
    logits, aux = forward(params, cfg, batch, mp, layout)
    if cfg.frontend_positions and cfg.arch_type != "encdec":
        logits = logits[:, cfg.frontend_positions:]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["targets"][..., None])[..., 0]
    if layout is None:
        nll = (logz - gold).mean()
    else:
        nll = sum_over(mp, (logz - gold).sum() / (gold.numel()
                                                  * mp.data_world),
                       ("data",))
    return nll + aux_weight * aux


def _or_zeros(g, p_):
    return torch.zeros_like(p_) if g is None else g


def train_step(params, opt_state, batch, cfg: ModelConfig, opt_update,
               mp=None, layout=None):
    """One optimizer step on the parameter tree: (params, opt_state, loss).
    Each update is cast to its parameter's dtype before it is added. A
    leaf the loss does not reach (a hybrid's shared block when the depth
    keeps no application of it) gets a zero gradient, as under jax.grad.

    With mp and a `parallel.TrainLayout` (`parallel.check_train`: "tp" and
    "zero3" for every family, "fsdp" for the dense and moe families): params
    and opt_state are this rank's shards
    under the layout, batch its rows of the batch; the step is the
    unsharded one's. The weights gathered for use are not saved for the
    backward (`parallel.regather_saved`); the leaves the layout leaves
    whole over "data" have their gradients summed over it
    (`parallel.reduce_replicated_grads`), and a kv head that several
    "model" ranks hold (the attention's wk / wv where the ranks do not
    divide the kv heads) has its gradient summed over them
    (`parallel.sum_held_kv`); Adam runs on the shards."""
    leaves = tree_map(lambda p_: p_.detach().requires_grad_(True), params)
    if layout is None:
        loss = lm_loss(leaves, cfg, batch)
    else:
        with regather_saved(mp):
            loss = lm_loss(leaves, cfg, batch, mp=mp, layout=layout)
    flat = list(tree_leaves(leaves))
    grads = [_or_zeros(g, p_) for g, p_ in zip(
        torch.autograd.grad(loss, flat, allow_unused=True), flat)]
    if layout is not None:
        grads = reduce_replicated_grads(mp, grads,
                                        list(tree_leaves(layout.specs)))
    grads = iter(grads)
    grads = tree_map(lambda p_: next(grads), leaves)
    if (layout is not None and layout.mode != "zero3"
            and cfg.n_kv_heads % mp.world):
        attn = grads["blocks"]["attn"]
        attn["wk"], attn["wv"] = sum_held_kv(mp, cfg, attn["wk"], attn["wv"])
    updates, opt_state = opt_update(grads, opt_state, params)
    # freed before the new params are made: the step's peak is then the
    # optimizer's own (params, both states and the updates), not one tree
    # more
    del grads
    params = tree_map(lambda p_, u: p_ + u.to(p_.dtype), params, updates)
    return params, opt_state, loss.detach()
