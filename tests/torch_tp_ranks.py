"""Rank functions of tests/test_torch_tp.py, tests/test_torch_tp_families.py,
tests/test_torch_tp_kvrep.py, tests/test_torch_tp_qsplit.py,
tests/test_torch_seq.py, tests/test_torch_seq_families.py,
tests/test_torch_fsdp.py, tests/test_torch_train_families.py,
tests/test_torch_shmap_train.py, tests/test_torch_pod_dryrun.py,
tests/test_torch_zero3.py and tests/test_torch_zero3_serve.py.
Each runs in a process that `launch.mesh.spawn_ranks` starts, one rank of
a model-parallel run over gloo on the CPU, and returns what the test
compares (tensors come back as numpy arrays). This module imports torch
and the port only, so a rank starts without jax."""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch import configs as TCFG
from repro_torch.kernels import ops
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as TLT
from repro_torch.models import base as MB
from repro_torch.models import layers as Lyr
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as Z
from repro_torch.optim import adam
from repro_torch.serving import engine as E


def _digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.detach().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def record_reductions(mp) -> list[str]:
    """A digest of every all-reduce's result on this rank, in call order
    (the list fills as the run goes)."""
    seen = []
    reduce = mp.all_reduce_sum

    def recorded(x):
        out = reduce(x)
        seen.append(_digest(out))
        return out

    mp.all_reduce_sum = recorded
    return seen


def smoke_cfg(arch: str):
    return dataclasses.replace(TCFG.get_smoke(arch), dtype=torch.float32)


def model_rank(mp, arch: str, params_np: dict, tokens, feed, steps: int,
               max_len: int) -> dict:
    """One rank serving the arch's smoke config from the reference's
    numpy params (`serve_case`, `steps` decode steps fed feed[i] (B, 1)),
    every all-reduce's result digested; last, the ranks' max rank by
    `all_reduce_max` in bfloat16."""
    digests = record_reductions(mp)
    out = serve_case(mp, smoke_cfg(arch), params_np, tokens, feed[:steps],
                     max_len)
    top = mp.all_reduce_max(torch.tensor([float(mp.rank)],
                                         dtype=torch.bfloat16))
    return dict(out, digests=digests, top_rank=top)


def serve_case(mp, cfg, params_np: dict, tokens, feed, max_len: int
               ) -> dict:
    """One rank serving cfg from the reference's numpy params: its shard
    and the gather back, the forward over `tokens` (each moe layer's
    router probabilities and expert choices recorded), and the engine's
    prefill of `tokens` then a decode step per feed[i] (B, 1). The
    collectives of each part are counted."""
    full = Z.params_from_numpy(params_np, cfg, device="cpu")
    tmpl = Z.templates(cfg)
    layout = SH.param_layouts(tmpl, mp.mesh, "tp")
    shard = MB.shard_params(full, tmpl, layout, mp)
    back = MB.gather_params(shard, tmpl, layout, mp)
    round_trip = [torch.equal(a, b) for a, b in
                  zip(MB.tree_leaves(back), MB.tree_leaves(full))]
    shard_shapes = [tuple(a.shape) for a in MB.tree_leaves(shard)]
    del full, back

    tokens = torch.as_tensor(tokens)
    routes, route = [], Lyr.moe_route

    def recorded(p, cfg_, xt):
        probs, gate_v, gate_i = route(p, cfg_, xt)
        routes.append((probs, gate_i))
        return probs, gate_v, gate_i

    mp.reset_counts()
    Lyr.moe_route = recorded
    try:
        logits, aux = Z.forward(shard, cfg, {"tokens": tokens}, mp)
    finally:
        Lyr.moe_route = route
    calls = {"forward": dict(mp.calls)}

    b, s = tokens.shape
    cache = E.init_cache(cfg, b, max_len, device="cpu", mp=mp)
    mp.reset_counts()
    lg, cache = E.prefill(shard, cfg, {"tokens": tokens}, cache, mp)
    calls["prefill"] = dict(mp.calls)
    step_logits = [lg[:, -1]]
    mp.reset_counts()
    for i, tok in enumerate(feed):
        lg, cache = E.decode_step(shard, cfg, torch.as_tensor(tok), cache,
                                  s + i, mp)
        step_logits.append(lg[:, -1])
    calls["decode"] = dict(mp.calls)
    return dict(round_trip=round_trip, shard_shapes=shard_shapes,
                logits=logits, aux=aux, routes=routes,
                step_logits=step_logits, cache=cache, calls=calls)


def kvrep_rank(mp, cases) -> dict:
    """One rank of tests/test_torch_tp_kvrep.py: `serve_case` for each
    case (name, arch, variant, params_np, tokens, feed, max_len), the
    arch's smoke config in float32 under attn_shard=variant; every
    all-reduce's result digested, per case."""
    digests = record_reductions(mp)
    out = {}
    for name, arch, variant, params_np, tokens, feed, max_len in cases:
        start = len(digests)
        cfg = dataclasses.replace(smoke_cfg(arch), attn_shard=variant)
        out[name] = dict(serve_case(mp, cfg, params_np, tokens, feed,
                                    max_len), digests=digests[start:])
    return out


def qsplit_rank(mp, cases) -> dict:
    """One rank of tests/test_torch_tp_qsplit.py: `serve_case` for each
    case (name, arch, overrides, variant, params_np, tokens, feed,
    max_len), the arch's smoke config in float32 with the fields
    `overrides` names (its query / kv head counts) under
    attn_shard=variant; every all-reduce's result digested, and K8's
    calls (whole and partials) over the whole case counted, per case."""
    digests = record_reductions(mp)
    out = {}
    for name, arch, overrides, variant, params_np, tokens, feed, \
            max_len in cases:
        start = len(digests)
        cfg = dataclasses.replace(smoke_cfg(arch), attn_shard=variant,
                                  **overrides)
        whole, ranges = [], []
        undo, undo_k8 = _record_partials(ranges), _record_k8(whole)
        try:
            res = serve_case(mp, cfg, params_np, tokens, feed, max_len)
        finally:
            undo()
            undo_k8()
        out[name] = dict(res, digests=digests[start:], k8=len(whole),
                         k8_partial=len(ranges))
    return out


def moe_rank(mp, arch: str, params_np: dict, x, capacity_factors) -> dict:
    """One rank of `layers.moe_ffn_shmap` on the arch's smoke moe layer
    (the reference's numpy params of `zoo._moe_templates`, its experts cut
    by `shard_params`), at each capacity factor: the output over the bf16
    wire (the reference's) and over the float32 wire, the aux, and this
    rank's float32 partial sum before the wire."""
    out = {}
    x = torch.as_tensor(x)
    for cf in capacity_factors:
        cfg = dataclasses.replace(smoke_cfg(arch), capacity_factor=cf)
        tmpl = Z._moe_templates(cfg)
        full = {k: torch.as_tensor(v) for k, v in params_np.items()}
        p = MB.shard_params(full, tmpl, SH.param_layouts(tmpl, mp.mesh),
                            mp)
        y16, aux = Lyr.moe_ffn_shmap(p, cfg, x, mp)
        y32, _ = Lyr.moe_ffn_shmap(p, cfg, x, mp, wire=torch.float32)
        xt = x.reshape(-1, x.shape[-1])
        probs, gate_v, gate_i = Lyr.moe_route(p, cfg, xt)
        e_loc = p["w_gate"].shape[0]
        partial = Lyr._local_experts(
            p, cfg, xt, gate_v, gate_i, mp.rank * e_loc,
            tuple(Lyr.moe_dispatch(cfg, probs, gate_i)[:4]))
        out[cf] = dict(y_bf16=y16, y_f32=y32, aux=aux, n_local=e_loc,
                       partial=partial.reshape(x.shape))
    return out


def _record_partials(calls: list):
    """Wrap `ops.swa_decode_partial` (which `layers` reaches through the
    module) to record each call's (lo, hi); returns the undo."""
    orig = ops.swa_decode_partial

    def recorded(q, k, v, lo, hi):
        calls.append((lo, hi))
        return orig(q, k, v, lo, hi)

    ops.swa_decode_partial = recorded
    return lambda: setattr(ops, "swa_decode_partial", orig)


def seq_rank(mp, cases) -> list[dict]:
    """One rank of the sequence-sharded serving tests: for each case
    (arch, variant, params_np, tokens, feed, max_len) the smoke config
    in float32 under attn_shard=variant, its "tp" shard of the reference's
    numpy params, the forward over `tokens`, then the engine's prefill of
    them into the "seq" cache and a decode step per feed[i] (B, 1). The
    collectives of the forward, the prefill and each decode step, the
    partials calls' (lo, hi) of each step, and the cache."""
    out = []
    for arch, variant, params_np, tokens, feed, max_len in cases:
        cfg = dataclasses.replace(smoke_cfg(arch), attn_shard=variant)
        full = Z.params_from_numpy(params_np, cfg, device="cpu")
        tmpl = Z.templates(cfg)
        shard = MB.shard_params(full, tmpl,
                                SH.param_layouts(tmpl, mp.mesh, "tp"), mp)
        tokens = torch.as_tensor(tokens)
        mp.reset_counts()
        logits, aux = Z.forward(shard, cfg, {"tokens": tokens}, mp)
        calls = {"forward": dict(mp.calls)}
        b, s = tokens.shape
        cache = E.init_cache(cfg, b, max_len, device="cpu", mp=mp)
        mp.reset_counts()
        lg, cache = E.prefill(shard, cfg, {"tokens": tokens}, cache, mp)
        calls["prefill"] = dict(mp.calls)
        step_logits, step_calls, step_ranges = [lg[:, -1]], [], []
        for i, tok in enumerate(feed):
            mp.reset_counts()
            ranges = []
            undo = _record_partials(ranges)
            try:
                lg, cache = E.decode_step(shard, cfg, torch.as_tensor(tok),
                                          cache, s + i, mp)
            finally:
                undo()
            step_logits.append(lg[:, -1])
            step_calls.append(dict(mp.calls))
            step_ranges.append(ranges)
        out.append(dict(logits=logits, aux=aux, step_logits=step_logits,
                        cache=cache, calls=calls, step_calls=step_calls,
                        step_ranges=step_ranges))
    return out


def _record_k8(calls: list):
    """Wrap `ops.swa_decode` (whole K8) to count its calls; returns the
    undo."""
    orig = ops.swa_decode

    def recorded(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    ops.swa_decode = recorded
    return lambda: setattr(ops, "swa_decode", orig)


def seq_family_rank(mp, cases) -> dict:
    """One rank of tests/test_torch_seq_families.py: for each case (name,
    arch, variant, params_np, tokens, frontend or None, feed, max_len) the
    arch's smoke config in float32 under attn_shard=variant, its "tp"
    shard of the reference's numpy params, the forward, then the engine's
    prefill into the "seq" cache (an encdec model's frontend spanning its
    cross K/V) and a decode step per feed[i] (B, 1). The collectives of
    the forward, the prefill and each decode step, each step's partials
    calls' (lo, hi) and whole-K8 calls, and the cache."""
    out = {}
    for name, arch, variant, params_np, tokens, frontend, feed, \
            max_len in cases:
        cfg = dataclasses.replace(smoke_cfg(arch), attn_shard=variant)
        full = Z.params_from_numpy(params_np, cfg, device="cpu")
        tmpl = Z.templates(cfg)
        shard = MB.shard_params(full, tmpl,
                                SH.param_layouts(tmpl, mp.mesh, "tp"), mp)
        batch = {"tokens": torch.as_tensor(tokens)}
        enc_len = 0
        if frontend is not None:
            batch["frontend"] = torch.as_tensor(frontend)
            enc_len = frontend.shape[1]
        mp.reset_counts()
        logits, _ = Z.forward(shard, cfg, batch, mp)
        calls = {"forward": dict(mp.calls)}
        b, s = batch["tokens"].shape
        cache = E.init_cache(cfg, b, max_len, enc_len, device="cpu", mp=mp)
        mp.reset_counts()
        lg, cache = E.prefill(shard, cfg, batch, cache, mp)
        calls["prefill"] = dict(mp.calls)
        step_logits, step_calls, step_ranges, step_k8 = [lg[:, -1]], [], \
            [], []
        for i, tok in enumerate(feed):
            mp.reset_counts()
            ranges, whole = [], []
            undo, undo_k8 = _record_partials(ranges), _record_k8(whole)
            try:
                lg, cache = E.decode_step(shard, cfg, torch.as_tensor(tok),
                                          cache, s + i, mp)
            finally:
                undo()
                undo_k8()
            step_logits.append(lg[:, -1])
            step_calls.append(dict(mp.calls))
            step_ranges.append(ranges)
            step_k8.append(len(whole))
        out[name] = dict(logits=logits, step_logits=step_logits,
                         cache=cache, calls=calls, step_calls=step_calls,
                         step_ranges=step_ranges, step_k8=step_k8)
    return out


def shmap_rank(mp, cases) -> list[dict]:
    """One rank of `layers.shmap_attention` for each case (q, k, v, causal,
    window, q_offset): over the rank's block of the keys, with the
    bfloat16 and the float32 wire, and the rank's blockwise softmax state
    (m, l, acc) over its block."""
    out = []
    for q, k, v, causal, window, q_offset in cases:
        q, k, v = (torch.as_tensor(a) for a in (q, k, v))
        n = k.shape[1] // mp.world
        blk = slice(mp.rank * n, (mp.rank + 1) * n)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  k_offset=mp.rank * n)
        res = {str(w): Lyr.shmap_attention(q, k[:, blk], v[:, blk], mp,
                                           wire=w, **kw)
               for w in (torch.bfloat16, torch.float32)}
        res["stats"] = Lyr.blockwise_attention(
            q, k[:, blk], v[:, blk], kv_chunk=min(1024, max(n // 4, 8)),
            return_stats=True, **kw)
        out.append(res)
    return out


def seq_tests_rank(mp, engine_cases, attn_cases) -> dict:
    """tests/test_torch_seq.py's one spawn: `seq_rank` and `shmap_rank`."""
    return dict(engine=seq_rank(mp, engine_cases),
                attn=shmap_rank(mp, attn_cases))


def family_rank(mp, cases) -> dict:
    """One rank of tests/test_torch_tp_families.py: for each case (name,
    arch, ssm_impl, vocab, params_np, tokens, frontend, feed, max_len) the
    arch's smoke config in float32 (vocab replaced where given) from the
    reference's numpy params, its "tp" shard and the gather back (bit for
    bit, per leaf), the forward, the engine's prefill (the cache right
    after it) and a decode step per feed[i] (B, 1), each part's
    collectives counted and every all-reduce's result digested."""
    digests = record_reductions(mp)
    out = {}
    for name, arch, impl, vocab, params_np, tokens, frontend, feed, \
            max_len in cases:
        cfg = dataclasses.replace(smoke_cfg(arch), ssm_impl=impl)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        full = Z.params_from_numpy(params_np, cfg, device="cpu")
        tmpl = Z.templates(cfg)
        layout = SH.param_layouts(tmpl, mp.mesh, "tp")
        shard = MB.shard_params(full, tmpl, layout, mp)
        back = MB.gather_params(shard, tmpl, layout, mp)
        round_trip = [torch.equal(a, b) for a, b in
                      zip(MB.tree_leaves(back), MB.tree_leaves(full))]
        shard_shapes = [tuple(a.shape) for a in MB.tree_leaves(shard)]
        del full, back
        batch = {"tokens": torch.as_tensor(tokens)}
        enc_len = 0
        if frontend is not None:
            batch["frontend"] = torch.as_tensor(frontend)
            enc_len = batch["frontend"].shape[1]
        start = len(digests)
        mp.reset_counts()
        logits, _ = Z.forward(shard, cfg, batch, mp)
        calls = {"forward": dict(mp.calls)}
        b, s = batch["tokens"].shape
        cache = E.init_cache(cfg, b, max_len, enc_len, device="cpu", mp=mp)
        mp.reset_counts()
        lg, cache = E.prefill(shard, cfg, batch, cache, mp)
        calls["prefill"] = dict(mp.calls)
        prefill_cache = {k: v.clone() for k, v in cache.items()}
        step_logits = [lg[:, -1]]
        mp.reset_counts()
        for i, tok in enumerate(feed):
            lg, cache = E.decode_step(shard, cfg, torch.as_tensor(tok),
                                      cache, s + i, mp)
            step_logits.append(lg[:, -1])
        calls["decode"] = dict(mp.calls)
        out[name] = dict(round_trip=round_trip, shard_shapes=shard_shapes,
                         logits=logits, step_logits=step_logits,
                         prefill_cache=prefill_cache, cache=cache,
                         calls=calls, digests=digests[start:])
    return out


def _record_keeps(keeps: list):
    """Wrap `layers.moe_dispatch` to record each call's kept choices (slot
    < cap: this rank's tokens' choices, of the whole batch's dispatch),
    but a remat's recompute's (its forward's again); returns the undo."""
    orig = Lyr.moe_dispatch

    def recorded(cfg, probs, gate_i, mp=None):
        out = orig(cfg, probs, gate_i, mp)
        if not Lyr.recomputing():
            keeps.append(out[2] < out[3])
        return out

    Lyr.moe_dispatch = recorded
    return lambda: setattr(Lyr, "moe_dispatch", orig)


def _unflatten(flat: dict) -> dict:
    """{"a/b/c": array} as a nested dict."""
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _state_at(path, i, cfg, tmpl, specs, mp):
    """This rank's shards of the params and the Adam state that the npz
    file `path` holds for the start of step i (keys "{i}/step" and
    "{i}/{params,m,v}/<leaf path>")."""
    with np.load(path) as d:
        trees = {kind: _unflatten({k[len(f"{i}/{kind}/"):]: d[k]
                                   for k in d.files
                                   if k.startswith(f"{i}/{kind}/")})
                 for kind in ("params", "m", "v")}
        step = int(d[f"{i}/step"])
    shards = {kind: MB.shard_params(Z.params_from_numpy(t, cfg, device="cpu"),
                                    tmpl, specs, mp)
              for kind, t in trees.items()}
    return shards.pop("params"), {
        "step": torch.tensor(step, dtype=torch.int32), **shards}


def _train_case(mp, arch, mode, overrides, params_np, batches, lr,
                states=None) -> dict:
    """One training case on this rank: the arch's smoke config in float32
    with the fields `overrides` names (a capacity factor, an ssm_impl, a
    depth) from the reference's numpy params, its shard under `mode` and
    the gather back, then an Adam step (`zoo.train_step` with mp and the
    layout) on the rank's rows of each batch, each step's collectives and
    kept choices recorded, and Adam's m after the first step gathered.
    With `states` (an npz file, `_state_at`) every step after the first
    starts from the reference's params and Adam state of that step instead
    of this run's own, and m is gathered after every step."""
    cfg = dataclasses.replace(smoke_cfg(arch), **overrides)
    tmpl = Z.templates(cfg)
    layout = TPAR.TrainLayout(mode, SH.param_layouts(tmpl, mp.mesh, mode))
    full = Z.params_from_numpy(params_np, cfg, device="cpu")
    shard = MB.shard_params(full, tmpl, layout.specs, mp)
    back = MB.gather_params(shard, tmpl, layout.specs, mp)
    round_trip = all(torch.equal(a, b) for a, b in
                     zip(MB.tree_leaves(back), MB.tree_leaves(full)))
    del full, back
    opt = adam(lr)
    state = opt.init(shard)
    losses, calls, keeps, ms = [], [], [], []
    for i, batch in enumerate(batches):
        if states is not None and i:
            shard, state = _state_at(states, i, cfg, tmpl, layout.specs, mp)
        rows = TLT.batch_rows({k: torch.as_tensor(v)
                               for k, v in batch.items()}, mp.mesh,
                              mp.global_rank)
        step_keeps = []
        undo = _record_keeps(step_keeps)
        mp.reset_counts()
        try:
            shard, state, loss = Z.train_step(shard, state, rows, cfg,
                                              opt.update, mp, layout)
        finally:
            undo()
        losses.append(float(loss))
        calls.append(dict(mp.calls))
        keeps.append(step_keeps)
        if i == 0 or states is not None:
            ms.append(MB.gather_params(state["m"], tmpl, layout.specs, mp))
    again = MB.shard_params(MB.gather_params(shard, tmpl, layout.specs, mp),
                            tmpl, layout.specs, mp)
    gathers_back = all(torch.equal(a, b) for a, b in
                       zip(MB.tree_leaves(again), MB.tree_leaves(shard)))
    digests = {k: [_digest(a) for a in MB.tree_leaves(t)] for k, t in
               (("params", shard), ("m", state["m"]), ("v", state["v"]))}
    state_bytes = sum(a.numel() * a.element_size() for t in (
        shard, state["m"], state["v"]) for a in MB.tree_leaves(t))
    return dict(losses=losses, calls=calls, keeps=keeps,
                m1=ms[0] if mp.global_rank == 0 else None,
                ms=ms if mp.global_rank == 0 else None,
                round_trip=round_trip, gathers_back=gathers_back,
                digests=digests, state_bytes=state_bytes,
                step=int(state["step"]))


def _kept_gathered(mp, arch, mode, params_np, batch, hooks: bool,
                   overrides=None) -> int:
    """How many of the weights a training forward gathered for use are
    still alive after it returns (held by the autograd graph for the
    backward), with `regather_saved`'s hooks or, for contrast, with the
    gathered weights registered but no hooks; the backward then runs, so
    that every rank makes the same collectives. `overrides`: config
    fields, as `_train_case`'s."""
    cfg = dataclasses.replace(smoke_cfg(arch), **(overrides or {}))
    tmpl = Z.templates(cfg)
    layout = TPAR.TrainLayout(mode, SH.param_layouts(tmpl, mp.mesh, mode))
    shard = MB.shard_params(Z.params_from_numpy(params_np, cfg, device="cpu"),
                            tmpl, layout.specs, mp)
    leaves = MB.tree_map(lambda a: a.requires_grad_(True), shard)
    rows = TLT.batch_rows({k: torch.as_tensor(v) for k, v in batch.items()},
                          mp.mesh, mp.global_rank)
    if hooks:
        with TPAR.regather_saved(mp):
            reg = mp.regather
            loss = Z.lm_loss(leaves, cfg, rows, mp=mp, layout=layout)
    else:
        reg = mp.regather = {}
        try:
            loss = Z.lm_loss(leaves, cfg, rows, mp=mp, layout=layout)
        finally:
            mp.regather = None
    alive = sum(ref() is not None for ref, *_ in reg.values())
    assert reg, "no weight was gathered"
    torch.autograd.grad(loss, list(MB.tree_leaves(leaves)))
    return alive


def train_rank(mp, cases, kept_case=None, launcher=None) -> dict:
    """One rank of tests/test_torch_fsdp.py and tests/test_torch_train
    _families.py: `_train_case` for each case (name, arch, mode, config
    overrides, params_np, batches, lr[, states]); where
    kept_case (arch, mode, params_np, batch) is given, the gathered
    weights still alive after a forward with and without
    `regather_saved`; where launcher (arch, mode, steps, batch, seq,
    seed) is given, `launch.train.train_lm_rank` of its smoke config."""
    out = {name: _train_case(mp, *case) for name, *case in cases}
    if kept_case is not None:
        out["kept"] = {hooks: _kept_gathered(mp, *kept_case, hooks)
                       for hooks in (True, False)}
    if launcher is not None:
        arch, mode, steps, batch, seq, seed = launcher
        out["launcher"] = TLT.train_lm_rank(mp, arch, 0, mode, steps, batch,
                                            seq, seed, True, 1e-3)
    return out


def zero3_train_rank(mp, cases, kept_cases=()) -> dict:
    """One rank of tests/test_torch_zero3.py: `_train_case` for each case
    (name, arch, mode, config overrides, params_np, batches, lr[,
    states]), and for each kept case (name, arch, overrides, params_np,
    batch) the gathered weights still alive after a "zero3" forward with
    and without `regather_saved` (`_kept_gathered`)."""
    out = {name: _train_case(mp, *case) for name, *case in cases}
    out["kept"] = {name: {hooks: _kept_gathered(mp, arch, "zero3", params_np,
                                                batch, hooks, overrides)
                          for hooks in (True, False)}
                   for name, arch, overrides, params_np, batch in kept_cases}
    return out


def _pass_counts(mp, fn):
    """fn() with this rank's collectives (calls and bytes put in by kind)
    and K8's calls counted: whole, and partials over a non-empty range
    (the card launches none for an empty one)."""
    whole, ranges = [], []
    undo, undo_k8 = _record_partials(ranges), _record_k8(whole)
    mp.reset_counts()
    try:
        out = fn()
    finally:
        undo()
        undo_k8()
    return out, dict(calls=dict(mp.calls), bytes=dict(mp.bytes),
                     k8=len(whole),
                     k8_partial=sum(hi > lo for lo, hi in ranges))


def pod_rank(mp, serve_cases=(), train_cases=()) -> dict:
    """One rank of tests/test_torch_pod_dryrun.py: the counts (`_pass_counts`)
    of every pass of each case, on random weights (what is counted does not
    depend on them). A serve case (name, arch, overrides, variant, batch,
    prompt, steps, max_len, enc_len): the arch's smoke config in float32
    with `overrides` under attn_shard=variant, its "tp" shard, the prefill
    of batch x prompt tokens (an encdec model's enc_len frames) into the
    cache of max_len positions, then `steps` decode steps. A train case
    (name, arch, overrides, mode, batch, seq): one Adam step under `mode`
    on the rank's rows of a batch x seq batch."""
    out = {}
    gen = torch.Generator().manual_seed(0)
    for name, arch, overrides, variant, b, s, steps, max_len, enc_len \
            in serve_cases:
        cfg = dataclasses.replace(smoke_cfg(arch), attn_shard=variant,
                                  **overrides)
        tmpl = Z.templates(cfg)
        shard = MB.materialize_shard(tmpl, gen, torch.float32,
                                     SH.param_layouts(tmpl, mp.mesh), mp)
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, s),
                                         generator=gen)}
        if enc_len:
            batch["frontend"] = torch.randn((b, enc_len, cfg.d_model),
                                            generator=gen)
        cache = E.init_cache(cfg, b, max_len, enc_len, device="cpu", mp=mp)
        (lg, cache), prefill = _pass_counts(
            mp, lambda: E.prefill(shard, cfg, batch, cache, mp))
        decode = []
        for i in range(steps):
            tok = lg[:, -1].argmax(-1)[:, None]
            (lg, cache), counts = _pass_counts(
                mp, lambda: E.decode_step(shard, cfg, tok, cache, s + i, mp))
            decode.append(counts)
        out[name] = dict(prefill=prefill, decode=decode)
    for name, arch, overrides, mode, b, s in train_cases:
        cfg = dataclasses.replace(smoke_cfg(arch), **overrides)
        tmpl = Z.templates(cfg)
        layout = TPAR.TrainLayout(mode, SH.param_layouts(tmpl, mp.mesh,
                                                         mode))
        shard = MB.materialize_shard(tmpl, gen, torch.float32, layout.specs,
                                     mp)
        opt = adam(1e-3)
        state = opt.init(shard)
        rows = TLT.batch_rows(TLT.lm_batch(cfg, np.random.default_rng(0), b,
                                           s, "cpu"), mp.mesh, mp.global_rank)
        _, counts = _pass_counts(mp, lambda: Z.train_step(
            shard, state, rows, cfg, opt.update, mp, layout))
        out[name] = dict(train=counts)
    return out


def zero3_serve_case(mp, cfg, params_np: dict, tokens, frontend, feed,
                     max_len: int) -> dict:
    """One rank serving cfg under "zero3" from the reference's numpy
    params, beside the same rank under "tp": each layout's shard and its
    gather back (bit for bit, per leaf), then for each layout the engine's
    prefill of the rank's rows of `tokens` (`launch.train.batch_rows`; an
    encdec model's `frontend` frames too) and a decode step per feed[i]
    (B, 1), each pass's collectives and K8 calls counted (`_pass_counts`),
    the logits and the cache after the last step kept, and how many bytes
    of gathered weights were alive at once at most (`_live_gathered`)."""
    full = Z.params_from_numpy(params_np, cfg, device="cpu")
    tmpl = Z.templates(cfg)
    batch = {"tokens": torch.as_tensor(tokens)}
    if frontend is not None:
        batch["frontend"] = torch.as_tensor(frontend)
    enc_len = frontend.shape[1] if cfg.arch_type == "encdec" else 0
    rows = TLT.batch_rows(batch, mp.mesh, mp.global_rank)
    b, s = rows["tokens"].shape
    n = len(feed)
    feed = [TLT.batch_rows({"tokens": torch.as_tensor(t)}, mp.mesh,
                           mp.global_rank)["tokens"] for t in feed]
    out = {}
    for mode in ("zero3", "tp"):
        layout = TPAR.TrainLayout(mode, SH.param_layouts(tmpl, mp.mesh, mode))
        shard = MB.shard_params(full, tmpl, layout.specs, mp)
        back = MB.gather_params(shard, tmpl, layout.specs, mp)
        round_trip = all(torch.equal(a, c) for a, c in
                         zip(MB.tree_leaves(back), MB.tree_leaves(full)))
        del back
        cache = E.init_cache(cfg, b, max_len, enc_len, device="cpu", mp=mp)
        live = _live_gathered(mp)
        (lg, cache), prefill = _pass_counts(
            mp, lambda: E.prefill(shard, cfg, rows, cache, mp, layout))
        step_logits, decode = [lg[:, -1]], []
        for i in range(n):
            (lg, cache), counts = _pass_counts(
                mp, lambda: E.decode_step(shard, cfg, feed[i], cache, s + i,
                                          mp, layout))
            step_logits.append(lg[:, -1])
            decode.append(counts)
        live.undo()
        out[mode] = dict(round_trip=round_trip, step_logits=step_logits,
                         cache=dict(cache), prefill=prefill, decode=decode,
                         live_gathered=live.peak,
                         state_bytes=sum(a.numel() * a.element_size()
                                         for a in MB.tree_leaves(shard)))
    return out


class _live_gathered:
    """Wraps mp.gather_axes to follow the bytes alive of the weights it
    gathers for use (over axes that include "data": not the logits'
    gather over "model"), and `peak`, the most alive at once (the
    backward's gathers included); `undo()` restores it."""

    def __init__(self, mp):
        import weakref
        self.mp, self.live, self.peak = mp, 0, 0
        orig = self.orig = mp.gather_axes

        def counted(x, dim, axes):
            out = orig(x, dim, axes)
            if out is not x and "data" in axes:
                n = out.untyped_storage().nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(out.untyped_storage(), self._free, n)
            return out

        mp.gather_axes = counted

    def _free(self, n):
        self.live -= n

    def undo(self):
        self.mp.gather_axes = self.orig


def zero3_serve_rank(mp, cases) -> dict:
    """One rank of tests/test_torch_zero3_serve.py: `zero3_serve_case` for
    each case (name, arch, ssm_impl, params_np, tokens, frontend, feed,
    max_len), the arch's smoke config in float32."""
    return {name: zero3_serve_case(
        mp, dataclasses.replace(smoke_cfg(arch), ssm_impl=impl), params_np,
        tokens, frontend, feed, max_len)
        for name, arch, impl, params_np, tokens, frontend, feed, max_len
        in cases}


def _counted_checkpoints() -> tuple[list, callable]:
    """Count the blocks that enter `torch.utils.checkpoint.checkpoint`
    (zoo's remat); returns (the count, a list that grows by one a call;
    the undo)."""
    entries, orig = [], torch.utils.checkpoint.checkpoint

    def counted(*args, **kw):
        entries.append(1)
        return orig(*args, **kw)

    torch.utils.checkpoint.checkpoint = counted
    return entries, lambda: setattr(torch.utils.checkpoint, "checkpoint",
                                    orig)


def _route_record(routes: list):
    """Wrap `layers.moe_route` to record each call's gate_i with whether a
    remat's recompute made it (`layers.recomputing`); returns the undo."""
    orig = Lyr.moe_route

    def recorded(p, cfg, xt):
        out = orig(p, cfg, xt)
        routes.append((out[2].clone(), Lyr.recomputing()))
        return out

    Lyr.moe_route = recorded
    return lambda: setattr(Lyr, "moe_route", orig)


def remat_rank(mp, cases) -> dict:
    """One rank of tests/test_torch_remat.py: for each case (name, arch,
    mode, overrides, params_np, batch, lr), the arch's smoke config in
    float32 with `overrides`, its shard under `mode` and one Adam step on
    the rank's rows of batch, once under remat and once with the test
    seam `zoo._REMAT` off, from the same shard and state: the loss, step
    1's m gathered (rank 0), whether the two steps' losses, params, m and
    v are equal bit for bit, the checkpoint entries, the collectives of
    each step and the moe layers' expert choices of the rematted one
    (gate_i, made by a recompute)."""
    out = {}
    for name, arch, mode, overrides, params_np, batch, lr in cases:
        cfg = dataclasses.replace(smoke_cfg(arch), **overrides)
        tmpl = Z.templates(cfg)
        layout = TPAR.TrainLayout(mode, SH.param_layouts(tmpl, mp.mesh,
                                                         mode))
        shard = MB.shard_params(Z.params_from_numpy(params_np, cfg,
                                                    device="cpu"),
                                tmpl, layout.specs, mp)
        rows = TLT.batch_rows({k: torch.as_tensor(v)
                               for k, v in batch.items()}, mp.mesh,
                              mp.global_rank)
        opt = adam(lr)
        runs = {}
        for remat in (True, False):
            state = opt.init(shard)
            routes = []
            entries, undo = _counted_checkpoints()
            undo_routes = _route_record(routes)
            Z._REMAT = remat
            mp.reset_counts()
            try:
                runs[remat] = (*Z.train_step(shard, state, rows, cfg,
                                             opt.update, mp, layout),
                               dict(mp.calls), len(entries), routes)
            finally:
                Z._REMAT = True
                undo_routes()
                undo()
        (p1, s1, l1, c1, e1, r1), (p0, s0, l0, c0, e0, _) = (runs[True],
                                                            runs[False])
        trees = [(p1, p0), (s1["m"], s0["m"]), (s1["v"], s0["v"])]
        equal = bool(torch.equal(l1, l0)) and all(
            torch.equal(a, b) for t1, t0 in trees
            for a, b in zip(MB.tree_leaves(t1), MB.tree_leaves(t0)))
        m1 = MB.gather_params(s1["m"], tmpl, layout.specs, mp)
        out[name] = dict(
            loss=float(l1), equal=equal, entries=(e1, e0),
            calls=(c1, c0),
            m1=[a.numpy() for a in MB.tree_leaves(m1)]
            if mp.global_rank == 0 else None,
            routes=[(g.numpy(), again) for g, again in r1])
    return out
