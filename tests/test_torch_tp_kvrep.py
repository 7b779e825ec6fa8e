"""The port's "tp" serving where the ranks do not divide the kv heads
(`models/parallel.py` `kv_heads`): each rank holds whole the kv heads its
query heads read, so a kv head sits on several ranks, where the
reference's rules cut wk / wv and the cache within a head. Four gloo
ranks on the CPU against the reference's unsharded runs on the same numpy
params: starcoder2-smoke (4 query / 2 kv heads: 1 / 1 a rank, ranks 0-1
holding kv head 0 and ranks 2-3 kv head 1), gemma3-smoke (its rings wrap)
under "auto", "seqkv" (every leaf cut over its slots, M = 52) and "shmap"
(M = 49: the global leaves keep the rank's kv heads, the rings are cut
over their slots) and dbrx-smoke (1 expert a rank). One spawn
(`launch.mesh.spawn_ranks`, `torch_tp_ranks.kvrep_rank`) for every case.

Tolerances (tests/test_torch_tp.py's): logits rtol 1e-5 / atol 2e-4,
greedy tokens exact where the reference's top-2 margin exceeds 4e-4,
expert choices exact where the k-th and (k+1)-th router log-probabilities
are more than ROUTE_MARGIN apart, cache contents 1e-5; shards gather back
bit for bit, and every rank holds the same bits after every all-reduce.
"shmap" crosses bfloat16 wires (its attention combine over fresh keys, as
the reference's `shmap_attention`), so it is held to the unsharded
reference at tests/test_torch_seq.py's bar for that variant: one
bfloat16 unit of the largest value, greedy tokens where the margin
exceeds twice that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import zoo as JZ
from repro.serving import engine as JE
from repro_torch import configs as CFG
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import model_mesh, spawn_ranks
from repro_torch.models import base as MB
from repro_torch.models import zoo as TZ
from repro_torch.models import parallel as TPAR
from repro_torch.models.parallel import ModelParallel, check_tp
from repro_torch.serving import engine as TE
from torch_parity import close, dense_model, n, token_batch
import torch_tp_ranks

WORLD = 4
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-4
TOKEN_MARGIN = 4e-4
CACHE_TOL = 1e-5
AUX_TOL = 1e-6
ROUTE_MARGIN = 1e-3
BF16_UNIT = 2.0 ** -7
PROMPT, STEPS, BATCH = 40, 8, 2           # gemma3-smoke's window is 32
# name: (arch, attn_shard, max_len)
CASES = {
    "starcoder2": ("starcoder2-3b", "auto", PROMPT + STEPS + 1),
    "gemma3": ("gemma3-27b", "auto", PROMPT + STEPS + 1),
    "gemma3-seqkv": ("gemma3-27b", "seqkv", 52),
    "gemma3-shmap": ("gemma3-27b", "shmap", 49),
    "dbrx": ("dbrx-132b", "auto", PROMPT + STEPS + 1),
}
KVREP_ARCHS = ("starcoder2-3b", "gemma3-27b", "dbrx-132b")

_decode = jax.jit(JE.decode_step, static_argnums=(1,))


def _reference(jp, jcfg, jb, max_len):
    """The reference's unsharded forward (each moe layer's router
    probabilities recorded through a debug callback: its forward scans
    the layers) and engine: prefill, then STEPS greedy decode steps."""
    probs, moe_ffn = [], JL.moe_ffn

    def recorded(p, cfg, x):
        logits = (x.reshape(-1, x.shape[-1]) @ p["router"]).astype(
            jnp.float32)
        jax.debug.callback(lambda a: probs.append(np.asarray(a)),
                           jax.nn.softmax(logits, axis=-1), ordered=True)
        return moe_ffn(p, cfg, x)

    JL.moe_ffn = recorded
    try:
        fwd, aux = JZ.forward(jp, jcfg, jb)
        fwd, aux = np.asarray(fwd), float(aux)
        jax.effects_barrier()
    finally:
        JL.moe_ffn = moe_ffn
    jc = JE.init_cache(jcfg, BATCH, max_len)
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    logits, fed = [np.asarray(jl[:, -1])], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        fed.append(tok)
        jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(PROMPT + i))
        logits.append(np.asarray(jl[:, -1]))
    return dict(forward=fwd, aux=aux, probs=probs, steps=logits, fed=fed,
                cache={k: np.asarray(v) for k, v in jc.items()})


@pytest.fixture(scope="module")
def runs():
    """Per case: the reference's unsharded runs and the four ranks'."""
    refs, cases = {}, []
    models = {arch: dense_model(arch) for arch in KVREP_ARCHS}
    for name, (arch, variant, max_len) in CASES.items():
        jcfg, _, jp, _ = models[arch]
        jb, tb = token_batch(jcfg, BATCH, PROMPT, seed=7)
        refs[name] = _reference(jp, jcfg, jb, max_len)
        cases.append((name, arch, variant, jax.device_get(jp),
                      n(tb["tokens"]), refs[name]["fed"], max_len))
    ranks = spawn_ranks(WORLD, torch_tp_ranks.kvrep_rank, (cases,),
                        device="cpu", timeout_s=300)
    return {name: dict(ref=refs[name], ranks=[r[name] for r in ranks])
            for name in CASES}


def _cfg(name):
    arch, variant, _ = CASES[name]
    return dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                               attn_shard=variant)


def _bars(name, want) -> tuple[float, float]:
    """(rtol, atol) of a case's logits or cache against `want`."""
    if CASES[name][1] == "shmap":
        return 0.0, BF16_UNIT * float(np.abs(want).max(initial=0.0))
    return LOGIT_RTOL, LOGIT_ATOL


def test_the_cases_leave_the_kv_heads_undivided():
    for name in CASES:
        cfg = _cfg(name)
        assert cfg.n_kv_heads % WORLD and cfg.n_heads % WORLD == 0
        assert TPAR.kv_heads(cfg.n_heads, cfg.n_kv_heads, WORLD, 0) == [0]
        assert TPAR.kv_heads(cfg.n_heads, cfg.n_kv_heads, WORLD, 3) == [1]


@pytest.mark.parametrize("name", list(CASES))
def test_kvrep_shards_gather_back_bit_for_bit(runs, name):
    """Every leaf gathers back bit for bit; wk / wv hold one whole kv
    head's columns on each rank."""
    cfg = _cfg(name)
    tmpl = TZ.templates(cfg)
    axes = [t.axes for t in MB.tree_leaves(tmpl)]
    for rank in runs[name]["ranks"]:
        assert all(rank["round_trip"]), name
        for a, shape in zip(axes, rank["shard_shapes"]):
            if a[-1] == "kvout":
                assert shape[-1] == cfg.hd
            if a[-1] == "qout":
                assert shape[-1] == cfg.n_heads * cfg.hd // WORLD


@pytest.mark.parametrize("name", list(CASES))
def test_kvrep_forward_matches_the_reference(runs, name):
    r = runs[name]
    for rank in r["ranks"]:
        close(rank["logits"], r["ref"]["forward"],
              *_bars(name, r["ref"]["forward"]))
        assert abs(float(rank["aux"]) - r["ref"]["aux"]) <= AUX_TOL


def test_kvrep_expert_choices_match_the_reference(runs):
    """dbrx-smoke's forward: every rank's router probabilities per layer
    within 1e-5 of the reference's, and each token's top-k experts the
    reference's wherever its k-th and (k+1)-th log-probabilities are more
    than ROUTE_MARGIN apart."""
    r = runs["dbrx"]
    k = _cfg("dbrx").top_k
    want = r["ref"]["probs"]
    assert len(want) == _cfg("dbrx").n_layers
    compared = 0
    for rank in r["ranks"]:
        assert len(rank["routes"]) == len(want)
        for (probs, gate_i), w in zip(rank["routes"], want):
            close(probs, w, 1e-5, 1e-5)
            logs = np.log(np.maximum(w, 1e-30))
            top = -np.sort(-logs, axis=-1)
            sure = top[:, k - 1] - top[:, k] > ROUTE_MARGIN
            w_i = np.argsort(-w, axis=-1, kind="stable")[:, :k]
            np.testing.assert_array_equal(np.sort(gate_i[sure], -1),
                                          np.sort(w_i[sure], -1))
            compared += int(sure.sum())
    assert compared > 0


@pytest.mark.parametrize("name", list(CASES))
def test_kvrep_prefill_and_decode_match_the_reference(runs, name):
    r = runs[name]
    checked = 0
    for rank in r["ranks"]:
        assert len(rank["step_logits"]) == STEPS + 1
        for got, want in zip(rank["step_logits"], r["ref"]["steps"]):
            rtol, atol = _bars(name, want)
            close(got, want, rtol, atol)
            margin = 2 * atol if CASES[name][1] == "shmap" else TOKEN_MARGIN
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > margin
            np.testing.assert_array_equal(got.argmax(-1)[sure],
                                          want.argmax(-1)[sure])
            checked += int(sure.sum())
    assert checked > 0


def _seq_leaves(name) -> dict[str, bool]:
    """Leaf -> cut over its slots (the "seq" policy where the ranks divide
    the leaf's slots; never under "auto")."""
    _, variant, max_len = CASES[name]
    if variant == "auto":
        return {k: False for k in TE.cache_shapes(_cfg(name), BATCH,
                                                  max_len)}
    lay = SH.cache_layouts(TE.cache_shapes(_cfg(name), BATCH, max_len),
                           model_mesh(WORLD), policy="seq")
    return {k: s[-3] == "model" for k, s in lay.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_kvrep_cache_holds_the_kv_heads_each_rank_reads(runs, name):
    """Each rank's cache after prefill and the decode steps is its part of
    the reference's: the kv head its query heads read, whole (ranks 0-1
    kv head 0, ranks 2-3 kv head 1), or under the "seq" policy a block of
    the slots with every kv head where the ranks divide them."""
    r = runs[name]
    cfg = _cfg(name)
    seq = _seq_leaves(name)
    if CASES[name][1] == "seqkv":
        assert all(seq.values())
    if CASES[name][1] == "shmap":
        assert not seq["gk"] and seq["lk"]
    if cfg.sliding_window:
        assert PROMPT + STEPS > cfg.sliding_window      # the rings wrapped
    for key, want in r["ref"]["cache"].items():
        for rank_id, rank in enumerate(r["ranks"]):
            got = rank["cache"][key]
            if seq[key]:
                nb = want.shape[-3] // WORLD
                part = want[..., rank_id * nb:(rank_id + 1) * nb, :, :]
            else:
                heads = TPAR.kv_heads(cfg.n_heads, cfg.n_kv_heads, WORLD,
                                      rank_id)
                part = want[..., heads, :]
            assert got.shape == part.shape, (key, rank_id)
            if CASES[name][1] == "shmap":
                close(got, part, *_bars(name, want))
            else:
                close(got, part, CACHE_TOL, CACHE_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_kvrep_ranks_hold_equal_bits_after_every_all_reduce(runs, name):
    ranks = runs[name]["ranks"]
    assert ranks[0]["digests"]
    for rank in ranks[1:]:
        assert rank["digests"] == ranks[0]["digests"]
        np.testing.assert_array_equal(rank["logits"], ranks[0]["logits"])
        for a, b in zip(rank["step_logits"], ranks[0]["step_logits"]):
            np.testing.assert_array_equal(a, b)


def _want_calls(name, part) -> dict[str, int]:
    """The divided case's collectives of a forward, a prefill or the
    decode steps (tests/test_torch_tp.py, tests/test_torch_seq.py): the
    embedding's all-reduce and the head's all-gather, two all-reduces a
    layer; under the "seq" policy, per layer, over fresh keys through
    shmap_attention an all-gather of q / k / v, a max and the combine's
    sum (two with "shmap"'s bf16 wire), a prefill into a leaf cut over its
    slots an all-gather of k / v, a decode step there the gather, a max
    and one packed sum."""
    cfg = _cfg(name)
    _, variant, _ = CASES[name]
    steps = STEPS if part == "decode" else 1
    want = {"all_reduce_sum": 1 + 2 * cfg.n_layers, "all_gather": 1,
            "all_reduce_max": 0}
    if variant != "auto":
        seq = _seq_leaves(name)
        for i in range(cfg.n_layers):
            ring = not cfg.is_global_layer(i)
            leaf = "lk" if ring else "gk"
            if PROMPT % WORLD == 0 and (part == "forward" or (
                    part == "prefill" and variant == "shmap" and not ring)):
                want["all_gather"] += 1
                want["all_reduce_max"] += 1
                want["all_reduce_sum"] += 2 if variant == "shmap" else 1
            elif part == "prefill" and seq[leaf]:
                want["all_gather"] += 1
            if part == "decode" and seq[leaf]:
                want["all_gather"] += 1
                want["all_reduce_max"] += 1
                want["all_reduce_sum"] += 1
    return {k: v * steps for k, v in want.items() if v}


@pytest.mark.parametrize("name", list(CASES))
def test_kvrep_collectives_per_pass_are_the_divided_cases(runs, name):
    """Holding a kv head on several ranks adds no collective."""
    for rank in runs[name]["ranks"]:
        for part in ("forward", "prefill", "decode"):
            assert rank["calls"][part] == _want_calls(name, part), part


# ---------------------------------------------------------------------------
# No spawn: the layout of the kv heads, the shards, the cache shapes
# ---------------------------------------------------------------------------

def _rank(r: int, world: int) -> ModelParallel:
    return ModelParallel(rank=r, world=world, mesh=model_mesh(world),
                         backend="gloo")


@pytest.mark.parametrize("h,hkv,world,want", [
    (24, 2, 4, [[0], [0], [1], [1]]),                 # starcoder2-3b
    (32, 8, 16, [[r // 2] for r in range(16)]),       # qwen3-8b
    (48, 8, 16, [[r // 2] for r in range(16)]),       # dbrx-132b
    (32, 16, 4, [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11],
                 [12, 13, 14, 15]]),                  # gemma3-27b: divided
    (24, 2, 3, [[0, 0], [0, 1], [1, 1]]),             # rep = gcd(12, 8)
    (56, 8, 14, [[(4 * r + j) // 7 for j in range(4)] for r in range(14)]),
])
def test_kv_heads_are_those_the_ranks_query_heads_read(h, hkv, world, want):
    """A rank's local query head j reads its local kv head j // rep, rep
    = gcd(h / hkv, h / world): the kv head its global query head reads in
    the reference's GQA; `kv_gather_index` takes the ranks' kv heads laid
    side by side to the model's, each once."""
    got = [TPAR.kv_heads(h, hkv, world, r) for r in range(world)]
    assert got == want
    hl, group = h // world, h // hkv
    for r, held in enumerate(got):
        rep = hl // len(held)
        for j in range(hl):
            assert held[j // rep] == (r * hl + j) // group
    pick = TPAR.kv_gather_index(h, hkv, world)
    flat = [j for held in got for j in held]
    if hkv % world == 0:
        assert pick is None
    else:
        assert [flat[i] for i in pick] == list(range(hkv))


def test_check_tp_accepts_undivided_kv_heads_where_the_query_heads_divide():
    """starcoder2-3b and every 2-kv-head smoke config of the dense and moe
    families at 4 ranks, qwen3-8b / dbrx-132b / pixtral-12b at 16. Since
    the ranks may split the query heads (tests/test_torch_tp_qsplit.py)
    and a cache leaf carries its layout as a tag, two counts this check
    refused run too: 56 query heads at 16 ranks (yi-34b, arctic-480b)
    and a rank holding every kv head (starcoder2-3b's 24 / 2 heads over
    3 ranks). Still refused: wq's H·hd columns undivided (yi-34b at 3
    ranks), an undivided ffn or expert count, the hybrid / encdec / ssm
    families where the ranks do not divide their heads."""
    check_tp(CFG.get("starcoder2-3b"), 4)
    for arch in ("qwen3-8b", "dbrx-132b", "pixtral-12b"):
        check_tp(CFG.get(arch), 16)
    for arch in ("starcoder2-3b", "gemma3-27b", "qwen3-8b", "yi-34b",
                 "pixtral-12b", "dbrx-132b", "arctic-480b"):
        cfg = CFG.get_smoke(arch)
        assert cfg.n_kv_heads == 2 and cfg.arch_type in ("dense", "moe")
        check_tp(cfg, 4)
        for variant in ("seqkv", "shmap"):
            check_tp(dataclasses.replace(cfg, attn_shard=variant), 4)
    for arch in ("yi-34b", "arctic-480b"):
        check_tp(CFG.get(arch), 16)
    check_tp(CFG.get("starcoder2-3b"), 3)
    assert TPAR.kv_heads(24, 2, 3, 1) == [0, 1]
    with pytest.raises(ValueError, match=r"over 3 ranks.*'qout': 7168"):
        check_tp(CFG.get("yi-34b"), 3)
    with pytest.raises(ValueError, match=r"'ffn': 12290"):
        check_tp(dataclasses.replace(CFG.get("starcoder2-3b"), d_ff=12290),
                 4)
    with pytest.raises(ValueError, match=r"'experts': 16"):
        check_tp(dataclasses.replace(CFG.get("dbrx-132b"), n_heads=64),
                 32)
    for arch in ("zamba2-1.2b", "seamless-m4t-large-v2", "rwkv6-1.6b"):
        with pytest.raises(ValueError, match="'heads'"):
            check_tp(CFG.get_smoke(arch), 16)
    for arch in ("zamba2-1.2b", "seamless-m4t-large-v2"):
        cfg = dataclasses.replace(CFG.get_smoke(arch), n_kv_heads=2)
        with pytest.raises(ValueError, match=r"\{'kv heads': 2\}"):
            check_tp(cfg, 4)


@pytest.mark.parametrize("arch", KVREP_ARCHS)
def test_kvrep_shards_and_materialize_shard(arch, monkeypatch):
    """At 4 ranks each rank's wk / wv are the columns of its kv head,
    whole; `materialize_shard` equals `shard_params` of the whole draw bit
    for bit, with the draw cut into slices of ~1000 floats."""
    monkeypatch.setattr(MB, "_DRAW_CHUNK", 1000)
    cfg = torch_tp_ranks.smoke_cfg(arch)
    tmpl = TZ.templates(cfg)
    full = MB.materialize(tmpl, torch.Generator().manual_seed(2),
                          torch.bfloat16)
    layout = SH.param_layouts(tmpl, model_mesh(WORLD), "tp")
    hd = cfg.hd
    for r in range(WORLD):
        mp = _rank(r, WORLD)
        want = MB.shard_params(full, tmpl, layout, mp)
        got = MB.materialize_shard(tmpl, torch.Generator().manual_seed(2),
                                   torch.bfloat16, layout, mp)
        for a, b in zip(MB.tree_leaves(got), MB.tree_leaves(want)):
            assert torch.equal(a, b)
        (kv,) = TPAR.kv_heads(cfg.n_heads, cfg.n_kv_heads, WORLD, r)
        for key in ("wk", "wv"):
            assert torch.equal(want["blocks"]["attn"][key],
                               full["blocks"]["attn"][key][
                                   ..., kv * hd:(kv + 1) * hd])


@pytest.mark.parametrize("arch", KVREP_ARCHS)
def test_local_cache_shapes_hold_whole_the_kv_heads_a_rank_reads(arch):
    """Under "heads" a K/V leaf holds the one kv head a rank's query heads
    read, (..., S, 1, hd), where the reference's rule, finding 2 kv heads
    undivided by 4 ranks, cuts hd (a within-head split, (..., S, 2, hd /
    4)); init_cache makes that shape."""
    cfg = torch_tp_ranks.smoke_cfg(arch)
    full = TE.cache_shapes(cfg, 2, 48)
    layouts = SH.cache_layouts(full, model_mesh(WORLD), policy="heads")
    for r in range(WORLD):
        local = TE.local_cache_shapes(cfg, 2, 48, _rank(r, WORLD))
        assert set(local) == set(full)
        for k, (shape, dt) in full.items():
            assert local[k] == (shape[:-2] + (1, shape[-1]), dt)
            assert tuple(m for _, m in TPAR.local_slices(
                shape, layouts[k], model_mesh(WORLD), r)) \
                == shape[:-1] + (shape[-1] // WORLD,)
    cache = TE.init_cache(cfg, 2, 48, device="cpu", mp=_rank(3, WORLD))
    assert {k: (tuple(t.shape), t.dtype) for k, t in cache.items()} \
        == TE.local_cache_shapes(cfg, 2, 48, _rank(3, WORLD))
