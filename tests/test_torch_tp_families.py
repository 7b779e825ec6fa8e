"""The port's "tp" serving of the ssm (rwkv6), hybrid (zamba2) and encdec
(seamless) families on two gloo ranks on the CPU, against the
reference's unsharded runs on the same numpy params: RWKV-6's heads and
channel-mix ffn, Mamba2's heads and zamba2's shared block, seamless's
encoder and decoder (self and cross attention, the MLP) over the ranks;
rwkv6 and zamba2 in both ssm_impl forms; a vocabulary the ranks do not
divide (seamless-smoke and gemma3-smoke at vocab 511), kept whole on
every rank. One spawn for every case (`launch.mesh.spawn_ranks`); the
rank function is `torch_tp_ranks.family_rank`.

The reference's params come from its own `materialize`; every leaf the
templates initialise to zeros or ones then gets 0.1 N(0, 1) numpy noise
(tests/test_torch_ssm.py's `ssm_model`), so the LoRA, bonus, shift and
norm paths are not trivial.

Tolerances (tests/test_torch_ssm.py's): logits LOGIT_TOL 2e-4, greedy
tokens exact where the reference's top-2 margin exceeds twice that,
recurrent states and cache leaves 2e-5; shards gather back bit for bit
(Mamba2's head-aligned in_proj / conv_w / conv_b included), and every
rank holds the same bits after every all-reduce.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import zoo as JZ
from repro.serving import engine as JE
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import model_mesh, spawn_ranks
from repro_torch.models import base as MB
from repro_torch.models import zoo as TZ
from repro_torch.models import parallel as TPAR
from repro_torch.serving import engine as TE
from torch_parity import close, perturbed_model, token_batch
import torch_tp_ranks

WORLD = 2
LOGIT_TOL = 2e-4
STATE_TOL = 2e-5
NOISE = 0.1
PROMPT, STEPS, BATCH = 40, 8, 2     # two rwkv chunks; gemma3's rings wrap
# name -> (arch, ssm_impl, vocab or None for the config's)
CASES = {
    "rwkv6-scan": ("rwkv6-1.6b", "scan", None),
    "rwkv6-chunked": ("rwkv6-1.6b", "chunked", None),
    "zamba2-scan": ("zamba2-1.2b", "scan", None),
    "zamba2-chunked": ("zamba2-1.2b", "chunked", None),
    "seamless": ("seamless-m4t-large-v2", "scan", None),
    "seamless-vocab511": ("seamless-m4t-large-v2", "scan", 511),
    "gemma3-vocab511": ("gemma3-27b", "scan", 511),
}
HEAD_CUT = ("wkv", "ssm", "attn_k", "attn_v", "k", "v", "cross_k", "cross_v",
            "gk", "gv", "lk", "lv", "tlk", "tlv")

_decode = jax.jit(JE.decode_step, static_argnums=(1,))


def _serve(jp, jcfg, jb, max_len, enc_len):
    """The reference's prefill and STEPS greedy decode steps: each step's
    last-position logits, the tokens it fed, its cache after the prefill
    and after the last step."""
    jc = JE.init_cache(jcfg, BATCH, max_len, enc_len)
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    after_prefill = {k: np.asarray(v) for k, v in jc.items()}
    logits, fed = [np.asarray(jl[:, -1])], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        fed.append(tok)
        jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(PROMPT + i))
        logits.append(np.asarray(jl[:, -1]))
    return logits, fed, after_prefill, {k: np.asarray(v)
                                        for k, v in jc.items()}


@pytest.fixture(scope="module")
def runs():
    """Per case: the reference's forward and engine run, and the two
    ranks' results (one spawn for every case)."""
    refs, cases = {}, []
    for name, (arch, impl, vocab) in CASES.items():
        jcfg, jp = perturbed_model(arch, impl, vocab, noise=NOISE)
        jb, tb = token_batch(jcfg, BATCH, PROMPT, seed=7)
        enc_len = tb["frontend"].shape[1] if "frontend" in tb else 0
        max_len = PROMPT + STEPS + 1
        want, _ = JZ.forward(jp, jcfg, jb)
        steps, fed, prefill_cache, cache = _serve(jp, jcfg, jb, max_len,
                                                  enc_len)
        refs[name] = dict(logits=np.asarray(want), steps=steps,
                          prefill_cache=prefill_cache, cache=cache)
        cases.append((name, arch, impl, vocab, jax.device_get(jp),
                      tb["tokens"].numpy(),
                      tb["frontend"].numpy() if enc_len else None, fed,
                      max_len))
    ranks = spawn_ranks(WORLD, torch_tp_ranks.family_rank, (cases,),
                        device="cpu", timeout_s=300)
    for name, ref in refs.items():
        ref["ranks"] = [rank[name] for rank in ranks]
        arch, impl, vocab = CASES[name]
        cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                                  ssm_impl=impl)
        ref["cfg"] = dataclasses.replace(cfg, vocab=vocab) if vocab else cfg
    return refs


@pytest.mark.parametrize("name", CASES)
def test_families_shards_gather_back_bit_for_bit(runs, name):
    """Every leaf's shard gathers back to the reference's leaf bit for bit;
    zamba2's in_proj / conv_w / conv_b hold the head-aligned pieces
    (`parallel.mamba_pieces`), an undivided vocabulary stays whole."""
    r = runs[name]
    cfg = r["cfg"]
    tmpl = list(MB.tree_leaves(TZ.templates(cfg)))
    for rank in r["ranks"]:
        assert all(rank["round_trip"]), name
        shapes = dict(zip((t.axes for t in tmpl), rank["shard_shapes"]))
        assert shapes[("vocab", "embed")][0] == (
            cfg.vocab // WORLD if cfg.vocab % WORLD == 0 else cfg.vocab)
    if cfg.arch_type == "hybrid":
        di, n, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        by_path = dict(zip(_paths(TZ.templates(cfg)),
                           r["ranks"][0]["shard_shapes"]))
        L = cfg.n_layers
        assert by_path["blocks/mixer/in_proj"] == (
            L, cfg.d_model, 2 * di // WORLD + 2 * n + nh // WORLD)
        assert by_path["blocks/mixer/conv_w"] == (L, cfg.ssm_conv,
                                                  di // WORLD + 2 * n)
        assert by_path["blocks/mixer/conv_b"] == (L, di // WORLD + 2 * n)
        assert by_path["blocks/mixer/out_proj"] == (L, di // WORLD,
                                                    cfg.d_model)
        assert by_path["blocks/mixer/D"] == (L, nh)


def _paths(tree, prefix=""):
    """The leaves' paths in tree_leaves order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1]


@pytest.mark.parametrize("name", CASES)
def test_families_forward_matches_the_reference(runs, name):
    r = runs[name]
    for rank in r["ranks"]:
        close(rank["logits"], r["logits"], LOGIT_TOL, LOGIT_TOL)


@pytest.mark.parametrize("name", CASES)
def test_families_prefill_and_decode_match_the_reference(runs, name):
    r = runs[name]
    checked = 0
    for rank in r["ranks"]:
        assert len(rank["step_logits"]) == STEPS + 1
        for got, want in zip(rank["step_logits"], r["steps"]):
            close(got, want, LOGIT_TOL, LOGIT_TOL)
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL
            np.testing.assert_array_equal(got.argmax(-1)[sure],
                                          want.argmax(-1)[sure])
            checked += int(sure.sum())
    assert checked > 0


def _want_part(cfg, key, leaf, rank_id):
    """The part of the reference's whole cache leaf `leaf` that rank
    rank_id holds: its heads (the reference's cut) for the K/V and state
    leaves, the x channels of its heads and B / C whole for "conv", the
    whole leaf for the shifts."""
    if key in ("tm_shift", "cm_shift"):
        return leaf
    if key == "conv":
        pieces = TPAR.mamba_pieces(cfg.ssm_d_inner, cfg.ssm_state,
                                   cfg.ssm_heads, WORLD, rank_id)["conv"]
        return np.concatenate([leaf[..., s:s + m] for s, m in pieces], -1)
    assert key in HEAD_CUT, key
    spec = SH.cache_layouts({key: leaf.shape}, model_mesh(WORLD))[key]
    assert "model" in spec, (key, spec)
    cut = TPAR.local_slices(leaf.shape, spec, model_mesh(WORLD), rank_id)
    return leaf[tuple(slice(s, s + m) for s, m in cut)]


@pytest.mark.parametrize("when", ["prefill_cache", "cache"])
@pytest.mark.parametrize("name", CASES)
def test_families_cache_holds_each_ranks_part(runs, name, when):
    """After the prefill and after the last decode step, every cache leaf
    of each rank is its part of the reference's (`_want_part`), and its
    shape is `engine.local_cache_shapes`'s."""
    r = runs[name]
    cfg = r["cfg"]
    enc_len = r["cache"].get("cross_k", np.zeros((0, 0, 0))).shape[2]
    local = TE.local_cache_shapes(cfg, BATCH, PROMPT + STEPS + 1,
                                  _rank(1), enc_len)
    assert set(local) == set(r[when])
    for key, leaf in r[when].items():
        for rank_id, rank in enumerate(r["ranks"]):
            got = rank[when][key]
            want = _want_part(cfg, key, leaf, rank_id)
            assert got.shape == want.shape == local[key][0], key
            close(got, want, STATE_TOL, STATE_TOL)


def _rank(r: int) -> TPAR.ModelParallel:
    """A rank's view without a process group (the cache layout runs no
    collective)."""
    return TPAR.ModelParallel(rank=r, world=WORLD, mesh=model_mesh(WORLD),
                              backend="gloo")


@pytest.mark.parametrize("name", CASES)
def test_families_ranks_hold_equal_bits_after_every_all_reduce(runs, name):
    ranks = runs[name]["ranks"]
    assert ranks[0]["digests"] and ranks[0]["digests"] == ranks[1]["digests"]
    np.testing.assert_array_equal(ranks[0]["logits"], ranks[1]["logits"])
    for a, b in zip(ranks[0]["step_logits"], ranks[1]["step_logits"]):
        np.testing.assert_array_equal(a, b)


def expected_calls(cfg, mode: str) -> dict[str, int]:
    """The collectives of one pass ("forward", "prefill" or one "decode"
    step) of cfg under "tp": one all-reduce per row-parallel output
    projection (RWKV-6's time-mix wo and channel-mix wv, Mamba2's out_proj,
    attention's and the MLP's wo, seamless's cross attention's wo), one
    per Mamba2 out_norm, one all-gather per RWKV-6 channel mix; with the
    vocabulary cut, one all-reduce for the embedding and one all-gather of
    the logits. A decode step runs no encoder."""
    cut = cfg.vocab % WORLD == 0
    L = cfg.n_layers
    if cfg.arch_type == "ssm":
        sums, gathers = 2 * L, L
    elif cfg.arch_type == "hybrid":
        sums, gathers = 2 * L + 2 * TZ.shared_applications(cfg), 0
    elif cfg.arch_type == "encdec":
        sums = 3 * L + (2 * cfg.n_enc_layers if mode != "decode" else 0)
        gathers = 0
    else:
        sums, gathers = 2 * L, 0
    want = {"all_reduce_sum": sums + cut, "all_gather": gathers + cut}
    return {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("name", CASES)
def test_families_collectives_per_pass(runs, name):
    r = runs[name]
    cfg = r["cfg"]
    for rank in r["ranks"]:
        assert rank["calls"]["forward"] == expected_calls(cfg, "forward")
        assert rank["calls"]["prefill"] == expected_calls(cfg, "prefill")
        assert rank["calls"]["decode"] == {
            k: v * STEPS for k, v in expected_calls(cfg, "decode").items()}

