"""The port's sequence-sharded serving (cfg.attn_shard "seqkv" / "shmap",
the "seq" cache layout) of the hybrid (zamba2) and encdec (seamless)
families on two gloo ranks on the CPU, against the reference on the same
numpy params: zamba2's shared-block cache attn_k / attn_v, seamless's self
K/V and its cross K/V cut over their slots (the encoder frames), each
decode attending through K8's partials mode over the rank's block and the
ranks' states combined in float32 (`layers.seq_decode_attention`);
seamless's encoder, with no cache, through `shmap_attention` where the
ranks divide its frames.

The params are the reference's smoke `materialize` with every zero- or
one-initialised leaf perturbed by 0.1 N(0, 1) (`torch_parity
.perturbed_model`, tests/test_torch_tp_families.py's). Each case: the
forward, then a prefill of PROMPT tokens and STEPS decode steps fed the
reference's greedy tokens. "seqkv" is held to the reference's unsharded
engine at tests/test_torch_seq.py's float32 bars (logits rtol 1e-5 / atol
2e-4, greedy tokens exact where the top-2 margin exceeds 4e-4, cache
1e-5); "shmap" to the reference's engine run under attn_shard="shmap" on a
(data 1, model 2) mesh of two host devices in a subprocess
(`XLA_FLAGS=--xla_force_host_platform_device_count=2`, `with mesh:` +
`jax.jit`, as test_torch_seq.py), at one bfloat16 unit of the largest
value (its bf16 combine wire, test_torch_seq.py's reasoning). Every case
also checks each rank's cache against the reference's cut by
`cache_layouts(policy="seq")`, equal logits bits on the ranks, the
collectives of each pass by kind (`_want_calls`), and the (lo, hi) of
each partials call.

Cases: zamba2-smoke and seamless-smoke under both variants with every
K/V leaf cut over its slots (M = 48; 16 frames); a mixed cache under
"seqkv" (seamless, 16 frames cut over the ranks, M = 49 keeping the
kv-head cut) and its reverse under "shmap" (15 frames keeping the kv-head
cut, M = 48 cut over the slots). The prompt of 20 puts the decode steps
across the block boundary at 24 of M = 48. One spawn of 2 ranks
(`torch_tp_ranks.seq_family_rank`) and one reference subprocess.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serving import engine as JE
from repro.models import zoo as JZ
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import model_mesh, spawn_ranks
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as TZ
from repro_torch.serving import engine as TE
from torch_parity import close, flat_arrays, perturbed_model, token_batch
import torch_tp_ranks

WORLD = 2
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-4
TOKEN_MARGIN = 4e-4
CACHE_TOL = 1e-5
BF16_UNIT = 2.0 ** -7
PROMPT, STEPS, BATCH = 20, 8, 2
ZAMBA2, SEAMLESS = "zamba2-1.2b", "seamless-m4t-large-v2"
# name: (arch, variant, encoder frames (0: none), max_len)
CASES = {
    "zamba2-seqkv": (ZAMBA2, "seqkv", 0, 48),
    "zamba2-shmap": (ZAMBA2, "shmap", 0, 48),
    "seamless-seqkv": (SEAMLESS, "seqkv", 16, 48),
    "seamless-shmap": (SEAMLESS, "shmap", 16, 48),
    "seamless-seqkv-mixed": (SEAMLESS, "seqkv", 16, 49),
    "seamless-shmap-mixed": (SEAMLESS, "shmap", 15, 48),
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import configs as C
    from repro.models import layers as L
    from repro.models import zoo as Z
    from repro.serving import engine as E
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((1, 2), ("data", "model"))
    L.MESH = mesh
    out = {}
    for name in d["names"]:
        arch = str(d[f"{name}/arch"])
        prompt, max_len, steps = (int(a) for a in d[f"{name}/sizes"])
        cfg = dataclasses.replace(C.get_smoke(arch), dtype=jnp.float32,
                                  attn_shard="shmap")
        params = {}
        for key in d.files:
            if key.startswith(f"{name}/p/"):
                node = params
                *path, leaf = key[len(name) + 3:].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(d[key])
        batch = {"tokens": jnp.asarray(d[f"{name}/tokens"], jnp.int32)}
        enc_len = 0
        if f"{name}/frontend" in d.files:
            batch["frontend"] = jnp.asarray(d[f"{name}/frontend"])
            enc_len = batch["frontend"].shape[1]
        b = batch["tokens"].shape[0]
        with mesh:
            out[f"{name}/forward"] = np.asarray(jax.jit(
                Z.forward, static_argnums=1)(params, cfg, batch)[0])
            cache = E.init_cache(cfg, b, max_len, enc_len)
            lg, cache = jax.jit(E.prefill, static_argnums=1)(
                params, cfg, batch, cache)
            decode = jax.jit(E.decode_step, static_argnums=1)
            logits, fed = [np.asarray(lg[:, -1])], []
            for i in range(steps):
                # the token and the cache cross the host between the
                # jitted calls (test_torch_seq.py's reason)
                tok = np.asarray(jnp.argmax(lg[:, -1], axis=-1))[:, None]
                fed.append(tok)
                cache = {k: jnp.asarray(np.asarray(v))
                         for k, v in cache.items()}
                lg, cache = decode(params, cfg, jnp.asarray(tok, jnp.int32),
                                   cache, jnp.int32(prompt + i))
                logits.append(np.asarray(lg[:, -1]))
        out[f"{name}/logits"] = np.stack(logits)
        out[f"{name}/fed"] = np.stack(fed)
        for k, v in cache.items():
            out[f"{name}/cache/{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")

_decode = jax.jit(JE.decode_step, static_argnums=(1,))



def _inputs(name):
    """(JAX cfg, JAX params, JAX batch, tokens, frontend or None)."""
    arch, _, frames, _ = CASES[name]
    jcfg, jp = perturbed_model(arch)
    jb, tb = token_batch(jcfg, BATCH, PROMPT, seed=7)
    fe = None
    if frames:
        fe = tb["frontend"].numpy()[:, :frames]
        jb["frontend"] = jnp.asarray(fe)
    return jcfg, jp, jb, tb["tokens"].numpy(), fe


def _unsharded(jp, jcfg, jb, max_len, frames):
    """The reference's unsharded forward and engine: (forward logits, each
    step's last-position logits, the greedy tokens fed, the cache)."""
    fwd = np.asarray(JZ.forward(jp, jcfg, jb)[0])
    jc = JE.init_cache(jcfg, BATCH, max_len, frames)
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    logits, fed = [np.asarray(jl[:, -1])], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        fed.append(tok)
        jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(PROMPT + i))
        logits.append(np.asarray(jl[:, -1]))
    return fwd, logits, fed, {k: np.asarray(v) for k, v in jc.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (the shmap ones in a subprocess, started
    first; the seqkv ones in this process) and the two ranks' results."""
    tmp = tmp_path_factory.mktemp("seqfam")
    inputs = {name: _inputs(name) for name in CASES}
    shmap = [k for k, c in CASES.items() if c[1] == "shmap"]
    payload = {"names": np.asarray(shmap)}
    for name in shmap:
        arch, _, _, max_len = CASES[name]
        _, jp, _, tokens, fe = inputs[name]
        payload[f"{name}/arch"] = np.asarray(arch)
        payload[f"{name}/sizes"] = np.asarray([PROMPT, max_len, STEPS])
        payload[f"{name}/tokens"] = tokens
        if fe is not None:
            payload[f"{name}/frontend"] = fe
        payload.update({f"{name}/p/{k}": v
                        for k, v in flat_arrays(jax.device_get(jp)).items()})
    np.savez(tmp / "in.npz", **payload)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             str(tmp / "in.npz"), str(tmp / "out.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        refs = {}
        for name, (_, variant, frames, max_len) in CASES.items():
            if variant == "seqkv":
                jcfg, jp, jb, _, _ = inputs[name]
                refs[name] = _unsharded(jp, jcfg, jb, max_len, frames)
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    got = np.load(tmp / "out.npz")
    for name in shmap:
        refs[name] = (got[f"{name}/forward"], list(got[f"{name}/logits"]),
                      list(got[f"{name}/fed"]),
                      {k.split("/")[-1]: got[k] for k in got.files
                       if k.startswith(f"{name}/cache/")})
    cases = [(name, arch, variant, jax.device_get(inputs[name][1]),
              inputs[name][3], inputs[name][4], refs[name][2], max_len)
             for name, (arch, variant, _, max_len) in CASES.items()]
    ranks = spawn_ranks(WORLD, torch_tp_ranks.seq_family_rank, (cases,),
                        device="cpu", timeout_s=300)
    return {name: dict(ref=refs[name], ranks=[r[name] for r in ranks])
            for name in CASES}


def _cfg(name):
    arch, variant, _, _ = CASES[name]
    return dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                               attn_shard=variant)


def _seq_leaves(name) -> dict[str, bool]:
    """K/V leaf -> cut over its slots under the "seq" policy."""
    _, _, frames, max_len = CASES[name]
    shapes = TE.cache_shapes(_cfg(name), BATCH, max_len, frames)
    lay = SH.cache_layouts(shapes, model_mesh(WORLD), policy="seq")
    return {k: s[-3] == "model" for k, s in lay.items()
            if k in SH.KV_ENTRIES}


def _bars(name, want) -> tuple[float, float]:
    if CASES[name][1] == "shmap":
        return 0.0, BF16_UNIT * float(np.abs(want).max(initial=0.0))
    return LOGIT_RTOL, LOGIT_ATOL


@pytest.mark.parametrize("name", list(CASES))
def test_seq_families_forward_matches_the_reference(runs, name):
    r = runs[name]
    for rank in r["ranks"]:
        close(rank["logits"], r["ref"][0], *_bars(name, r["ref"][0]))


@pytest.mark.parametrize("name", list(CASES))
def test_seq_families_prefill_and_decode_match_the_reference(runs, name):
    r = runs[name]
    checked = 0
    for rank in r["ranks"]:
        assert len(rank["step_logits"]) == STEPS + 1
        for got, want in zip(rank["step_logits"], r["ref"][1]):
            bars = _bars(name, want)
            close(got, want, *bars)
            margin = 2 * bars[1] if CASES[name][1] == "shmap" \
                else TOKEN_MARGIN
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > margin
            np.testing.assert_array_equal(got.argmax(-1)[sure],
                                          want.argmax(-1)[sure])
            checked += int(sure.sum())
    assert checked > 0


@pytest.mark.parametrize("name", list(CASES))
def test_seq_families_cache_holds_each_ranks_part(runs, name):
    """Every leaf of each rank's cache after the decode steps is its part,
    under the "seq" layout, of the reference's: a K/V leaf a block of its
    slots with every kv head where the ranks divide them, its kv heads
    where they do not (the mixed cases: seamless's self K/V at M = 49, its
    cross K/V at 15 frames); Mamba2's states as tests/test_torch_tp
    _families.py holds them."""
    r = runs[name]
    arch, _, frames, max_len = CASES[name]
    cfg = _cfg(name)
    shapes = TE.cache_shapes(cfg, BATCH, max_len, frames)
    lay = SH.cache_layouts(shapes, model_mesh(WORLD), policy="seq")
    seq = _seq_leaves(name)
    if name == "seamless-seqkv-mixed":
        assert seq == {"k": False, "v": False, "cross_k": True,
                       "cross_v": True}
    elif name == "seamless-shmap-mixed":
        assert seq == {"k": True, "v": True, "cross_k": False,
                       "cross_v": False}
    else:
        assert seq and all(seq.values())
    assert set(r["ref"][3]) == set(shapes)
    for k, want in r["ref"][3].items():
        for rank_id, rank in enumerate(r["ranks"]):
            if k == "conv":
                pieces = TPAR.mamba_pieces(cfg.ssm_d_inner, cfg.ssm_state,
                                           cfg.ssm_heads, WORLD,
                                           rank_id)["conv"]
                part = np.concatenate([want[..., s:s + m]
                                       for s, m in pieces], -1)
            else:
                part = want[tuple(slice(a, a + m) for a, m in
                                  TPAR.local_slices(want.shape, lay[k],
                                                    model_mesh(WORLD),
                                                    rank_id))]
            assert rank["cache"][k].shape == part.shape, k
            bars = ((0.0, BF16_UNIT * float(np.abs(want).max(initial=0.0)))
                    if CASES[name][1] == "shmap" else (CACHE_TOL, CACHE_TOL))
            close(rank["cache"][k], part, *bars)


@pytest.mark.parametrize("name", list(CASES))
def test_seq_families_ranks_hold_the_same_logits_bits(runs, name):
    a, b = runs[name]["ranks"]
    np.testing.assert_array_equal(a["logits"], b["logits"])
    for x, y in zip(a["step_logits"], b["step_logits"]):
        np.testing.assert_array_equal(x, y)


def _attn(want, fresh_shmap: bool, variant: str) -> None:
    """An attention over fresh keys through `shmap_attention`: the
    all-gather of q / k / v, the max, and the combine (one float32 sum, or
    a bfloat16 wire and l: two)."""
    if fresh_shmap:
        want["all_gather"] += 1
        want["all_reduce_max"] += 1
        want["all_reduce_sum"] += 2 if variant == "shmap" else 1


def _want_calls(name, part) -> dict[str, int]:
    """The collectives of a forward, a prefill or one decode step (the
    vocabulary of 512 cut: one all-reduce for the embedding, one
    all-gather of the logits):
      zamba2, per Mamba2 layer: out_norm's sum of squares and out_proj's
        sum; per shared-block application: wo's and the MLP's sums, and
        its attention's: over fresh keys (a forward; a "shmap" prefill of
        a divided prompt) `shmap_attention`'s gather, max and combine; a
        prefill into a leaf cut over its slots otherwise the all-gather
        of k / v; a decode step there the gather of q / k / v, the max
        and one float32 sum;
      seamless, per encoder layer (forward and prefill): wo's and the
        MLP's sums, and `shmap_attention` where the ranks divide the
        frames; per decoder layer: the self attention's, the cross
        attention's and the MLP's wo sums; the self attention as zamba2's
        shared block's (a leaf the ranks do not divide adds nothing but
        the "shmap" prefill's combine); at prefill the all-gather of the
        cross K/V where its leaf is cut over the frames; at decode there
        the gather of q, the max and one sum."""
    arch, variant, frames, _ = CASES[name]
    cfg = _cfg(name)
    seq = _seq_leaves(name)
    want = {"all_reduce_sum": 1, "all_gather": 1, "all_reduce_max": 0}
    divided = PROMPT % WORLD == 0
    if arch == ZAMBA2:
        want["all_reduce_sum"] += 2 * cfg.n_layers
        self_leaf, layers = "attn_k", TZ.shared_applications(cfg)
    else:
        self_leaf, layers = "k", cfg.n_layers
        if part != "decode":
            want["all_reduce_sum"] += 2 * cfg.n_enc_layers
            for _ in range(cfg.n_enc_layers):
                _attn(want, frames % WORLD == 0, variant)
        want["all_reduce_sum"] += layers        # the cross attention's wo
    want["all_reduce_sum"] += 2 * layers        # wo and the MLP
    for _ in range(layers):
        if part == "forward":
            _attn(want, divided, variant)
        elif part == "prefill":
            fresh = variant == "shmap" and divided
            _attn(want, fresh, variant)
            if seq[self_leaf] and not fresh:
                want["all_gather"] += 1
            if arch == SEAMLESS and seq["cross_k"]:
                want["all_gather"] += 1
        else:
            for leaf in (self_leaf, "cross_k") if arch == SEAMLESS \
                    else (self_leaf,):
                if seq[leaf]:
                    want["all_gather"] += 1
                    want["all_reduce_max"] += 1
                    want["all_reduce_sum"] += 1
    return {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("name", list(CASES))
def test_seq_families_collectives_per_pass(runs, name):
    for rank in runs[name]["ranks"]:
        assert rank["calls"]["forward"] == _want_calls(name, "forward")
        assert rank["calls"]["prefill"] == _want_calls(name, "prefill")
        for calls in rank["step_calls"]:
            assert calls == _want_calls(name, "decode")


@pytest.mark.parametrize("name", list(CASES))
def test_seq_families_decode_runs_k8_partials_over_each_ranks_range(
        runs, name):
    """Each decode step calls K8's partials mode once per attention whose
    leaf is cut over its slots, in layer order (seamless: the self, then
    the cross attention), over the rank's part of the valid slots: the
    self attention's positions up to the step's (rank 0's block full once
    the step passes 24, rank 1's empty before), the cross attention's
    every frame of the rank's block; whole K8 runs once per attention
    whose leaf keeps the kv-head cut, and not at all where every leaf is
    cut over its slots."""
    arch, _, frames, max_len = CASES[name]
    cfg = _cfg(name)
    seq = _seq_leaves(name)
    layers = (TZ.shared_applications(cfg) if arch == ZAMBA2
              else cfg.n_layers)
    self_leaf = "attn_k" if arch == ZAMBA2 else "k"
    crossed = False
    for rank_id, rank in enumerate(runs[name]["ranks"]):
        for i, ranges in enumerate(rank["step_ranges"]):
            pos, nb = PROMPT + i, max_len // WORLD
            want, whole = [], 0
            for _ in range(layers):
                if seq[self_leaf]:
                    want.append((0, min(max(pos + 1 - rank_id * nb, 0),
                                        nb)))
                else:
                    whole += 1
                if arch == SEAMLESS and seq["cross_k"]:
                    want.append((0, frames // WORLD))
                elif arch == SEAMLESS:
                    whole += 1
            assert [tuple(r) for r in ranges] == want, (rank_id, i)
            assert rank["step_k8"][i] == whole
            crossed |= (rank_id == 1 and seq[self_leaf] and pos < nb
                        and tuple(ranges[0]) == (0, 0))
    if seq[self_leaf]:
        assert crossed


@pytest.mark.parametrize("arch", [ZAMBA2, SEAMLESS])
def test_seq_variants_pass_check_tp_for_the_families(arch):
    """"seqkv" and "shmap" run the hybrid and encdec families: check_tp
    passes them over 2 and 4 ranks and `init_cache` lays their K/V leaves
    out by the "seq" rule (a block of the slots with every kv head)."""
    for variant in ("seqkv", "shmap"):
        cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                                  attn_shard=variant)
        for world in (2, 4):
            TPAR.check_tp(cfg, world)
        mp = TPAR.ModelParallel(rank=1, world=WORLD,
                                mesh=model_mesh(WORLD), backend="gloo")
        cache = TE.init_cache(cfg, BATCH, 48, 16, device="cpu", mp=mp)
        for k, t in cache.items():
            if k in SH.KV_ENTRIES:
                assert t.shape[-3:] == (
                    (48 if k in ("k", "v", "attn_k", "attn_v") else 16)
                    // WORLD, cfg.n_kv_heads, cfg.hd), k
