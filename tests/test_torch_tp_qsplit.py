"""The port's serving where the ranks split the query heads
(`models/parallel.py` `q_heads`): the reference's rules cut wq's H·hd
columns (and wo's rows) into one block a rank wherever the ranks divide
H·hd, so a rank may hold part of a head (yi-34b's and arctic-480b's 56
heads over 16 ranks: 3.5 a rank; starcoder2-3b's 24: 1.5). Each rank
keeps that cut, gathers q whole, attends the heads its columns touch over
the kv heads those read (`kv_heads`, each run of equal kv heads held
once) and keeps its own columns of the output for its rows of wo. Under
"seqkv" / "shmap" the gathers and the rank's part of the output are
column blocks.

Four gloo ranks on the CPU against the reference's unsharded runs on the
same numpy params (its smoke `materialize` with the heads replaced):
yi-smoke with 6 query / 2 kv heads (1.5 heads a rank) and dbrx-smoke with
14 / 2 (3.5 a rank), each under "auto", "seqkv" and "shmap", and 3 / 3
under "seqkv" (the ranks touch 1, 2, 2 and 1 heads, so they hold unequal
counts of kv heads and pad their gathers, `parallel.kv_slots`); two ranks
for MQA (yi-smoke with 1 kv head, on every rank: a count check_tp once
refused, the cache's layout now being a tag, `engine.KVCache.cuts`) and for
3 query heads / 1 kv head under "shmap" (1.5 heads a rank and MQA). The
"shmap" cases are held to the reference's own engine under
attn_shard="shmap" on a (data 1, model world) mesh of host devices in a
subprocess (`XLA_FLAGS=--xla_force_host_platform_device_count=4`, `with
mesh:` + `jax.jit`, as tests/test_torch_seq_families.py): its bfloat16
wires in the attention combine and in the experts' sum are the port's,
where the unsharded reference has none. Each case: the forward,
a prefill of PROMPT tokens and STEPS decode steps fed the reference's
greedy tokens.

Tolerances (tests/test_torch_tp.py's): logits rtol 1e-5 / atol 2e-4,
greedy tokens exact where the reference's top-2 margin exceeds 4e-4,
cache contents 1e-5; "shmap" (bfloat16 wires) at one bfloat16 unit of the
largest value, tokens where the margin exceeds twice that
(tests/test_torch_seq.py's reasoning); shards gather back bit for bit;
every rank holds the same bits after every all-reduce; K8 (whole under
"auto", partials under "seq") runs layers x steps times on every rank.
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
import torch

from repro import configs as JCFG
from repro.models import base as JMB
from repro.models import zoo as JZ
from repro.serving import engine as JE
from repro_torch import configs as CFG
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import model_mesh, spawn_ranks, train_mesh
from repro_torch.models import base as MB
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as TZ
from repro_torch.models.parallel import ModelParallel, check_tp
from repro_torch.serving import engine as TE
from torch_parity import close, flat_arrays, n, token_batch
import torch_tp_ranks

LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-4
TOKEN_MARGIN = 4e-4
CACHE_TOL = 1e-5
BF16_UNIT = 2.0 ** -7
PROMPT, STEPS, BATCH = 20, 8, 2
MAX_LEN = 48                    # divided by 2 and 4: "seq" cuts every leaf
# name: (arch, overrides, attn_shard, world)
# the smoke configs' head_dim (64) kept as the head counts change
YI6 = {"n_heads": 6, "head_dim": 64}
DBRX14 = {"n_heads": 14, "head_dim": 64}
CASES = {
    "yi6-auto": ("yi-34b", YI6, "auto", 4),
    "yi6-seqkv": ("yi-34b", YI6, "seqkv", 4),
    "yi6-shmap": ("yi-34b", YI6, "shmap", 4),
    "dbrx14-auto": ("dbrx-132b", DBRX14, "auto", 4),
    "dbrx14-seqkv": ("dbrx-132b", DBRX14, "seqkv", 4),
    "dbrx14-shmap": ("dbrx-132b", DBRX14, "shmap", 4),
    # 3 query / 3 kv heads over 4 ranks: ranks touch 1, 2, 2 and 1 heads,
    # so they hold unequal kv counts and pad the gather (`kv_slots`)
    "mha3-seqkv": ("yi-34b", {"n_heads": 3, "n_kv_heads": 3,
                              "head_dim": 64}, "seqkv", 4),
    "mqa-auto": ("yi-34b", {"n_kv_heads": 1}, "auto", 2),
    "mqa3-shmap": ("yi-34b", {"n_heads": 3, "n_kv_heads": 1,
                              "head_dim": 64}, "shmap", 2),
}
# held to the reference's own shard_map run, in a subprocess (its bf16
# wires, in attention and in the experts' sum, where they are)
OWN_SHMAP = tuple(k for k, c in CASES.items() if c[2] == "shmap")
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
    out = {}
    for name in d["names"]:
        arch = str(d[f"{name}/arch"])
        prompt, max_len, steps, heads, kv_heads, hd, world = (
            int(a) for a in d[f"{name}/sizes"])
        mesh = jax.make_mesh((1, world), ("data", "model"),
                             devices=jax.devices()[:world])
        L.MESH = mesh
        cfg = dataclasses.replace(C.get_smoke(arch), dtype=jnp.float32,
                                  attn_shard="shmap", n_heads=heads,
                                  n_kv_heads=kv_heads, head_dim=hd)
        params = {}
        for key in d.files:
            if key.startswith(f"{name}/p/"):
                node = params
                *path, leaf = key[len(name) + 3:].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(d[key])
        batch = {"tokens": jnp.asarray(d[f"{name}/tokens"], jnp.int32)}
        b = batch["tokens"].shape[0]
        with mesh:
            out[f"{name}/forward"] = np.asarray(jax.jit(
                Z.forward, static_argnums=1)(params, cfg, batch)[0])
            cache = E.init_cache(cfg, b, max_len)
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


def _jcfg(name):
    arch, over, _, _ = CASES[name]
    return dataclasses.replace(JCFG.get_smoke(arch), dtype=jnp.float32,
                               **over)


def _cfg(name):
    arch, over, variant, _ = CASES[name]
    return dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                               attn_shard=variant, **over)


def _model(name):
    """(JAX cfg, JAX params) of a case: the reference's `materialize` of
    its smoke config with the heads replaced."""
    jcfg = _jcfg(name)
    return jcfg, JMB.materialize(JZ.templates(jcfg), jax.random.PRNGKey(1),
                                 dtype=jnp.float32)


def _unsharded(jp, jcfg, jb):
    """The reference's unsharded forward and engine: (forward logits, each
    step's last-position logits, the greedy tokens fed, the cache)."""
    fwd = np.asarray(JZ.forward(jp, jcfg, jb)[0])
    jc = JE.init_cache(jcfg, BATCH, MAX_LEN)
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
    """The reference's runs (the own-shmap ones in a subprocess, started
    first; the others in this process) and each world's ranks'."""
    tmp = tmp_path_factory.mktemp("qsplit")
    models = {name: _model(name) for name in CASES}
    batches = {name: token_batch(models[name][0], BATCH, PROMPT, seed=7)
               for name in CASES}
    payload = {"names": np.asarray(OWN_SHMAP)}
    for name in OWN_SHMAP:
        jcfg, jp = models[name]
        payload[f"{name}/arch"] = np.asarray(CASES[name][0])
        payload[f"{name}/sizes"] = np.asarray(
            [PROMPT, MAX_LEN, STEPS, jcfg.n_heads, jcfg.n_kv_heads,
             jcfg.hd, CASES[name][3]])
        payload[f"{name}/tokens"] = n(batches[name][1]["tokens"])
        payload.update({f"{name}/p/{k}": v
                        for k, v in flat_arrays(jax.device_get(jp)).items()})
    np.savez(tmp / "in.npz", **payload)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             str(tmp / "in.npz"), str(tmp / "out.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        refs = {name: _unsharded(models[name][1], models[name][0],
                                 batches[name][0])
                for name in CASES if name not in OWN_SHMAP}
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    got = np.load(tmp / "out.npz")
    for name in OWN_SHMAP:
        refs[name] = (got[f"{name}/forward"], list(got[f"{name}/logits"]),
                      list(got[f"{name}/fed"]),
                      {k.split("/")[-1]: got[k] for k in got.files
                       if k.startswith(f"{name}/cache/")})
    ranks = {}
    for world in sorted({c[3] for c in CASES.values()}):
        cases = [(name, arch, over, variant,
                  jax.device_get(models[name][1]),
                  n(batches[name][1]["tokens"]), refs[name][2], MAX_LEN)
                 for name, (arch, over, variant, w) in CASES.items()
                 if w == world]
        out = spawn_ranks(world, torch_tp_ranks.qsplit_rank, (cases,),
                          device="cpu", timeout_s=300)
        ranks.update({c[0]: [r[c[0]] for r in out] for c in cases})
    return {name: dict(ref=refs[name], ranks=ranks[name]) for name in CASES}


def _bars(name, want) -> tuple[float, float]:
    if CASES[name][2] == "shmap":
        return 0.0, BF16_UNIT * float(np.abs(want).max(initial=0.0))
    return LOGIT_RTOL, LOGIT_ATOL


def test_the_cases_split_the_query_heads_or_hold_every_kv_head():
    for name, (_, _, _, world) in CASES.items():
        cfg = _cfg(name)
        check_tp(cfg, world)
        if name.startswith("mqa"):
            assert cfg.n_kv_heads == 1
        if name == "mha3-seqkv":
            held = {len(TPAR.kv_heads(3, 3, world, r)) for r in range(world)}
            assert held == {1, 2}
        if name != "mqa-auto":
            assert cfg.n_heads % world and TPAR.q_split(
                cfg, ModelParallel(rank=0, world=world,
                                   mesh=model_mesh(world), backend="gloo"))
            assert (cfg.n_heads * cfg.hd) % world == 0


@pytest.mark.parametrize("name", list(CASES))
def test_qsplit_forward_matches_the_reference(runs, name):
    r = runs[name]
    for rank in r["ranks"]:
        assert all(rank["round_trip"]), name
        close(rank["logits"], r["ref"][0], *_bars(name, r["ref"][0]))


@pytest.mark.parametrize("name", list(CASES))
def test_qsplit_prefill_and_decode_match_the_reference(runs, name):
    r = runs[name]
    checked = 0
    for rank in r["ranks"]:
        assert len(rank["step_logits"]) == STEPS + 1
        for got, want in zip(rank["step_logits"], r["ref"][1]):
            bars = _bars(name, want)
            close(got, want, *bars)
            margin = 2 * bars[1] if CASES[name][2] == "shmap" \
                else TOKEN_MARGIN
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > margin
            np.testing.assert_array_equal(got.argmax(-1)[sure],
                                          want.argmax(-1)[sure])
            checked += int(sure.sum())
    assert checked > 0


@pytest.mark.parametrize("name", list(CASES))
def test_qsplit_cache_holds_each_ranks_part(runs, name):
    """Each rank's cache after prefill and the decode steps: under "auto"
    the kv heads its touched query heads read (`kv_heads`), whole; under
    "seqkv" / "shmap" a block of MAX_LEN / world slots with every kv head;
    the layout tags say which (`KVCache.cuts`)."""
    r = runs[name]
    cfg = _cfg(name)
    world = CASES[name][3]
    seq = CASES[name][2] != "auto"
    for rank_id, rank in enumerate(r["ranks"]):
        mp = ModelParallel(rank=rank_id, world=world,
                           mesh=model_mesh(world), backend="gloo")
        assert TE.cache_cuts(cfg, BATCH, MAX_LEN, mp) == {
            k: "seq" if seq else "heads" for k in ("k", "v")}
        for key, want in r["ref"][3].items():
            got = rank["cache"][key]
            if seq:
                nb = want.shape[-3] // world
                part = want[..., rank_id * nb:(rank_id + 1) * nb, :, :]
            else:
                part = want[..., TPAR.kv_heads(cfg.n_heads, cfg.n_kv_heads,
                                               world, rank_id), :]
            assert got.shape == part.shape, (key, rank_id)
            if CASES[name][2] == "shmap":
                close(got, part, *_bars(name, want))
            else:
                close(got, part, CACHE_TOL, CACHE_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_qsplit_ranks_hold_equal_bits_after_every_all_reduce(runs, name):
    ranks = runs[name]["ranks"]
    assert ranks[0]["digests"]
    for rank in ranks[1:]:
        assert rank["digests"] == ranks[0]["digests"]
        np.testing.assert_array_equal(rank["logits"], ranks[0]["logits"])
        for a, b in zip(rank["step_logits"], ranks[0]["step_logits"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_qsplit_k8_runs_layers_times_steps_on_every_rank(runs, name):
    """Whole K8 on the touched heads under "auto", K8's partials mode
    under "seqkv" / "shmap": once a layer a decode step, on every rank;
    prefill and forward launch none."""
    cfg = _cfg(name)
    seq = CASES[name][2] != "auto"
    for rank in runs[name]["ranks"]:
        assert (rank["k8_partial"] if seq else rank["k8"]) \
            == cfg.n_layers * STEPS
        assert (rank["k8"] if seq else rank["k8_partial"]) == 0


@pytest.mark.parametrize("name", [k for k, c in CASES.items()
                                  if c[2] == "auto"])
def test_qsplit_collectives_add_one_gather_a_layer(runs, name):
    """Under "auto" a rank gathers q whole once a layer a pass where the
    ranks split the heads (its touched heads'), else never; one
    all_reduce_sum a layer for attention's wo and one for the MLP or the
    experts, one for the embedding (the vocabulary is cut), and one
    gather of the logits."""
    cfg = _cfg(name)
    split = cfg.n_heads % CASES[name][3] != 0
    for rank in runs[name]["ranks"]:
        for part, steps in (("forward", 1), ("prefill", 1),
                            ("decode", STEPS)):
            want = {"all_reduce_sum": (1 + 2 * cfg.n_layers) * steps,
                    "all_gather": (1 + split * cfg.n_layers) * steps}
            assert rank["calls"][part] == want, part


# ---------------------------------------------------------------------------
# No spawn: the map from a rank's columns to its heads, the shards, the
# probe of the published configs
# ---------------------------------------------------------------------------

def _rank(r: int, world: int) -> ModelParallel:
    return ModelParallel(rank=r, world=world, mesh=model_mesh(world),
                         backend="gloo")


@pytest.mark.parametrize("h,hkv,hd,world", [
    (56, 8, 128, 16),           # yi-34b, arctic-480b: 3.5 heads a rank
    (24, 2, 128, 16),           # starcoder2-3b: 1.5
    (6, 2, 64, 4), (14, 2, 64, 4), (3, 1, 64, 2),
    (4, 2, 64, 8),              # half a head a rank
    (3, 3, 64, 4),              # touched counts differ: 1, 2, 2, 1
    (6, 3, 64, 4),              # runs of unequal kv heads: rep 1
])
def test_touched_heads_and_kv_heads_follow_the_column_blocks(h, hkv, hd,
                                                             world):
    """A rank's touched heads are those its block of the h·hd columns
    (`launch.sharding`'s cut of wq, `local_slices`) meets; its kv heads
    hold one kv head per run of rep touched heads reading it, so its
    touched head t reads its kv head t // rep, the reference's GQA; the
    ranks' kv heads, padded to `kv_slots` and laid side by side, give
    each model kv head through `kv_gather_index`."""
    mesh = model_mesh(world)
    spec = SH.spec_from_axes(("embed", "qout"), (8, h * hd), SH.TP_RULES,
                             mesh)
    assert spec == (None, "model")
    group, slots = h // hkv, TPAR.kv_slots(h, hkv, world)
    flat = []
    for r in range(world):
        (_, _), (c0, c) = TPAR.local_slices((8, h * hd), spec, mesh, r)
        touched = [j for j in range(h)
                   if j * hd < c0 + c and (j + 1) * hd > c0]
        assert list(TPAR.q_heads(h, world, r)) == touched
        held = TPAR.kv_heads(h, hkv, world, r)
        rep = TPAR.kv_rep(h, hkv, world)
        assert len(held) * rep == len(touched)
        for t, j in enumerate(touched):
            assert held[t // rep] == j // group
        flat += held + [-1] * (slots - len(held))
    pick = TPAR.kv_gather_index(h, hkv, world)
    assert [flat[i] for i in pick] == list(range(hkv))


@pytest.mark.parametrize("name", [k for k, c in CASES.items()
                                  if c[2] == "auto"])
def test_qsplit_shards_follow_the_sharding_specs(name):
    """Each rank's wq / wo are its block of the columns / rows that
    `launch.sharding`'s layout names (the reference's cut, a head split
    at a block boundary), wk / wv the whole columns of its kv heads."""
    cfg = _cfg(name)
    world = CASES[name][3]
    tmpl = TZ.templates(cfg)
    full = MB.materialize(tmpl, torch.Generator().manual_seed(2))
    layout = SH.param_layouts(tmpl, model_mesh(world), "tp")
    attn, hd = full["blocks"]["attn"], cfg.hd
    for r in range(world):
        shard = MB.shard_params(full, tmpl, layout, _rank(r, world))["blocks"]
        for key in ("wq", "wo"):
            want = attn[key][tuple(slice(s, s + m) for s, m in
                                   TPAR.local_slices(
                                       tuple(attn[key].shape),
                                       layout["blocks"]["attn"][key],
                                       model_mesh(world), r))]
            assert torch.equal(shard["attn"][key], want), (key, r)
        cols = [j * hd + i for j in TPAR.kv_heads(
            cfg.n_heads, cfg.n_kv_heads, world, r) for i in range(hd)]
        for key in ("wk", "wv"):
            assert torch.equal(shard["attn"][key], attn[key][..., cols])


ARCHS = [a for a in CFG.ARCH_IDS
         if CFG.get(a).arch_type in ("dense", "moe")]


@pytest.mark.parametrize("world", [2, 4, 8, 16])
def test_no_published_dense_or_moe_config_is_refused(world):
    """check_tp under every attn_shard and check_train under "tp" and
    "fsdp" with "auto" and "shmap" ("zero3" with "auto") accept every
    published dense and moe config at 2, 4, 8 and 16 ranks (16: the
    reference's pod dry run's model axis, where yi-34b, arctic-480b and
    starcoder2-3b split their query heads)."""
    assert len(ARCHS) == 7
    for arch in ARCHS:
        for variant in TPAR.ATTN_SHARDS:
            check_tp(dataclasses.replace(CFG.get(arch), attn_shard=variant),
                     world)
        for mode, shards in TPAR.TRAIN_ATTN_SHARDS.items():
            for variant in shards:
                TPAR.check_train(dataclasses.replace(
                    CFG.get(arch), attn_shard=variant), train_mesh(1, world),
                    mode)
    if world == 16:
        for arch in ("yi-34b", "arctic-480b", "starcoder2-3b"):
            assert CFG.get(arch).n_heads % world


def test_a_qout_the_ranks_do_not_divide_is_refused_by_name():
    for arch, world in (("yi-34b", 3), ("starcoder2-3b", 5),
                        ("dbrx-132b", 7)):
        cfg = CFG.get(arch)
        with pytest.raises(ValueError, match=rf"over {world} ranks.*'qout': "
                                             rf"{cfg.n_heads * cfg.hd}"):
            check_tp(cfg, world)
