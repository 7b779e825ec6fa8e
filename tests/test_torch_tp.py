"""The port's model parallelism ("tp": heads, ffn, vocabulary and experts
over the ranks; `models/parallel.py`) on two gloo ranks on the CPU,
against the reference's unsharded runs on the same numpy params:
gemma3-smoke (4 heads, 2 kv heads: 2 / 1 a rank, its rings wrapping) and
dbrx-smoke (4 experts: 2 a rank). One spawn per model (`launch.mesh
.spawn_ranks`, ~4 s each); the rank functions are in torch_tp_ranks.py.
`layers.moe_ffn_shmap` is held to the reference's `moe_ffn_shmap` run by
`jax.shard_map` on a (data 1, model 2) mesh of two host devices in a
subprocess (the reference's dry-run way to get devices,
src/repro/launch/mesh.py).

Tolerances (the engine tests' bars): logits rtol 1e-5 / atol 2e-4,
greedy tokens exact where the reference's top-2 margin exceeds 4e-4,
cache contents 1e-5, aux 1e-6; shards gather back bit for bit, and every
rank holds the same bits after every all-reduce. moe_ffn_shmap: the
float32 wire equals the port's unsharded `moe_ffn` bit for bit (each
token's k = 2 terms are summed on one rank or cross the wire as a + 0
and 0 + b) and the reference's moe_ffn within 1e-5; the bf16 wire is the
sum of the ranks' partials each rounded to bfloat16, rounded again,
exactly, and the reference's within 1e-5 relative but for at most 0.1%
of the elements one bfloat16 unit apart (the two packages' last float32
bit of a partial can round apart there).
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

from repro.models import base as JMB
from repro.models import zoo as JZ
from repro.serving import engine as JE
from repro_torch import configs as CFG
from repro_torch.kernels import ops
from repro_torch.kernels.swa_decode import kernel as swa_kernel
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import model_mesh, spawn_ranks
from repro_torch.models import base as MB
from repro_torch.models import layers as Lyr
from repro_torch.models import zoo as TZ
from repro_torch.models import parallel as TPAR
from repro_torch.models.parallel import ModelParallel, check_tp
from repro_torch.serving import engine as TE
from torch_parity import PORTED_ARCHS, close, dense_model, n, token_batch
import torch_tp_ranks

WORLD = 2
ARCHS = ["gemma3-27b", "dbrx-132b"]       # their smoke variants
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-4
TOKEN_MARGIN = 4e-4
CACHE_TOL = 1e-5
AUX_TOL = 1e-6
PROMPT, STEPS, BATCH = 40, 8, 2           # gemma3-smoke's window is 32
CAPACITY_FACTORS = (8.0, 1.0, 0.5)        # no drops, some, many
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_decode = jax.jit(JE.decode_step, static_argnums=(1,))


def _reference_serve(jp, jcfg, jb, max_len):
    """The reference's prefill and STEPS greedy decode steps: each step's
    last-position logits and the greedy tokens it fed."""
    jc = JE.init_cache(jcfg, BATCH, max_len)
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    logits, fed = [np.asarray(jl[:, -1])], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        fed.append(tok)
        jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(PROMPT + i))
        logits.append(np.asarray(jl[:, -1]))
    return logits, fed, {k: np.asarray(v) for k, v in jc.items()}


@pytest.fixture(scope="module")
def runs():
    """Per arch: the reference's forward and engine run, and the two
    ranks' results."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg, jp, _ = dense_model(arch)
        jb, tb = token_batch(jcfg, BATCH, PROMPT, seed=7)
        want_logits, want_aux = JZ.forward(jp, jcfg, jb)
        max_len = PROMPT + STEPS + 1
        steps, fed, cache = _reference_serve(jp, jcfg, jb, max_len)
        ranks = spawn_ranks(
            WORLD, torch_tp_ranks.model_rank,
            (arch, jax.device_get(jp), n(tb["tokens"]), fed, STEPS,
             max_len), device="cpu", timeout_s=300)
        out[arch] = dict(cfg=tcfg, logits=np.asarray(want_logits),
                         aux=float(want_aux), steps=steps, cache=cache,
                         ranks=ranks)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_shards_gather_back_bit_for_bit(runs, arch):
    r = runs[arch]
    cfg = r["cfg"]
    full = [t.shape for t in MB.tree_leaves(TZ.templates(cfg))]
    for rank in r["ranks"]:
        assert all(rank["round_trip"]), arch
        cut = [s for s, f in zip(rank["shard_shapes"], full) if s != f]
        assert cut, arch                  # something was sharded
    # each rank holds its share of the heads, kv heads and vocabulary
    shapes = dict(zip((t.axes for t in MB.tree_leaves(TZ.templates(cfg))),
                      r["ranks"][0]["shard_shapes"]))
    assert shapes[("vocab", "embed")][0] == cfg.vocab // WORLD


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_matches_the_reference(runs, arch):
    r = runs[arch]
    for rank in r["ranks"]:
        close(rank["logits"], r["logits"], LOGIT_RTOL, LOGIT_ATOL)
        assert abs(float(rank["aux"]) - r["aux"]) <= AUX_TOL
    if arch == "dbrx-132b":
        assert r["aux"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_decode_match_the_reference(runs, arch):
    r = runs[arch]
    checked = 0
    for rank in r["ranks"]:
        for got, want in zip(rank["step_logits"], r["steps"]):
            close(got, want, LOGIT_RTOL, LOGIT_ATOL)
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > TOKEN_MARGIN
            np.testing.assert_array_equal(got.argmax(-1)[sure],
                                          want.argmax(-1)[sure])
            checked += int(sure.sum())
    assert checked > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_cache_holds_each_ranks_kv_heads(runs, arch):
    """Each rank's cache is its block of kv heads (the "heads" layout) of
    the reference's cache after prefill and the decode steps; gemma3's
    rings have wrapped (PROMPT + STEPS past its window)."""
    r = runs[arch]
    cfg = r["cfg"]
    hkv = cfg.n_kv_heads // WORLD
    if cfg.sliding_window:
        assert PROMPT + STEPS > cfg.sliding_window
    for k, want in r["cache"].items():
        for rank_id, rank in enumerate(r["ranks"]):
            got = rank["cache"][k]
            assert got.shape[-2] == hkv and got.shape[:-2] == want.shape[:-2]
            close(got, want[..., rank_id * hkv:(rank_id + 1) * hkv, :],
                  CACHE_TOL, CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_ranks_hold_equal_bits_after_every_all_reduce(runs, arch):
    ranks = runs[arch]["ranks"]
    assert [float(r["top_rank"][0]) for r in ranks] == [WORLD - 1] * WORLD
    assert ranks[0]["digests"] and ranks[0]["digests"] == ranks[1]["digests"]
    np.testing.assert_array_equal(ranks[0]["logits"], ranks[1]["logits"])
    for a, b in zip(ranks[0]["step_logits"], ranks[1]["step_logits"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_collectives_per_pass(runs, arch):
    """One all-reduce for the embedding, one per row-parallel projection
    (attention's wo and the MLP's, or the experts' sum), one all-gather of
    the logits: per forward, per prefill and per decode step."""
    r = runs[arch]
    want = {"all_reduce_sum": 1 + 2 * r["cfg"].n_layers, "all_gather": 1}
    for rank in r["ranks"]:
        assert rank["calls"]["forward"] == want
        assert rank["calls"]["prefill"] == want
        assert rank["calls"]["decode"] == {k: v * STEPS
                                          for k, v in want.items()}


# ---------------------------------------------------------------------------
# moe_ffn_shmap against the reference's shard_map version
# ---------------------------------------------------------------------------

_REFERENCE_SHMAP = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import configs as C
    from repro.models import layers as L
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((1, 2), ("data", "model"))
    L.MESH = mesh
    p = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_in", "w_out")}
    out = {}
    for i, cf in enumerate(d["cfs"]):
        cfg = dataclasses.replace(C.get_smoke("dbrx-132b"),
                                  dtype=jnp.float32,
                                  capacity_factor=float(cf))
        with mesh:
            y, aux = jax.jit(L.moe_ffn_shmap, static_argnums=1)(
                p, cfg, jnp.asarray(d["x"]))
        out[f"y{i}"] = np.asarray(y.astype(jnp.float32))
        out[f"aux{i}"] = np.asarray(aux)
        out[f"plain{i}"] = np.asarray(
            L.moe_ffn(p, cfg, jnp.asarray(d["x"]))[0])
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def shmap_runs(tmp_path_factory):
    """The reference's moe_ffn_shmap on two host devices (a subprocess,
    started first) and the port's on two gloo ranks, on dbrx-smoke's moe
    layer at each capacity factor; plus the port's unsharded moe_ffn."""
    tmp = tmp_path_factory.mktemp("shmap")
    jcfg, tcfg, _, _ = dense_model("dbrx-132b")
    jm = JMB.materialize(JZ._moe_templates(jcfg), jax.random.PRNGKey(5),
                         dtype=jnp.float32)
    p = {k: np.asarray(v) for k, v in jax.device_get(jm).items()}
    x = np.random.default_rng(5).normal(
        size=(3, 11, tcfg.d_model)).astype(np.float32)
    np.savez(tmp / "in.npz", x=x, cfs=np.asarray(CAPACITY_FACTORS), **p)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE_SHMAP,
                            str(tmp / "in.npz"), str(tmp / "out.npz")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn_ranks(WORLD, torch_tp_ranks.moe_rank,
                            ("dbrx-132b", p, x, CAPACITY_FACTORS),
                            device="cpu", timeout_s=300)
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log
    want = np.load(tmp / "out.npz")
    plain = {}
    for cf in CAPACITY_FACTORS:
        cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg("dbrx-132b"),
                                  capacity_factor=cf)
        y, aux = Lyr.moe_ffn({k: torch.tensor(v) for k, v in p.items()},
                             cfg, torch.from_numpy(x))
        plain[cf] = (n(y), float(aux))
    return dict(ranks=ranks, plain=plain,
                ref={cf: (want[f"y{i}"], float(want[f"aux{i}"]),
                          want[f"plain{i}"])
                     for i, cf in enumerate(CAPACITY_FACTORS)})


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_moe_ffn_shmap_float32_wire_equals_unsharded(shmap_runs, cf):
    """The float32 wire (the plain "tp" layout): the port's unsharded
    moe_ffn bit for bit, the reference's moe_ffn within 1e-5."""
    y, aux = shmap_runs["plain"][cf]
    _, ref_aux, ref_plain = shmap_runs["ref"][cf]
    for rank in shmap_runs["ranks"]:
        got = rank[cf]
        assert got["n_local"] == 2 and got["y_f32"].dtype == np.float32
        np.testing.assert_array_equal(got["y_f32"], y)
        assert abs(float(got["aux"]) - ref_aux) <= AUX_TOL
        close(got["y_f32"], ref_plain, 1e-5, 1e-5)
    assert abs(aux - ref_aux) <= AUX_TOL


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_moe_ffn_shmap_bf16_wire_matches_the_reference(shmap_runs, cf):
    """The bfloat16 wire: each rank casts its float32 partial sum to
    bfloat16 and the all-reduce adds those, so the output is bf16(bf16(p0)
    + bf16(p1)) exactly, of the ranks' partials p0, p1. A partial within a
    float32 rounding of a bfloat16 rounding boundary can round apart in
    the two packages, so an element is the reference's within 1e-5
    relative or, for at most 0.1% of the elements, one bfloat16 unit from
    it."""
    ref_y = shmap_runs["ref"][cf][0]
    p0, p1 = (torch.from_numpy(r[cf]["partial"]) for r in shmap_runs["ranks"])
    wire = (p0.to(torch.bfloat16).float()
            + p1.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    for rank in shmap_runs["ranks"]:
        got = rank[cf]["y_bf16"]
        np.testing.assert_array_equal(got, wire.numpy())
        diff = np.abs(got - ref_y)
        apart = diff > 1e-5 * np.abs(ref_y)
        assert np.all(diff[apart] <= _bf16_ulp(
            np.maximum(np.abs(got), np.abs(ref_y)))[apart])
        assert apart.mean() <= 1e-3, apart.sum()
    # the partials sum to the float32 wire's output
    np.testing.assert_array_equal((p0 + p1).numpy(),
                                  shmap_runs["ranks"][0][cf]["y_f32"])


def test_moe_ffn_shmap_ranks_agree(shmap_runs):
    a, b = shmap_runs["ranks"]
    for cf in CAPACITY_FACTORS:
        for key in ("y_bf16", "y_f32"):
            np.testing.assert_array_equal(a[cf][key], b[cf][key])


# ---------------------------------------------------------------------------
# No spawn: the refusals, the shards' tiling, K8 at a rank's heads
# ---------------------------------------------------------------------------

def _rank(r: int, world: int) -> ModelParallel:
    """A rank's view without a process group: enough for shard_params and
    the cache layout, which run no collective."""
    return ModelParallel(rank=r, world=world, mesh=model_mesh(world),
                         backend="gloo")


def test_tp_refuses_a_world_that_does_not_divide_the_kv_heads():
    """A world that does not divide the kv heads runs where it divides
    wq's H·hd columns (each rank holds whole the kv heads its touched
    query heads read, tests/test_torch_tp_kvrep.py and
    tests/test_torch_tp_qsplit.py): every 2-kv-head smoke config of the
    dense and moe families at 4 ranks, and since the ranks may split the
    query heads, the dense ones at 8 (half a head a rank; this check
    refused 8 before that). It is still refused where the ranks do not divide H·hd (3 and
    6 ranks: 'qout': 256), by check_tp, init_cache and forward, and for
    the hybrid / encdec / ssm families at such counts."""
    smoke = [a for a in PORTED_ARCHS
             if CFG.get_smoke(a).arch_type in ("dense", "moe")]
    assert len(smoke) == 7
    for arch in smoke:
        cfg = torch_tp_ranks.smoke_cfg(arch)
        assert cfg.n_kv_heads == 2 and cfg.n_heads == 4
        check_tp(cfg, 4)
        check_tp(cfg, 2)
        if cfg.arch_type == "dense":        # the moe smokes' 4 experts
            check_tp(cfg, 8)
    cfg = torch_tp_ranks.smoke_cfg("gemma3-27b")        # 2 kv heads
    params = MB.materialize(TZ.templates(cfg),
                            torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for world in (6, 3):
        with pytest.raises(ValueError, match=rf'"tp" layout over {world} '
                                             r"ranks.*'qout': 256"):
            check_tp(cfg, world)
        mp = _rank(0, world)
        with pytest.raises(ValueError, match='"tp" layout'):
            TE.init_cache(cfg, 2, 16, device="cpu", mp=mp)
        with pytest.raises(ValueError, match='"tp" layout'):
            TZ.forward(params, cfg, {"tokens": tokens}, mp)
    for arch in ("rwkv6-1.6b", "zamba2-1.2b", "seamless-m4t-large-v2"):
        for world in (3, 16):
            with pytest.raises(ValueError, match="heads"):
                check_tp(torch_tp_ranks.smoke_cfg(arch), world)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_tp_refuses_the_families_of_later_slices(arch):
    """(The name is kept from when the sequence-sharded variants refused
    these families; the test now checks that they run them.) The ssm,
    hybrid and encdec families run the "tp" layout ("auto"):
    their smoke configs over 2 and 4 ranks and their full configs over 4
    pass `check_tp` and take a rank's cache. The sequence-sharded variants
    pass too: the hybrid and encdec families' K/V leaves take the "seq"
    cut (tests/test_torch_seq_families.py serves them), and the ssm
    family, with no attention to cut, runs them as "auto", its cache the
    same as under "auto"."""
    cfg = torch_tp_ranks.smoke_cfg(arch)
    for world in (2, 4):
        check_tp(cfg, world)
    check_tp(CFG.get(arch), 4)
    cache = TE.init_cache(cfg, 1, 8, 4, device="cpu", mp=_rank(0, 2))
    assert set(cache) == set(TE.cache_shapes(cfg, 1, 8, 4))
    for variant in ("seqkv", "shmap"):
        vcfg = dataclasses.replace(cfg, attn_shard=variant)
        check_tp(vcfg, 2)
        check_tp(dataclasses.replace(CFG.get(arch), attn_shard=variant), 4)
        seq = TE.init_cache(vcfg, 1, 8, 4, device="cpu", mp=_rank(0, 2))
        assert set(seq) == set(cache)
        for k, t in seq.items():
            if cfg.arch_type == "ssm" or k not in SH.KV_ENTRIES:
                assert t.shape == cache[k].shape, k
            else:
                assert t.shape[-3:] == (cache[k].shape[-3] // 2,
                                        cfg.n_kv_heads, cfg.hd), k


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_shard_params_blocks_tile_the_full_leaf(arch):
    """Under "tp" at world 2 every leaf's shards, laid side by side along
    the cut dim in rank order, are the full leaf bit for bit; a whole leaf
    is the same tensor on every rank. A Mamba2 mixer's in_proj / conv_w /
    conv_b (the leaves whose reference cut no rank can compute on) hold
    `parallel.rank_pieces`' head-aligned pieces instead: each rank's
    pieces, put where they are taken from, cover the leaf, and every
    element a rank holds is the leaf's."""
    cfg = torch_tp_ranks.smoke_cfg(arch)
    tmpl = TZ.templates(cfg)
    full = MB.materialize(tmpl, torch.Generator().manual_seed(1))
    layout = SH.param_layouts(tmpl, model_mesh(WORLD), "tp")
    shards = [MB.shard_params(full, tmpl, layout, _rank(r, WORLD))
              for r in range(WORLD)]
    pieces = [TPAR.rank_pieces(tmpl, layout, model_mesh(WORLD), r)
              for r in range(WORLD)]
    excepted = 0
    for leaf, spec, held, *parts in zip(
            MB.tree_leaves(full), MB.tree_leaves(layout),
            zip(*(MB.tree_leaves(p) for p in pieces)),
            *(MB.tree_leaves(s) for s in shards)):
        assert len(spec) == leaf.ndim
        if "model" not in spec:
            assert all(p is leaf for p in parts)
            continue
        dim = spec.index("model")
        if len(held[0][dim]) == 1:
            assert torch.equal(torch.cat(parts, dim), leaf)
        else:
            excepted += 1
            covered = torch.zeros(leaf.shape[dim], dtype=torch.bool)
            for part, mine in zip(parts, held):
                at = 0
                for s, m in mine[dim]:
                    assert torch.equal(part.narrow(dim, at, m),
                                       leaf.narrow(dim, s, m))
                    covered[s:s + m] = True
                    at += m
                assert at == part.shape[dim]
            assert bool(covered.all())
        assert parts[0].untyped_storage().data_ptr() \
            != leaf.untyped_storage().data_ptr()
    assert excepted == (3 if cfg.arch_type == "hybrid" else 0)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_materialize_shard_is_the_shard_of_materialize(arch, monkeypatch):
    """Each rank's `materialize_shard` equals `shard_params` of the whole
    `materialize` from the same seed bit for bit, in bf16, with the draw
    cut into many slices (a slice of ~1000 floats: leaves drawn row block
    by row block, the blocks crossing the shards' edges)."""
    monkeypatch.setattr(MB, "_DRAW_CHUNK", 1000)
    cfg = torch_tp_ranks.smoke_cfg(arch)
    tmpl = TZ.templates(cfg)
    full = MB.materialize(tmpl, torch.Generator().manual_seed(2),
                          torch.bfloat16)
    layout = SH.param_layouts(tmpl, model_mesh(WORLD), "tp")
    for r in range(WORLD):
        mp = _rank(r, WORLD)
        got = MB.materialize_shard(tmpl, torch.Generator().manual_seed(2),
                                   torch.bfloat16, layout, mp)
        want = MB.shard_params(full, tmpl, layout, mp)
        for a, b in zip(MB.tree_leaves(got), MB.tree_leaves(want)):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_cache_shapes_cut_the_kv_heads(arch):
    cfg = torch_tp_ranks.smoke_cfg(arch)
    full = TE.cache_shapes(cfg, 2, 48)
    local = TE.local_cache_shapes(cfg, 2, 48, _rank(1, WORLD))
    layouts = SH.cache_layouts(full, model_mesh(WORLD), policy="heads")
    assert set(full) == set(local)
    for k, (shape, dt) in full.items():
        want = shape[:-2] + (shape[-2] // WORLD, shape[-1])
        assert local[k] == (want, dt)
        # the reference's "heads" rule cuts the same dim
        assert tuple(n for _, n in TPAR.local_slices(
            shape, layouts[k], model_mesh(WORLD), 1)) == want


# (H, Hkv, hd) of the whole model, the cache's S and the (cache_len,
# window) pairs K8 is planned at: gemma3-27b's and dbrx-132b's decode
# attention, zamba2-1.2b's shared block over [ssm lm]'s cache of 512 + 32
# + 3 and seamless-m4t-large-v2's cross attention over its 4096 encoder
# frames (no window: cache_len S_enc - 1)
K8_RANK_CASES = {
    "gemma3": ((32, 16, 128), 2086, ((2047, ops.NO_WINDOW), (2047, 1024),
                                     (40, 1024))),
    "starcoder2": ((24, 2, 128), 2056, ((2055, ops.NO_WINDOW),
                                        (2047, ops.NO_WINDOW),
                                        (40, ops.NO_WINDOW))),
    "dbrx": ((48, 8, 128), 2086, ((2047, ops.NO_WINDOW), (2047, 1024),
                                  (40, 1024))),
    "zamba2": ((32, 32, 64), 547, ((543, ops.NO_WINDOW),
                                   (40, ops.NO_WINDOW))),
    "seamless-cross": ((16, 16, 64), 4096, ((4095, ops.NO_WINDOW),)),
}


@pytest.mark.parametrize("case", K8_RANK_CASES)
def test_k8_plan_and_plain_version_at_a_ranks_heads(case):
    """K8 at a rank's heads of gemma3-27b (8 q / 4 kv of 32 / 16),
    starcoder2-3b (6 / 1 of 24 / 2: the rank holds the one kv head its
    query heads read, `parallel.kv_heads`), dbrx-132b (12 / 2 of 48 / 8),
    zamba2-1.2b's shared block (8 / 8 of 32 / 32) and
    seamless-m4t-large-v2's cross attention (4 / 4 of 16 / 16) over 4
    ranks: the kernel instance (head group) is the full model's (for
    starcoder2-3b the group-8 instance, a rank's rep 6 in one block with 2
    heads masked, the full model's rep 12 in two blocks of 8), the plan
    fills at most one wave of an H100 (132 SMs, 2 blocks an SM) with at
    least the full model's splits, and the plain version on each rank's
    heads is that rank's slice of the full-head result bit for bit."""
    (h, hkv, hd), s, positions = K8_RANK_CASES[case]
    world = 4
    held = [TPAR.kv_heads(h, hkv, world, r) for r in range(world)]
    hl, hkvl = h // world, len(held[0])
    assert swa_kernel.head_group(hl // hkvl) == swa_kernel.head_group(
        h // hkv)
    if case == "starcoder2":
        assert held == [[0], [0], [1], [1]]
        assert swa_kernel.head_group(6) == swa_kernel.head_group(12) == 8
    for cache_len, window in positions:
        full = swa_kernel.plan(4, s, h, hkv, cache_len, window, 132, 2, 64)
        loc = swa_kernel.plan(4, s, hl, hkvl, cache_len, window, 132, 2, 64)
        assert loc["group"] == full["group"]
        assert loc["units"] * world == full["units"]
        assert loc["blocks"] <= 132 * 2 and loc["waves"] == 1
        assert loc["n_split"] >= full["n_split"]
        if case == "starcoder2":
            assert (loc["units"], full["units"]) == (4 * 1 * 1, 4 * 2 * 2)
            assert loc["n_split"] * loc["split_len"] >= cache_len + 1
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, h, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 70, hkv, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 70, hkv, 64)).astype(np.float32))
    want = ops.swa_decode(q, k, v, 60, window=32)
    for r in range(world):
        got = ops.swa_decode(q[:, r * hl:(r + 1) * hl], k[:, :, held[r]],
                             v[:, :, held[r]], 60, window=32)
        assert torch.equal(got, want[:, r * hl:(r + 1) * hl])
