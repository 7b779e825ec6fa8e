"""LM training under the reference's "zero3" layout (every weight cut on its
`embed` dim over all the mesh's axes, the compute whole on every rank, the
experts over "model") over a ("data", "model") mesh of gloo ranks on the
CPU (`zoo.train_step` with mp and a `parallel.TrainLayout`), against the
reference's unsharded, jitted `train_step` (float32, Adam lr 1e-3) on the
same numpy params and the launcher's batches (`lm_batch`, 4 x 16 tokens,
three steps).

  * The repair of `parallel.rank_pieces`: it gave a Mamba2 mixer's
    in_proj / conv_w / conv_b their "tp" pieces and an attention's wk /
    wv the columns of the rank's kv heads wherever the "model" axis had
    more than one rank, whatever the layout, so a "zero3" rank over
    "model" ranks that do not divide the kv heads held, and trained, part
    of its K/V projection. starcoder2-smoke and dbrx-smoke (2 kv heads)
    over 1 x 4 ranks against the reference (these two cases fail on the
    code before the repair); over every arch's published config at model
    2, 4, 8 and 16 no leaf is held in part along a dim its zero3 layout
    keeps whole (the counting transport's meta inputs), and a rank's dot
    FLOPs of a zero3 step equal the one-card step's for every family
    without experts.
  * The ssm (rwkv6), hybrid (zamba2) and encdec (seamless) families under
    "zero3" at (2, 2), (4, 1) and (1, 4): rwkv6-smoke and zamba2-smoke in
    both ssm_impl forms, zamba2 at 4 layers (its shared block applied
    twice: the weights gathered at each application, their gradients
    summed over both through the reduce-scatters), seamless-smoke (its
    encoder output feeding every decoder layer's cross K/V). Params and
    the reference's per-step states as tests/test_torch_train_families.py
    makes them (`_reference`: perturbed params, every step after the
    first taken from the reference's state).

Bars (tests/test_torch_fsdp.py's): losses rtol / atol 1e-5 every step;
each step's gathered Adam m within 1e-3 of each leaf's largest of the
reference's; shards gather back bit for bit; every two ranks holding the
same pieces of a leaf hold the same bits of it in params, m and v after
the last step (the leaves zero3 keeps whole — the norms, RWKV-6's small
vectors, Mamba2's D / A_log / dt_bias / conv — on every rank, which needs
their gradients summed over "data", `reduce_replicated_grads`); each
rank's params + m + v hold its layout's bytes; no gathered weight
outlives the forward (`regather_saved`).

Collectives a step (`ModelParallel.calls`), per rank, on a (D, M) mesh,
N = D x M, U = the leaf-uses the layout cuts (over all N ranks; none
where N = 1): a stacked leaf of "blocks" L uses, of "enc_blocks" the
encoder's layers, of zamba2's shared block one per application, `embed`
and `head` one each:
  all_gather     = U (forward) + U - 1 (the backward gathers again each
                   weight an op saved: all but `embed`)
  reduce_scatter = U where D > 1 (over one data rank each rank takes its
                   block of the gradient, nothing moves)
  all_reduce_sum = 2 where D > 1 (the loss; the gradients of the leaves
                   not cut), + 3 per moe layer over M > 1 and 1 per moe
                   layer over D > 1 (tests/test_torch_fsdp.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as TCFG
from repro.models import zoo as JZ
from repro.optim import adam as jadam
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as TLT
from repro_torch.launch.mesh import spawn_ranks, train_mesh
from repro_torch.models import base as MB
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as TZ
from repro_torch.optim import adam as tadam
from test_torch_train_families import ARCHS, _reference
from torch_parity import close, dense_model
import torch_tp_ranks

MESHES = [(2, 2), (4, 1), (1, 4)]
FAMILY_CASES = [(name, mesh) for mesh in MESHES for name in ARCHS]
# the repair's cases: 2 kv heads over 4 "model" ranks (dbrx-smoke at
# capacity 1.0, which drops choices)
KV_ARCHS = {"starcoder2-3b": None, "dbrx-132b": 1.0}
KV_MESH = (1, 4)
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
LOSS_TOL = 1e-5
REF_M_TOL = 1e-3


def _id(case):
    name, (d, m) = case
    return f"{name}-{d}x{m}"


def _overrides(name) -> dict:
    _, impl, layers = ARCHS[name]
    return {"ssm_impl": impl, **({"n_layers": layers} if layers else {})}


def _dense_reference(arch):
    """The reference's three chained steps of the arch's smoke config from
    its `materialize` (losses, step 1's m) and the ranks' inputs."""
    jcfg, tcfg, jp, _ = dense_model(arch)
    cf = KV_ARCHS[arch]
    if cf:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    rng = np.random.default_rng(0)
    batches = [{k: v.numpy() for k, v in
                TLT.lm_batch(tcfg, rng, BATCH, SEQ, "cpu").items()}
               for _ in range(STEPS)]
    out = dict(cfg=tcfg, params_np=jax.device_get(jp), batches=batches,
               losses=[])
    jo = jadam(LR)
    js = jo.init(jp)
    step = jax.jit(lambda p, o, b: JZ.train_step(p, o, b, jcfg, jo.update))
    for i, b in enumerate(batches):
        jp, js, jl = step(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        out["losses"].append(float(jl))
        if i == 0:
            out["m1"] = jax.tree_util.tree_leaves(jax.device_get(js["m"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero3")
    refs = {name: _reference(name, tmp) for name in ARCHS}
    kv_refs = {arch: _dense_reference(arch) for arch in KV_ARCHS}
    ranks = {}
    for d, m in MESHES:
        cases = [(name, ARCHS[name][0], "zero3", _overrides(name),
                  refs[name]["params_np"], refs[name]["batches"], LR,
                  refs[name]["states"]) for name in ARCHS]
        if (d, m) == KV_MESH:
            cases += [(arch, arch, "zero3",
                       {"capacity_factor": cf} if cf else {},
                       kv_refs[arch]["params_np"], kv_refs[arch]["batches"],
                       LR) for arch, cf in KV_ARCHS.items()]
        kept = [(name, ARCHS[name][0], _overrides(name),
                 refs[name]["params_np"], refs[name]["batches"][0])
                for name in ("rwkv6-chunked", "zamba2-scan", "seamless")]
        ranks[(d, m)] = spawn_ranks(
            d * m, torch_tp_ranks.zero3_train_rank, (cases, kept),
            mesh=train_mesh(d, m), device="cpu", timeout_s=600)
    return refs, kv_refs, ranks


def _case(runs, case):
    name, mesh = case
    refs, _, ranks = runs
    return refs[name], [r[name] for r in ranks[mesh]]


# -- the repair ---------------------------------------------------------------

@pytest.mark.parametrize("arch", KV_ARCHS)
def test_zero3_step_over_undivided_kv_heads_matches_the_reference(runs,
                                                                  arch):
    """2 kv heads over 4 "model" ranks: every rank's losses are the
    reference's unsharded step's, step 1's gathered m within 1e-3 of each
    leaf's largest, the shards gather back, and each rank holds the zero3
    block of wk / wv (all their columns)."""
    _, kv_refs, ranks = runs
    ref = kv_refs[arch]
    got = [r[arch] for r in ranks[KV_MESH]]
    for rank in got:
        close(np.asarray(rank["losses"]), np.asarray(ref["losses"]),
              LOSS_TOL, LOSS_TOL)
        assert rank["round_trip"] and rank["gathers_back"]
    got_m = list(MB.tree_leaves(got[0]["m1"]))
    assert len(got_m) == len(ref["m1"])
    for a, want in zip(got_m, ref["m1"]):
        close(a, want, rtol=0, atol=REF_M_TOL * float(np.abs(want).max()))
    cfg = ref["cfg"]
    tmpl = TZ.templates(cfg)
    mesh = train_mesh(*KV_MESH)
    specs = SH.param_layouts(tmpl, mesh, "zero3")
    for r in range(mesh.size):
        attn = TPAR.rank_pieces(tmpl, specs, mesh, r)["blocks"]["attn"]
        for k in ("wk", "wv"):
            assert attn[k][-1] == [(0, cfg.n_kv_heads * cfg.hd)], (k, r)


def _zero3_whole_dims(cfg, mesh) -> list:
    """(leaf, rank, dim) of every dim of every rank's pieces that its
    zero3 layout keeps whole but the rank holds in part."""
    tmpl = TZ.templates(cfg)
    specs = SH.param_layouts(tmpl, mesh, "zero3")
    bad = []
    for r in range(mesh.shape["model"]):
        mp = TPAR.ModelParallel.counting(mesh, r)
        args = D.step_inputs(cfg, "train", mp, batch=mesh.shape["data"],
                             seq_len=cfg.frontend_positions + 8, specs=specs)
        for i, (t, spec, leaf) in enumerate(zip(
                MB.tree_leaves(tmpl), MB.tree_leaves(specs),
                MB.tree_leaves(args["params"]))):
            want = [m for _, m in TPAR.local_slices(t.shape, spec, mesh, r)]
            for dim, axes in enumerate(spec):
                if axes is None and leaf.shape[dim] != t.shape[dim]:
                    bad.append((i, r, dim))
            assert list(leaf.shape) == want, (cfg.name, i, r)
    return bad


@pytest.mark.parametrize("model", [2, 4, 8, 16])
def test_zero3_ranks_hold_whole_every_dim_the_layout_keeps_whole(model):
    """Every arch's published config over 1 x model ranks on the counting
    transport: each rank's meta params (`dryrun.step_inputs`) are the
    zero3 layout's blocks, so no leaf is held in part along a dim the
    layout keeps whole (before the repair: Mamba2's in_proj / conv_w /
    conv_b, and wk / wv wherever model does not divide the kv heads)."""
    mesh = train_mesh(1, model)
    for arch_id in TCFG.ARCH_IDS:
        cfg = TCFG.get(arch_id)
        assert _zero3_whole_dims(cfg, mesh) == [], arch_id


@pytest.mark.parametrize("arch", ["starcoder2-3b", "yi-34b", "rwkv6-1.6b",
                                  "zamba2-1.2b", "seamless-m4t-large-v2"])
def test_zero3_rank_computes_the_whole_step(arch):
    """A zero3 rank over 1 x 4 (one data rank: the whole batch) runs the
    one-card step: its meta trace's dot FLOPs equal the unsharded
    trace's (the probe that found the fault read 0.9385 of them for
    starcoder2-smoke)."""
    cfg = torch_tp_ranks.smoke_cfg(arch)
    mesh = train_mesh(*KV_MESH)
    layout = TPAR.TrainLayout("zero3", SH.param_layouts(TZ.templates(cfg),
                                                        mesh, "zero3"))
    one = D.rank_record(cfg, "train", batch=2, seq_len=16)
    for r in range(mesh.size):
        rec = D.rank_record(cfg, "train", TPAR.ModelParallel.counting(mesh, r),
                            batch=2, seq_len=16, layout=layout)
        assert rec["dot_flops_per_device"] == one["dot_flops_per_device"]


def test_shared_leaves_name_the_leaves_zero3_keeps_whole():
    """`launch.train.shared_leaves` under zero3 over 1 x 4 (starcoder2-
    smoke, 2 kv heads): exactly the leaves no axis cuts (the norms), every
    rank holding the same pieces of each; wk / wv, cut over the ranks on
    their embed dim, are not among them."""
    cfg = torch_tp_ranks.smoke_cfg("starcoder2-3b")
    tmpl = TZ.templates(cfg)
    mesh = train_mesh(*KV_MESH)
    specs = SH.param_layouts(tmpl, mesh, "zero3")
    whole = [i for i, s in enumerate(MB.tree_leaves(specs))
             if TPAR.data_cut(s) is None]
    paths = list(_paths(tmpl))
    assert whole and all("norm" in paths[i] or paths[i].endswith("ln1")
                         or paths[i].endswith("ln2") for i in whole)
    for r in range(mesh.size):
        assert TLT.shared_leaves(tmpl, specs, mesh, r) == whole


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/")


# -- the ssm, hybrid and encdec families ---------------------------------------

@pytest.mark.parametrize("case", FAMILY_CASES, ids=_id)
def test_zero3_family_losses_match_the_reference_every_step(runs, case):
    ref, got = _case(runs, case)
    for rank in got:
        close(np.asarray(rank["losses"]), np.asarray(ref["losses"]),
              LOSS_TOL, LOSS_TOL)
        assert rank["step"] == STEPS


@pytest.mark.parametrize("case", FAMILY_CASES, ids=_id)
def test_zero3_family_first_moment_matches_the_reference(runs, case):
    """Each step's m gathered from the shards: within 1e-3 of each leaf's
    largest of the reference's."""
    ref, got = _case(runs, case)
    assert len(got[0]["ms"]) == len(ref["ms"]) == STEPS
    for got_tree, want_m in zip(got[0]["ms"], ref["ms"]):
        got_m = list(MB.tree_leaves(got_tree))
        assert len(got_m) == len(want_m)
        for a, want in zip(got_m, want_m):
            close(a, want, rtol=0,
                  atol=REF_M_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("case", FAMILY_CASES, ids=_id)
def test_zero3_family_shards_gather_back_bit_for_bit(runs, case):
    _, got = _case(runs, case)
    for rank in got:
        assert rank["round_trip"] and rank["gathers_back"]


def _pieces(cfg, mesh) -> list[list]:
    """Per rank, per leaf (tree order), the pieces it holds under zero3."""
    tmpl = TZ.templates(cfg)
    mesh_shape = train_mesh(*mesh)
    specs = SH.param_layouts(tmpl, mesh_shape, "zero3")
    return [list(MB.tree_leaves(TPAR.rank_pieces(tmpl, specs, mesh_shape,
                                                 r)))
            for r in range(mesh_shape.size)]


@pytest.mark.parametrize("case", FAMILY_CASES, ids=_id)
def test_zero3_family_ranks_sharing_a_piece_hold_equal_bits(runs, case):
    """Every two ranks holding the same pieces of a leaf (the leaves zero3
    keeps whole, on every rank) hold the same bits of it in params, m and
    v after the steps."""
    ref, got = _case(runs, case)
    _, mesh = case
    pieces = _pieces(ref["cfg"], mesh)
    shared = 0
    for leaf in range(len(pieces[0])):
        groups = {}
        for r, held in enumerate(pieces):
            groups.setdefault(repr(held[leaf]), []).append(r)
        for members in groups.values():
            if len(members) > 1:
                shared += 1
                for kind in ("params", "m", "v"):
                    assert len({got[r]["digests"][kind][leaf]
                                for r in members}) == 1, (leaf, kind)
    assert shared > 0


@pytest.mark.parametrize("case", FAMILY_CASES, ids=_id)
def test_zero3_family_state_bytes_equal_the_layout_sum(runs, case):
    """Each rank's params + m + v: 3 x 4 bytes x, per leaf, its elements
    over the product of the sizes of the axes its layout cuts it over."""
    ref, got = _case(runs, case)
    _, mesh = case
    mesh_shape = train_mesh(*mesh)
    tmpl = TZ.templates(ref["cfg"])
    specs = SH.param_layouts(tmpl, mesh_shape, "zero3")
    want = 0
    for t, spec in zip(MB.tree_leaves(tmpl), MB.tree_leaves(specs)):
        cut = 1
        for axes in spec:
            for a in (axes,) if isinstance(axes, str) else (axes or ()):
                cut *= mesh_shape.shape[a]
        want += int(np.prod(t.shape)) // cut
    for rank in got:
        assert rank["state_bytes"] == 3 * 4 * want
    assert want < ref["cfg"].param_count()


def _uses(cfg, specs) -> int:
    """The module docstring's U."""
    per = {"blocks": cfg.n_layers, "enc_blocks": cfg.n_enc_layers,
           "shared_attn": (TZ.shared_applications(cfg)
                           if cfg.arch_type == "hybrid" else 0)}
    return sum(per.get(k, 1) * sum(TPAR.data_cut(s) is not None
                                   for s in MB.tree_leaves(
                                       spec if isinstance(spec, dict)
                                       else {k: spec}))
               for k, spec in specs.items())


def _calls_per_step(cfg, mesh) -> dict:
    """The module docstring's formula."""
    d, m = mesh
    specs = SH.param_layouts(TZ.templates(cfg), train_mesh(d, m), "zero3")
    u = _uses(cfg, specs) if d * m > 1 else 0
    moe = cfg.n_layers if cfg.arch_type == "moe" else 0
    out = {"all_gather": 2 * u - 1 if u else 0,
           "reduce_scatter": u if d > 1 else 0,
           "all_reduce_sum": (2 + moe if d > 1 else 0)
           + (3 * moe if m > 1 else 0)}
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("case", FAMILY_CASES, ids=_id)
def test_zero3_family_collectives_per_step_follow_the_formula(runs, case):
    ref, got = _case(runs, case)
    want = _calls_per_step(ref["cfg"], case[1])
    assert want["all_gather"] > 0
    for rank in got:
        for calls in rank["calls"]:
            assert calls == want


@pytest.mark.parametrize("arch", KV_ARCHS)
def test_zero3_kv_collectives_per_step_follow_the_formula(runs, arch):
    _, kv_refs, ranks = runs
    want = _calls_per_step(kv_refs[arch]["cfg"], KV_MESH)
    for rank in ranks[KV_MESH]:
        for calls in rank[arch]["calls"]:
            assert calls == want


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_zero3_family_gathered_weights_are_not_kept_for_the_backward(
        runs, mesh):
    """After a zero3 training forward of rwkv6-chunked, zamba2 (4 layers)
    and seamless under `regather_saved` no weight it gathered is alive;
    registered without the hooks, the ops keep them."""
    _, _, ranks = runs
    for rank in ranks[mesh]:
        assert set(rank["kept"]) == {"rwkv6-chunked", "zamba2-scan",
                                     "seamless"}
        for kept in rank["kept"].values():
            assert kept[True] == 0 and kept[False] > 0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_check_train_lets_the_families_train_under_zero3(arch):
    """"zero3" trains every family; "fsdp" stays the dense and moe
    families' (ROADMAP item 29)."""
    cfg = TCFG.get_smoke(arch)
    TPAR.check_train(cfg, train_mesh(2, 2), "zero3")
    with pytest.raises(ValueError, match="item 29"):
        TPAR.check_train(cfg, train_mesh(2, 2), "fsdp")


def test_zero3_unsharded_port_matches_its_ranks(runs):
    """The port's own unsharded step on zamba2 (4 layers, two shared-block
    applications) gives the ranks' first loss (tp, fsdp and zero3 all hold
    the unsharded step)."""
    refs, _, ranks = runs
    ref = refs["zamba2-scan"]
    cfg = ref["cfg"]
    params = TZ.params_from_numpy(ref["params_np"], cfg, device="cpu")
    opt = tadam(LR)
    _, _, loss = TZ.train_step(params, opt.init(params),
                               {k: torch.from_numpy(v) for k, v in
                                ref["batches"][0].items()}, cfg, opt.update)
    for mesh in MESHES:
        for rank in ranks[mesh]:
            close(np.asarray(rank["zamba2-scan"]["losses"][0]),
                  np.asarray(float(loss)), LOSS_TOL, LOSS_TOL)
