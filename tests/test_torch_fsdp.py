"""LM training over a ("data", "model") mesh of gloo ranks on the CPU
(`zoo.train_step` with mp and a `parallel.TrainLayout`) under the
reference's "tp", "fsdp" and "zero3" layouts, against the reference's
unsharded, jitted `train_step` (float32, Adam lr 1e-3) on the same numpy
params (its `materialize`) and the launcher's batches (`lm_batch`, 4 x 16
tokens, three steps): yi-smoke, gemma3-smoke (windows, qk_norm) and
dbrx-smoke at capacity factor 1.0 (ARCHS), where the reference drops
choices. Meshes: "tp" at (1, 2); "fsdp" and "zero3" at (2, 2) and (4, 1).
One spawn per mesh runs every case (`launch.mesh.spawn_ranks`; rank
functions in torch_tp_ranks.py).

Bars: losses rtol / atol 1e-5 every step; step 1's gathered Adam m within
1e-3 of each leaf's largest of the reference's (its gradients through m =
(1 - b1) g; test_torch_moe's bar) and within 1e-5 of the port's own
unsharded step's; dropped-choice sets exactly, in every (step, layer)
where the reference's router leaves every token a margin of ROUTE_MARGIN
(some must, with drops); shards gather back bit for bit; every rank holds
the same bits of each leaf piece it shares with another rank; each rank's
params + m + v hold its layout's bytes; no gathered weight outlives its
forward.

Collectives a step (`ModelParallel.calls`), per rank, on a (D, M) mesh,
L layers, U = the leaf-uses the layout cuts over "data" (a stacked leaf
L uses, `embed` and `head` one each; none where D = 1), "tensor" the tp
and fsdp layouts with M > 1, V = 1 where the vocabulary is cut:
  all_gather     = U (forward) + U - 1 (the backward gathers again each
                   weight an op saved, every one but `embed`, which the
                   lookup does not save) + V (the logits, under tensor)
  reduce_scatter = U
  all_reduce_sum = under tensor: V (the embedding's sum) + 1 (the head's
                   input, backward) + per layer 2 forward (attention's
                   and the MLP's or the experts' partial sums) + 2
                   backward for a dense layer (their inputs) or 3 for a
                   moe one (attention's input, the experts' tokens and
                   gates), + 2 backward for qk_norm's q_norm / k_norm;
                   under zero3 with M > 1: per moe layer 1 forward + 2
                   backward (the experts alone run over "model");
                 + where D > 1: 1 (the loss) + 1 (the gradients of the
                   leaves not cut over "data") + 1 per moe layer (the
                   dispatch's counts and the aux's sums);
                 + remat's recompute of each layer in the backward: under
                   tensor 1 (attention's partial sum; the MLP's or the
                   experts' follows the last tensor the backward reads,
                   and is not summed again), where D > 1 1 per moe layer
                   (the dispatch's sums). Its gathers of the layer's
                   weights stand for the backward's gathers again above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import zoo as JZ
from repro.optim import adam as jadam
from repro_torch import configs as TCFG
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as TLT
from repro_torch.launch.mesh import spawn_ranks, train_mesh
from repro_torch.models import base as MB
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as TZ
from repro_torch.optim import adam as tadam
from torch_parity import close, dense_model
import torch_tp_ranks

ARCHS = {"yi-34b": None, "gemma3-27b": None, "dbrx-132b": 1.0}
MESHES = {(1, 2): ("tp",), (2, 2): ("fsdp", "zero3"),
          (4, 1): ("fsdp", "zero3")}
CASES = [(arch, mode, mesh) for mesh, modes in MESHES.items()
         for mode in modes for arch in ARCHS]
MOE_CASES = [c for c in CASES if c[0] == "dbrx-132b"]
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
LOSS_TOL = 1e-5
REF_M_TOL, OWN_M_TOL = 1e-3, 1e-5
ROUTE_MARGIN = 1e-5


def _id(case):
    arch, mode, (d, m) = case
    return f"{arch}-{mode}-{d}x{m}"


def _batches(tcfg):
    rng = np.random.default_rng(0)
    return [{k: v.numpy() for k, v in
             TLT.lm_batch(tcfg, rng, BATCH, SEQ, "cpu").items()}
            for _ in range(STEPS)]


def _reference_keeps(jp, jcfg, jb) -> list:
    """The reference's (probs, kept choices) of every moe layer of its
    forward on jb, recorded from inside its scan by a debug callback
    around `layers.moe_ffn` (its own dispatch lines)."""
    seen = []
    orig = JL.moe_ffn

    def recorded(p, cfg, x):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), -1)
        _, gate_i = jax.lax.top_k(probs, cfg.top_k)
        flat_e = gate_i.reshape(-1)
        onehot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                                  flat_e[:, None], axis=1)[:, 0]
        cap = int(max(1, np.ceil(cfg.capacity_factor * xt.shape[0]
                                 * cfg.top_k / cfg.n_experts)))
        jax.debug.callback(lambda a, b: seen.append((np.asarray(a),
                                                     np.asarray(b))),
                           probs, pos < cap, ordered=True)
        return orig(p, cfg, x)

    JL.moe_ffn = recorded
    try:
        jax.block_until_ready(JZ.forward(jp, jcfg, jb))
        jax.effects_barrier()
    finally:
        JL.moe_ffn = orig
    return seen


def _reference(arch):
    """The reference's three steps (losses, step 1's m, each step's moe
    dispatch) and the port's unsharded ones (losses, step 1's m)."""
    jcfg, tcfg, jp, tp = dense_model(arch)
    cf = ARCHS[arch]
    if cf:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    params_np = jax.device_get(jp)
    batches = _batches(tcfg)
    jo, to = jadam(LR), tadam(LR)
    js, ts = jo.init(jp), to.init(tp)
    step = jax.jit(lambda p, o, b: JZ.train_step(p, o, b, jcfg, jo.update))
    out = dict(cfg=tcfg, params_np=params_np, batches=batches, losses=[],
               own_losses=[], keeps=[])
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if cf:
            out["keeps"].append(_reference_keeps(jp, jcfg, jb))
        jp, js, jl = step(jp, js, jb)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tp, ts, tl = TZ.train_step(tp, ts, tb, tcfg, to.update)
        out["losses"].append(float(jl))
        out["own_losses"].append(float(tl))
        if i == 0:
            out["m1"] = jax.tree_util.tree_leaves(jax.device_get(js["m"]))
            out["own_m1"] = [a.numpy().copy()
                             for a in MB.tree_leaves(ts["m"])]
    return out


@pytest.fixture(scope="module")
def runs():
    refs = {arch: _reference(arch) for arch in ARCHS}
    ranks = {}
    for (d, m), modes in MESHES.items():
        cases = [(f"{arch}-{mode}", arch, mode,
                  {"capacity_factor": ARCHS[arch]} if ARCHS[arch] else {},
                  refs[arch]["params_np"], refs[arch]["batches"], LR)
                 for mode in modes for arch in ARCHS]
        kept = ("dbrx-132b", modes[-1], refs["dbrx-132b"]["params_np"],
                refs["dbrx-132b"]["batches"][0]) if d > 1 else None
        launcher = ("dbrx-132b", modes[-1], 2, BATCH, SEQ, 0) \
            if (d, m) == (2, 2) else None
        ranks[(d, m)] = spawn_ranks(
            d * m, torch_tp_ranks.train_rank, (cases, kept, launcher),
            mesh=train_mesh(d, m), device="cpu", timeout_s=300)
    return refs, ranks


def _case(runs, case):
    arch, mode, mesh = case
    refs, ranks = runs
    return refs[arch], [r[f"{arch}-{mode}"] for r in ranks[mesh]]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_losses_match_the_reference_every_step(runs, case):
    ref, got = _case(runs, case)
    for rank in got:
        close(np.asarray(rank["losses"]), np.asarray(ref["losses"]),
              LOSS_TOL, LOSS_TOL)
        assert rank["step"] == STEPS


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_first_moment_matches_the_reference(runs, case):
    """Step 1's m = (1 - b1) g, gathered from the shards: within 1e-3 of
    each leaf's largest of the reference's."""
    ref, got = _case(runs, case)
    got_m = list(MB.tree_leaves(got[0]["m1"]))
    assert len(got_m) == len(ref["m1"])
    for a, want in zip(got_m, ref["m1"]):
        close(a, want, rtol=0, atol=REF_M_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_first_moment_matches_the_unsharded_port(runs, case):
    """Step 1's gathered m within 1e-5 of each leaf's largest of the
    port's own unsharded `train_step` on the same params and batch."""
    ref, got = _case(runs, case)
    for a, want in zip(MB.tree_leaves(got[0]["m1"]), ref["own_m1"]):
        close(a, want, rtol=0, atol=OWN_M_TOL * float(np.abs(want).max()))
    close(np.asarray(ref["own_losses"]), np.asarray(ref["losses"]),
          LOSS_TOL, LOSS_TOL)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_shards_gather_back_bit_for_bit(runs, case):
    """The initial params shard and gather back to themselves, and the
    trained shards gather and shard back to themselves, bit for bit."""
    _, got = _case(runs, case)
    for rank in got:
        assert rank["round_trip"] and rank["gathers_back"]


def _pieces(cfg, mode, mesh) -> list[list]:
    """Per rank, per leaf (tree order), the pieces it holds."""
    tmpl = TZ.templates(cfg)
    mesh_shape = train_mesh(*mesh)
    specs = SH.param_layouts(tmpl, mesh_shape, mode)
    return [_leaf_pieces(TPAR.rank_pieces(tmpl, specs, mesh_shape, r))
            for r in range(mesh_shape.size)]


def _leaf_pieces(tree) -> list:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_pieces(tree[k])]
    return [tree]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_ranks_sharing_a_piece_hold_equal_bits(runs, case):
    """After the steps, every rank holding a piece of a leaf that another
    rank holds too (the norms on every rank; fsdp's router on the ranks of
    a data row; everything along "model" under zero3) holds the same bits
    of it, in params, m and v."""
    ref, got = _case(runs, case)
    arch, mode, mesh = case
    pieces = _pieces(ref["cfg"], mode, mesh)
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


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_state_bytes_equal_the_layout_sum(runs, case):
    """Each rank's params + m + v: 3 x 4 bytes x, per leaf, its elements
    over the product of the sizes of the mesh axes its layout cuts it
    over (no rank holds more, none less)."""
    ref, got = _case(runs, case)
    arch, mode, mesh = case
    mesh_shape = train_mesh(*mesh)
    tmpl = TZ.templates(ref["cfg"])
    specs = SH.param_layouts(tmpl, mesh_shape, mode)
    want = 0
    for t, spec in zip(MB.tree_leaves(tmpl), MB.tree_leaves(specs)):
        cut = 1
        for axes in spec:
            for a in (axes,) if isinstance(axes, str) else (axes or ()):
                cut *= mesh_shape.shape[a]
        want += int(np.prod(t.shape)) // cut
    for rank in got:
        assert rank["state_bytes"] == 3 * 4 * want
    assert want < ref["cfg"].param_count() or mesh == (1, 1)


def _calls_per_step(cfg, mode, mesh) -> dict:
    """The module docstring's formula."""
    d, m = mesh
    specs = SH.param_layouts(TZ.templates(cfg), train_mesh(d, m), mode)
    uses = 0
    if d > 1:
        for k, spec in specs.items():
            tree = spec if isinstance(spec, dict) else {k: spec}
            n = cfg.n_layers if k == "blocks" else 1
            uses += n * sum(TPAR.data_cut(s) is not None
                            for s in MB.tree_leaves(tree))
    tensor = mode != "zero3" and m > 1
    vocab = int(tensor and specs["embed"][0] == "model")
    moe = cfg.arch_type == "moe"
    ar = 0
    if tensor:
        ar = vocab + 1 + cfg.n_layers * (2 + (3 if moe else 2)
                                         + 2 * cfg.qk_norm + 1)
    elif moe and m > 1:
        ar = cfg.n_layers * 3
    if d > 1:
        ar += 2 + (2 * cfg.n_layers if moe else 0)
    out = {"all_gather": 2 * uses - (1 if uses else 0) + vocab,
           "reduce_scatter": uses, "all_reduce_sum": ar}
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_collectives_per_step_follow_the_formula(runs, case):
    ref, got = _case(runs, case)
    arch, mode, mesh = case
    want = _calls_per_step(ref["cfg"], mode, mesh)
    for rank in got:
        for calls in rank["calls"]:
            assert calls == want


@pytest.mark.parametrize("case", MOE_CASES, ids=_id)
def test_dropped_choices_match_the_reference(runs, case):
    """The choices each moe layer keeps, over the whole batch (the data
    ranks' in order), are the reference's in every (step, layer) where its
    router leaves every token a margin; the reference drops some."""
    ref, got = _case(runs, case)
    arch, mode, (d, m) = case
    cfg = ref["cfg"]
    compared = dropped = 0
    for step, layers in enumerate(ref["keeps"]):
        assert len(layers) == cfg.n_layers
        for layer, (probs, keep) in enumerate(layers):
            top = np.sort(probs, axis=-1)[:, ::-1]
            if (top[:, cfg.top_k - 1] - top[:, cfg.top_k]
                    <= ROUTE_MARGIN).any():
                continue
            for col in range(m):
                mine = np.concatenate([got[r * m + col]["keeps"][step][layer]
                                       for r in range(d)])
                np.testing.assert_array_equal(mine, keep)
            compared += 1
            dropped += int((~keep).sum())
    assert compared > 0 and dropped > 0


@pytest.mark.parametrize("mesh", list(MESHES), ids=lambda m: f"{m[0]}x{m[1]}")
def test_gathered_weights_are_not_kept_for_the_backward(runs, mesh):
    """After a training forward under `regather_saved` no weight it
    gathered for use is alive (each op saved the shard); registered
    without the hooks, the ops keep them. Where the mesh has one data
    rank nothing is gathered."""
    _, ranks = runs
    for rank in ranks[mesh]:
        if mesh[0] == 1:
            assert "kept" not in rank
            assert all("reduce_scatter" not in calls for case in
                       rank.values() for calls in case["calls"])
            continue
        assert rank["kept"][True] == 0 and rank["kept"][False] > 0


def test_launcher_rank_trains_as_the_launcher(runs, capsys):
    """`launch.train.train_lm_rank` (dbrx-smoke, zero3 over 2 x 2, two
    steps) gives `launch.train`'s --target lm losses, and reports its
    state bytes, collectives and seconds a step."""
    _, ranks = runs
    want = TLT.main(["--target", "lm", "--arch", "dbrx-132b", "--smoke",
                     "--steps", "2", "--batch", str(BATCH), "--seq",
                     str(SEQ), "--lr", str(LR), "--device", "cpu"])
    capsys.readouterr()
    for rank in ranks[(2, 2)]:
        got = rank["launcher"]
        close(np.asarray(got["losses"]), np.asarray(want), LOSS_TOL,
              LOSS_TOL)
        assert got["backend"] == "gloo" and got["peak_bytes"] is None
        assert got["state_bytes"] > 0 and len(got["seconds"]) == 2
        assert got["calls"][0] == got["calls"][1] and got["calls"][0].get(
            "reduce_scatter")


REFUSED = [("rwkv6-1.6b", {}, (2, 2), "fsdp", "families"),
           ("zamba2-1.2b", {}, (2, 2), "fsdp", "families"),
           ("seamless-m4t-large-v2", {}, (1, 2), "fsdp", "families"),
           ("yi-34b", {"attn_shard": "shmap"}, (2, 2), "zero3", "shmap"),
           ("dbrx-132b", {"attn_shard": "seqkv"}, (1, 2), "tp", "seqkv"),
           ("yi-34b", {}, (1, 3), "fsdp", "divide"),
           ("dbrx-132b", {}, (2, 3), "zero3", "divide"),
           ("gemma3-27b", {}, (2, 2), "shard", "layout")]


@pytest.mark.parametrize("arch,kw,mesh,mode,why", REFUSED,
                         ids=[f"{r[0]}-{r[4]}" for r in REFUSED])
def test_check_train_refuses(arch, kw, mesh, mode, why):
    """check_train refuses the ssm, hybrid and encdec families under
    "fsdp" ("tp" trains them: tests/test_torch_train_families.py; "zero3"
    too since it runs them whole: tests/test_torch_zero3.py, and the
    zamba2 and seamless cases here refused it before), "seqkv" and
    "shmap" under zero3
    ("shmap" trains under "tp" and "fsdp" since the reference's pod dry
    run does: tests/test_torch_shmap_train.py; this case refused it under
    "fsdp" before), "seqkv" anywhere, a "model" axis check_tp refuses (3
    ranks over 4 heads' 256 columns, and over 4 experts; 8 ranks, which
    this case took before, now split the heads) and an unknown layout,
    and the training forward refuses them too."""
    cfg = dataclasses.replace(TCFG.get_smoke(arch), **kw)
    with pytest.raises(ValueError, match=cfg.name):
        TPAR.check_train(cfg, train_mesh(*mesh), mode)
    if why != "layout":
        mp = TPAR.ModelParallel(rank=0, world=mesh[1], mesh=train_mesh(*mesh),
                                backend="gloo", data_world=mesh[0])
        with pytest.raises(ValueError, match=cfg.name):
            TZ.forward({}, cfg, {}, mp, TPAR.TrainLayout(mode, {}))


def test_batch_rows_refuses_a_batch_the_data_ranks_do_not_divide():
    batch = {"tokens": torch.zeros((3, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="3 rows"):
        TLT.batch_rows(batch, train_mesh(2, 1), 0)
    rows = TLT.batch_rows({"tokens": torch.arange(8).view(4, 2)},
                          train_mesh(2, 2), 3)
    assert rows["tokens"].tolist() == [[4, 5], [6, 7]]


def test_launcher_rank_digests_the_leaves_ranks_share(runs):
    """`train_lm_rank` (dbrx-smoke, zero3 over 2 x 2) returns a digest of
    each leaf of params, m and v that another rank holds the same pieces
    of (`launch.train.shared_leaves`: the norms, and under zero3 the
    experts along "data"), and every two ranks sharing one hold equal
    digests of it."""
    _, ranks = runs
    cfg = TLT.lm_config("dbrx-132b", True, 0)
    tmpl = TZ.templates(cfg)
    mesh = train_mesh(2, 2)
    specs = SH.param_layouts(tmpl, mesh, "zero3")
    pieces = _pieces(cfg, "zero3", (2, 2))
    got = [rank["launcher"]["digests"] for rank in ranks[(2, 2)]]
    for r, digests in enumerate(got):
        shared = TLT.shared_leaves(tmpl, specs, mesh, r)
        assert shared and len(shared) < len(pieces[r])
        for kind in ("params", "m", "v"):
            assert sorted(digests[kind]) == shared
            for i in shared:
                assert {got[q][kind][i] for q in range(mesh.size)
                        if pieces[q][i] == pieces[r][i]} == {
                            digests[kind][i]}, (kind, i, r)


@pytest.mark.parametrize("mesh", [(4, 1), (1, 1)])
def test_model_collectives_over_one_model_rank_are_identities(mesh):
    """On a mesh whose "model" axis has one rank, the "model" collectives
    (`all_reduce_sum`, `all_reduce_max`, `all_gather`) return x as it is
    and count nothing: the default group they would run on is then the
    "data" ranks (or the one rank), not a mesh row."""
    mp = TPAR.ModelParallel(rank=0, world=1, mesh=train_mesh(*mesh),
                            backend="gloo", data_world=mesh[0])
    x = torch.arange(6.0).view(2, 3)
    assert mp.all_reduce_sum(x) is x and mp.all_reduce_max(x) is x
    assert mp.all_gather(x, dim=0) is x
    assert mp.all_reduce_axes(x, ("model",)) is x
    assert not mp.calls and not mp.bytes
