"""LM training of the ssm (rwkv6), hybrid (zamba2) and encdec (seamless)
families over a ("data", "model") mesh of gloo ranks on the CPU under the
reference's "tp" layout (`zoo.train_step` with mp and a
`parallel.TrainLayout`), against the reference's unsharded, jitted
`train_step` (float32, Adam lr 1e-3) on the same numpy params and the
launcher's batches (`lm_batch`, 4 x 16 tokens, seamless's 16 frames,
three steps, each after the first taken by the ranks from the
reference's params and Adam state of that step, sharded:
tests/test_torch_ssm.py's reason — Adam moves a parameter whose gradient
is near float32 rounding by +-lr on a sign that rounding decides, and
carried along such flips move rwkv6-smoke's later losses by ~4e-5
relative): rwkv6-smoke and zamba2-smoke in both ssm_impl forms, zamba2 at
4 layers (its shared block applied twice, so its weights and the embedded
input emb0 take gradients from both applications), and seamless-smoke.
The params are the reference's `materialize` with every zero- or
one-initialised leaf perturbed by 0.1 N(0, 1) (`torch_parity
.perturbed_model`), so the LoRA, bonus, shift and norm paths carry
gradients. Meshes (1, 2) and (2, 2): one spawn each (`launch.mesh
.spawn_ranks`; rank function `torch_tp_ranks.train_rank`, which also runs
`launch.train.train_lm_rank` for zamba2-smoke at (2, 2)).

Bars (tests/test_torch_fsdp.py's): losses rtol / atol 1e-5 every step;
each step's gathered Adam m within 1e-3 of each leaf's largest of the
reference's; shards gather back bit for bit; every two ranks that hold
the same pieces of a leaf (`parallel.rank_pieces`: the leaves "tp" keeps
whole on every rank, Mamba2's B / C columns of in_proj, conv_w and conv_b,
and along "data" every piece) hold the same bits of it in params, m and
v after the last step, which they do only if each gradient used on a
rank's own heads (RWKV-6's token-shift mixes, LoRAs, w0, u and ln_x, Mamba2's
B / C pieces, dt_bias, A_log and D) is summed over "model"; each rank's
params + m + v hold its pieces' bytes.

Collectives a step (`ModelParallel.calls`), per rank, "tp" on a (D, M)
mesh with M > 1, L decoder layers, V = 1 where the vocabulary is cut (the
smoke configs' 512 over 2):
  all_gather     = V (the logits) + L for rwkv6 (each channel mix's gated
                   channels)
  all_reduce_sum = V (the embedding's sum) + 1 (the head's input,
                   backward) + per layer:
                   rwkv6    2 forward (the time mix's wo, the channel
                            mix's kv) + 12 backward (the time mix's four
                            shifted inputs, the decay LoRA's hidden, w0,
                            ww_B, u and ln_x; the channel mix's two inputs
                            and its kv sum's gradient);
                   zamba2   2 forward (out_norm's sum of squares,
                            out_proj) + 8 backward (the mixer's input, the
                            B / C pieces of in_proj, conv_w and conv_b,
                            dt_bias, A_log, D, the sum of squares'
                            gradient); per shared-block application 2
                            forward (wo, the MLP) + 2 backward (its ln1
                            and ln2 outputs);
                   seamless 3 forward (self and cross attention's wo, the
                            MLP) + 4 backward (ln1, ln2 and ln_cross
                            outputs, the encoder output entering the cross
                            K/V), and per encoder layer 2 forward + 2
                            backward (its ln1 and ln2 outputs);
                 + where D > 1: 1 (the loss) + 1 (the gradients of every
                   leaf, none being cut over "data" under "tp");
                 + remat's recompute in the backward, of each forward sum
                   before a block's last tensor its backward reads:
                   rwkv6    2 a layer (the same two);
                   zamba2   2 a layer of a group (out_norm's sum of
                            squares, out_proj) + 1 a shared-block
                            application (wo), 1 a tail layer (out_norm's
                            sum: its out_proj's sum is its block's last);
                   seamless 2 a decoder layer (self attention's wo, the
                            MLP: cross attention's wo is its last) + 1 an
                            encoder layer (wo).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import zoo as JZ
from repro.optim import adam as jadam
from repro_torch import configs as TCFG
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as TLT
from repro_torch.launch.mesh import spawn_ranks, train_mesh
from repro_torch.models import base as MB
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as TZ
from torch_parity import close, flat_arrays, perturbed_model
import torch_tp_ranks

RWKV6, ZAMBA2, SEAMLESS = "rwkv6-1.6b", "zamba2-1.2b", "seamless-m4t-large-v2"
# name: (arch, ssm_impl, layers (0: the smoke config's))
ARCHS = {
    "rwkv6-scan": (RWKV6, "scan", 0),
    "rwkv6-chunked": (RWKV6, "chunked", 0),
    "zamba2-scan": (ZAMBA2, "scan", 4),
    "zamba2-chunked": (ZAMBA2, "chunked", 4),
    "seamless": (SEAMLESS, "scan", 0),
}
MESHES = [(1, 2), (2, 2)]
CASES = [(name, mesh) for mesh in MESHES for name in ARCHS]
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
LOSS_TOL = 1e-5
REF_M_TOL = 1e-3
LAUNCHER = (ZAMBA2, "tp", 2, BATCH, SEQ, 0)


def _id(case):
    name, (d, m) = case
    return f"{name}-{d}x{m}"


def _cfg(name):
    arch, impl, layers = ARCHS[name]
    cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg(arch), ssm_impl=impl)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _overrides(name) -> dict:
    _, impl, layers = ARCHS[name]
    return {"ssm_impl": impl, **({"n_layers": layers} if layers else {})}


def _reference(name, tmp):
    """The reference's three steps (losses, each step's m) from the perturbed
    params, and the inputs the ranks take: the params, the batches, and an
    npz file under tmp of the params and Adam state each later step
    starts from."""
    arch, impl, layers = ARCHS[name]
    jcfg, jp = perturbed_model(arch, impl, layers=layers)
    cfg = _cfg(name)
    rng = np.random.default_rng(0)
    batches = [{k: v.numpy() for k, v in
                TLT.lm_batch(cfg, rng, BATCH, SEQ, "cpu").items()}
               for _ in range(STEPS)]
    params_np = jax.device_get(jp)
    jo = jadam(LR)
    js = jo.init(jp)
    step = jax.jit(lambda p, o, b: JZ.train_step(p, o, b, jcfg, jo.update))
    out = dict(cfg=cfg, params_np=params_np, batches=batches, losses=[],
               states=str(tmp / f"{name}.npz"))
    states = {}
    for i, b in enumerate(batches):
        jp, js, jl = step(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        out["losses"].append(float(jl))
        out.setdefault("ms", []).append(
            jax.tree_util.tree_leaves(jax.device_get(js["m"])))
        states[f"{i + 1}/step"] = np.asarray(int(js["step"]))
        for kind, tree in (("params", jp), ("m", js["m"]), ("v", js["v"])):
            states.update({f"{i + 1}/{kind}/{k}": v for k, v in
                           flat_arrays(jax.device_get(tree)).items()})
    np.savez(out["states"], **states)
    return out



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainfam")
    refs = {name: _reference(name, tmp) for name in ARCHS}
    ranks = {}
    for d, m in MESHES:
        cases = [(name, ARCHS[name][0], "tp", _overrides(name),
                  refs[name]["params_np"], refs[name]["batches"], LR,
                  refs[name]["states"])
                 for name in ARCHS]
        launcher = LAUNCHER if (d, m) == (2, 2) else None
        ranks[(d, m)] = spawn_ranks(
            d * m, torch_tp_ranks.train_rank, (cases, None, launcher),
            mesh=train_mesh(d, m), device="cpu", timeout_s=300)
    return refs, ranks


def _case(runs, case):
    name, mesh = case
    refs, ranks = runs
    return refs[name], [r[name] for r in ranks[mesh]]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_family_losses_match_the_reference_every_step(runs, case):
    ref, got = _case(runs, case)
    for rank in got:
        close(np.asarray(rank["losses"]), np.asarray(ref["losses"]),
              LOSS_TOL, LOSS_TOL)
        assert rank["step"] == STEPS


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_family_first_moment_matches_the_reference(runs, case):
    """Each step's m (step 1's (1 - b1) g; later b1 times the reference's
    m before the step, plus (1 - b1) g), gathered from the shards: within
    1e-3 of each leaf's largest of the reference's."""
    ref, got = _case(runs, case)
    assert len(got[0]["ms"]) == len(ref["ms"]) == STEPS
    for got_tree, want_m in zip(got[0]["ms"], ref["ms"]):
        got_m = list(MB.tree_leaves(got_tree))
        assert len(got_m) == len(want_m)
        for a, want in zip(got_m, want_m):
            close(a, want, rtol=0,
                  atol=REF_M_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_family_shards_gather_back_bit_for_bit(runs, case):
    _, got = _case(runs, case)
    for rank in got:
        assert rank["round_trip"] and rank["gathers_back"]


def _pieces(cfg, mesh) -> list[list]:
    """Per rank, per leaf (tree order), the pieces it holds under "tp"."""
    tmpl = TZ.templates(cfg)
    mesh_shape = train_mesh(*mesh)
    specs = SH.param_layouts(tmpl, mesh_shape, "tp")
    return [list(MB.tree_leaves(TPAR.rank_pieces(tmpl, specs, mesh_shape,
                                                 r)))
            for r in range(mesh_shape.size)]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_family_ranks_sharing_a_piece_hold_equal_bits(runs, case):
    """Every two ranks holding the same pieces of a leaf hold the same bits
    of it in params, m and v after the steps; along "model" that covers
    the leaves each rank uses on its own heads (module docstring)."""
    ref, got = _case(runs, case)
    _, mesh = case
    pieces = _pieces(ref["cfg"], mesh)
    shared = 0
    for leaf in range(len(pieces[0])):
        groups = {}
        for r, held in enumerate(pieces):
            groups.setdefault(repr(held[leaf]), []).append(r)
        for members in groups.values():
            along_model = len({r // mesh[1] for r in members}) < len(members)
            if len(members) > 1:
                shared += along_model
                for kind in ("params", "m", "v"):
                    assert len({got[r]["digests"][kind][leaf]
                                for r in members}) == 1, (leaf, kind)
    assert shared > 0


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_family_state_bytes_equal_the_pieces(runs, case):
    """Each rank's params + m + v: 3 x 4 bytes x the elements of the
    pieces it holds."""
    ref, got = _case(runs, case)
    _, mesh = case
    for r, held in enumerate(_pieces(ref["cfg"], mesh)):
        elements = sum(int(np.prod([sum(m for _, m in dim) for dim in leaf]))
                       for leaf in held)
        assert got[r]["state_bytes"] == 3 * 4 * elements


def _calls_per_step(cfg, mesh) -> dict:
    """The module docstring's formula."""
    d, m = mesh
    assert m > 1
    vocab = int(cfg.vocab % m == 0)
    L = cfg.n_layers
    sums = vocab + 1
    gathers = vocab
    if cfg.arch_type == "ssm":
        sums += 16 * L
        gathers += L
    elif cfg.arch_type == "hybrid":
        g = TZ.shared_applications(cfg)
        tail = L - g * cfg.attn_every
        sums += 10 * L + 4 * g + 2 * (L - tail) + g + tail
    else:
        sums += 9 * L + 5 * cfg.n_enc_layers
    if d > 1:
        sums += 2
    return {"all_reduce_sum": sums, "all_gather": gathers}


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_family_collectives_per_step_follow_the_formula(runs, case):
    ref, got = _case(runs, case)
    want = _calls_per_step(ref["cfg"], case[1])
    for rank in got:
        for calls in rank["calls"]:
            assert calls == want


def test_family_launcher_rank_trains_as_the_launcher(runs, capsys):
    """`launch.train.train_lm_rank` (zamba2-smoke under "tp" over 2 x 2,
    two steps) gives `launch.train`'s --target lm losses, and its digests
    of the leaves ranks share are equal across them."""
    _, ranks = runs
    want = TLT.main(["--target", "lm", "--arch", ZAMBA2, "--smoke",
                     "--steps", "2", "--batch", str(BATCH), "--seq",
                     str(SEQ), "--lr", str(LR), "--device", "cpu"])
    capsys.readouterr()
    got = [rank["launcher"] for rank in ranks[(2, 2)]]
    for rank in got:
        close(np.asarray(rank["losses"]), np.asarray(want), LOSS_TOL,
              LOSS_TOL)
        assert rank["calls"][0] == rank["calls"][1]
    cfg = TLT.lm_config(ZAMBA2, True, 0)
    pieces = _pieces(cfg, (2, 2))
    for r, rank in enumerate(got):
        assert rank["digests"]["params"]
        for kind in ("params", "m", "v"):
            for i, digest in rank["digests"][kind].items():
                assert {got[q]["digests"][kind][i] for q in range(4)
                        if pieces[q][i] == pieces[r][i]} == {digest}


@pytest.mark.parametrize("arch", [RWKV6, ZAMBA2, SEAMLESS])
@pytest.mark.parametrize("mode", ["fsdp", "zero3"])
def test_check_train_keeps_the_data_cut_layouts_for_the_dense_families(
        arch, mode):
    """"tp" and "zero3" (which computes whole on every rank:
    tests/test_torch_zero3.py) train every family; "fsdp" stays the dense
    and moe families' (the others': ROADMAP item 29)."""
    cfg = TCFG.get_smoke(arch)
    TPAR.check_train(cfg, train_mesh(2, 2), "tp")
    if mode == "zero3":
        TPAR.check_train(cfg, train_mesh(2, 2), mode)
        return
    with pytest.raises(ValueError, match="item 29"):
        TPAR.check_train(cfg, train_mesh(2, 2), mode)
