"""LM training under the reference's "shmap" variant (`attn_shard="shmap"`,
what its pod dry run picks for yi-34b's, dbrx-132b's and arctic-480b's
train steps at 16 ranks) over a (data 2, model 2) mesh of gloo ranks on
the CPU (`zoo.train_step` with mp and a `parallel.TrainLayout` under "tp"
and "fsdp"), against the reference's jitted `train_step` with
attn_shard="shmap" and `layers.MESH` a (data 2, model 2) mesh of four
host devices, in a subprocess
(`XLA_FLAGS=--xla_force_host_platform_device_count=4`, `with mesh:`):
its shard_map attention (each model rank's block of the keys, the softmax
states combined with the max carrying no gradient and acc crossing in
bfloat16 both ways) and its shard_map MoE (the capacity of each data
shard's tokens, the aux mean'd over the data shards, the experts' sum in
bfloat16). The layouts "tp" and "fsdp" partition the same step, so one
reference run serves both.

Cases (float32, Adam lr 1e-3, the launcher's batches of 4 x 16 tokens,
three steps): yi-smoke with 6 query heads (head_dim 64), dbrx-smoke at
capacity factor 1.0 (each data shard drops choices), under "tp" and
"fsdp"; yi-smoke with 3 query heads and 1 kv head (1.5 heads a model
rank, the one kv head on both: the split heads and the summed gradient of
a shared kv head, `parallel.sum_held_kv`) under "tp" and "fsdp" (the
layout the pod dry run picks for yi-34b at 16 ranks) with "shmap", and
under "tp" with "auto" against the reference's unsharded jitted step.
The same "shmap" steps in one process (`layers.one_process_mesh`, the
run chip_smoke.py holds its 16 ranks to) against the same references.

Bars, from the bfloat16 wire: step 1's loss rtol / atol 1e-5
(tests/test_torch_fsdp.py's; the forward's bf16 roundings are the
reference's); every step's loss within LOSS_BAR = 1e-3 and step 1's
gathered Adam m within M_BAR = 2^-8 (one bfloat16 rounding step) of each
leaf's largest of the reference's. fsdp's 1e-5 for those is out of reach
of the reference itself: its own losses and m move past it when its
params move by one float32 ulp, since a rounding to bfloat16 that flips
moves an element by up to 2^-8 of itself, in the forward and in the
backward's cast of the cotangent (the subprocess runs each reference
again from params perturbed by one ulp, and
`test_shmap_reference_moves_past_fsdp_bars_within_these` holds that spread
above 1e-5 and below these bars). Kept choices exact in every (step,
layer, data shard) where the reference's router leaves every token of the
shard a margin of ROUTE_MARGIN (some must, with drops); shards gather
back bit for bit; every rank holds the same bits of each leaf piece it
shares with another rank; each rank's params + m + v hold its pieces'
bytes; the attention combine's max runs once a layer a step.
"""

import contextlib
import dataclasses
import math
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
from repro.optim import adam as jadam
from repro_torch.launch import train as TLT
from repro_torch.launch.mesh import spawn_ranks, train_mesh
from repro_torch.launch import sharding as SH
from repro_torch.models import base as MB
from repro_torch.models import layers as TLyr
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as TZ
from repro_torch.optim import adam as tadam
from torch_parity import close, flat_arrays
import torch_tp_ranks

MESH = (2, 2)
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
LOSS_TOL = 1e-5                 # step 1
LOSS_BAR, M_BAR = 1e-3, 2.0 ** -8
ROUTE_MARGIN = 1e-5
YI6 = {"n_heads": 6, "head_dim": 64}
YI3 = {"n_heads": 3, "n_kv_heads": 1, "head_dim": 64}
DBRX = {"capacity_factor": 1.0}
# name: (arch, overrides, attn_shard, layout, reference run)
CASES = {
    "yi6-tp": ("yi-34b", YI6, "shmap", "tp", "yi6"),
    "yi6-fsdp": ("yi-34b", YI6, "shmap", "fsdp", "yi6"),
    "dbrx-tp": ("dbrx-132b", DBRX, "shmap", "tp", "dbrx"),
    "dbrx-fsdp": ("dbrx-132b", DBRX, "shmap", "fsdp", "dbrx"),
    "yi3-tp": ("yi-34b", YI3, "shmap", "tp", "yi3"),
    "yi3-fsdp": ("yi-34b", YI3, "shmap", "fsdp", "yi3"),
    "yi3-auto-tp": ("yi-34b", YI3, "auto", "tp", "yi3-auto"),
}
# reference run: (arch, overrides, attn_shard)
REFS = {ref: (arch, over, variant)
        for arch, over, variant, _, ref in CASES.values()}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import configs as C
    from repro.models import layers as L
    from repro.models import zoo as Z
    from repro.optim import adam
    d = np.load(sys.argv[1])
    spec = json.loads(str(d["spec"]))
    # Auto axes: GSPMD partitions what lies outside the shard_maps, as
    # the reference was written for (Explicit ones refuse its head
    # product of a batch cut over "data")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    L.MESH = mesh
    out = {}
    runs = [(name, arch, over, tag) for name, (arch, over)
            in spec["runs"].items() for tag in ("", "_ulp")]
    for name, arch, over, tag in runs:
        cfg = dataclasses.replace(C.get_smoke(arch), dtype=jnp.float32,
                                  attn_shard="shmap", **over)
        params = {}
        rng = np.random.default_rng(5)
        for key in sorted(d.files):
            if key.startswith(f"{name}/p/"):
                node = params
                *path, leaf = key[len(name) + 3:].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                a = d[key]
                if tag:     # each element moved by one ulp, or kept
                    a = a * (1 + 2.0 ** -23 * rng.choice(
                        [-1, 0, 1], size=a.shape)).astype(np.float32)
                node[leaf] = jnp.asarray(a)
        opt = adam(spec["lr"])
        state = opt.init(params)
        step = jax.jit(lambda p, o, b: Z.train_step(p, o, b, cfg,
                                                    opt.update))
        probs, orig = [], L.moe_ffn_shmap

        def recorded(p, cfg_, x):
            xt = x.reshape(-1, x.shape[-1])
            jax.debug.callback(lambda a: probs.append(np.asarray(a)),
                               jax.nn.softmax((xt @ p["router"]).astype(
                                   jnp.float32), axis=-1))
            return orig(p, cfg_, x)

        fwd = jax.jit(lambda p, b: Z.forward(p, cfg, b)[0])
        losses = []
        for i in range(spec["steps"]):
            batch = {k[len(f"batch{i}/"):]: jnp.asarray(d[k])
                     for k in d.files if k.startswith(f"batch{i}/")}
            with mesh:
                if cfg.arch_type == "moe" and not tag:
                    L.moe_ffn_shmap = recorded
                    try:
                        jax.block_until_ready(fwd(params, batch))
                        jax.effects_barrier()
                    finally:
                        L.moe_ffn_shmap = orig
                params, state, loss = step(params, state, batch)
            losses.append(float(loss))
            if i == 0:
                for j, a in enumerate(jax.tree_util.tree_leaves(
                        jax.device_get(state["m"]))):
                    out[f"{name}{tag}/m1/{j}"] = np.asarray(a)
        out[f"{name}{tag}/losses"] = np.asarray(losses)
        for j, a in enumerate(probs):
            out[f"{name}/probs/{j}"] = a
    np.savez(sys.argv[2], **out)
""")


def _jcfg(ref):
    arch, over, variant = REFS[ref]
    return dataclasses.replace(JCFG.get_smoke(arch), dtype=jnp.float32,
                               attn_shard=variant, **over)


def _cfg(name):
    arch, over, variant, _, _ = CASES[name]
    return dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                               attn_shard=variant, **over)


def _batches(tcfg):
    rng = np.random.default_rng(0)
    return [{k: v.numpy() for k, v in
             TLT.lm_batch(tcfg, rng, BATCH, SEQ, "cpu").items()}
            for _ in range(STEPS)]


def _unsharded(jp, jcfg, batches):
    """The reference's plain jitted steps: (losses, step 1's m leaves)."""
    opt = jadam(LR)
    state = opt.init(jp)
    step = jax.jit(lambda p, o, b: JZ.train_step(p, o, b, jcfg, opt.update))
    losses, m1 = [], None
    for i, b in enumerate(batches):
        jp, state, loss = step(jp, state, {k: jnp.asarray(v)
                                           for k, v in b.items()})
        losses.append(float(loss))
        if i == 0:
            m1 = jax.tree_util.tree_leaves(jax.device_get(state["m"]))
    return dict(losses=np.asarray(losses), m1=m1, probs=[])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (the shmap ones in a subprocess, started first)
    and the four ranks' results of every case."""
    import json
    tmp = tmp_path_factory.mktemp("shmap_train")
    params = {ref: JMB.materialize(JZ.templates(_jcfg(ref)),
                                   jax.random.PRNGKey(1), dtype=jnp.float32)
              for ref in REFS}
    batches = _batches(_cfg("yi6-tp"))
    shmap = {ref: [arch, over] for ref, (arch, over, v) in REFS.items()
             if v == "shmap"}
    payload = {"spec": np.asarray(json.dumps(dict(runs=shmap, lr=LR,
                                                   steps=STEPS)))}
    for i, b in enumerate(batches):
        payload.update({f"batch{i}/{k}": v for k, v in b.items()})
    for ref in shmap:
        payload.update({f"{ref}/p/{k}": v for k, v in flat_arrays(
            jax.device_get(params[ref])).items()})
    np.savez(tmp / "in.npz", **payload)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             str(tmp / "in.npz"), str(tmp / "out.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        refs = {ref: _unsharded(params[ref], _jcfg(ref), batches)
                for ref in REFS if ref not in shmap}
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    got = np.load(tmp / "out.npz")
    for ref in shmap:
        n_m = sum(k.startswith(f"{ref}/m1/") for k in got.files)
        n_p = sum(k.startswith(f"{ref}/probs/") for k in got.files)
        refs[ref] = dict(losses=got[f"{ref}/losses"],
                         m1=[got[f"{ref}/m1/{j}"] for j in range(n_m)],
                         probs=[got[f"{ref}/probs/{j}"] for j in range(n_p)],
                         ulp_losses=got[f"{ref}_ulp/losses"],
                         ulp_m1=[got[f"{ref}_ulp/m1/{j}"]
                                 for j in range(n_m)])
    cases = [(name, arch, mode, dict(over, attn_shard=variant),
              jax.device_get(params[ref]), batches, LR)
             for name, (arch, over, variant, mode, ref) in CASES.items()]
    ranks = spawn_ranks(math.prod(MESH), torch_tp_ranks.train_rank,
                        (cases,), mesh=train_mesh(*MESH), device="cpu",
                        timeout_s=300)
    return {name: dict(ref=refs[CASES[name][4]],
                       ranks=[r[name] for r in ranks]) for name in CASES}


def test_the_cases_train_as_the_pod_dry_run_picks():
    """check_train takes each case; yi3 splits its query heads over the
    model ranks and holds its one kv head on both."""
    for name, (_, _, _, mode, _) in CASES.items():
        TPAR.check_train(_cfg(name), train_mesh(*MESH), mode)
    cfg = _cfg("yi3-tp")
    assert cfg.n_heads % MESH[1] and TPAR.kv_heads(3, 1, 2, 0) == \
        TPAR.kv_heads(3, 1, 2, 1) == [0]


@pytest.mark.parametrize("ref", [r for r, c in REFS.items()
                                 if c[2] == "shmap"])
def test_one_process_mesh_keeps_the_reference_semantics(runs, ref):
    """`zoo.train_step` without ranks inside `layers.one_process_mesh(2,
    2)` (the keys in two blocks combined as the ranks', the experts over
    two data shards) against the reference's "shmap" steps on its (2, 2)
    mesh, at the ranks' bars; the plain step (no such mesh) gives other
    losses, so the semantics are the mesh's."""
    name = next(k for k, c in CASES.items() if c[4] == ref)
    arch, over, variant = REFS[ref]
    cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                              attn_shard=variant, **over)
    params_np = jax.device_get(JMB.materialize(
        JZ.templates(_jcfg(ref)), jax.random.PRNGKey(1), dtype=jnp.float32))
    want = runs[name]["ref"]

    def steps(mesh: bool):
        params = TZ.params_from_numpy(params_np, cfg, device="cpu")
        opt = tadam(LR)
        state = opt.init(params)
        losses, m1 = [], None
        for i, b in enumerate(_batches(cfg)):
            batch = {k: torch.as_tensor(v) for k, v in b.items()}
            with TLyr.one_process_mesh(*MESH) if mesh else \
                    contextlib.nullcontext():
                params, state, loss = TZ.train_step(params, state, batch,
                                                    cfg, opt.update)
            losses.append(float(loss))
            if i == 0:
                m1 = [a.numpy() for a in MB.tree_leaves(state["m"])]
        return np.asarray(losses), m1

    losses, m1 = steps(True)
    close(losses[0], want["losses"][0], LOSS_TOL, LOSS_TOL)
    close(losses, want["losses"], 0.0, LOSS_BAR)
    assert len(m1) == len(want["m1"])
    for a, w in zip(m1, want["m1"]):
        close(a, w, rtol=0, atol=M_BAR * float(np.abs(w).max()))
    assert not np.array_equal(steps(False)[0], losses)


def _m_bar(name) -> float:
    """The bar on step 1's m, a share of each leaf's largest: M_BAR over
    the bf16 wires of "shmap", fsdp's 1e-5 for "auto" (no bf16 wire)."""
    return M_BAR if CASES[name][2] == "shmap" else 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_shmap_losses_match_the_reference_every_step(runs, name):
    r = runs[name]
    later = LOSS_BAR if CASES[name][2] == "shmap" else LOSS_TOL
    for rank in r["ranks"]:
        assert rank["step"] == STEPS
        close(rank["losses"][0], r["ref"]["losses"][0], LOSS_TOL, LOSS_TOL)
        close(np.asarray(rank["losses"]), r["ref"]["losses"], 0.0, later)


@pytest.mark.parametrize("name", list(CASES))
def test_shmap_first_moment_matches_the_reference(runs, name):
    """Step 1's m = (1 - b1) g, gathered from the shards: within `_m_bar`
    of each leaf's largest of the reference's."""
    r = runs[name]
    got = list(MB.tree_leaves(r["ranks"][0]["m1"]))
    assert len(got) == len(r["ref"]["m1"])
    for a, want in zip(got, r["ref"]["m1"]):
        close(a, want, rtol=0, atol=_m_bar(name) * float(np.abs(want).max()))


@pytest.mark.parametrize("ref", [r for r, c in REFS.items()
                                 if c[2] == "shmap"])
def test_shmap_reference_moves_past_fsdp_bars_within_these(runs, ref):
    """The reference's own "shmap" step, its params moved by one float32
    ulp: its step 1 loss stays within 1e-5, its later losses and its step
    1 m move past fsdp's 1e-5 (the bf16 wires' roundings flip) and stay
    within LOSS_BAR and M_BAR, the bars the port is held to."""
    r = next(v["ref"] for k, v in runs.items() if CASES[k][4] == ref)
    moved = max(float(np.abs(a - b).max() / np.abs(a).max())
                for a, b in zip(r["m1"], r["ulp_m1"]))
    assert 1e-5 < moved < M_BAR
    spread = np.abs(r["losses"] - r["ulp_losses"])
    assert spread[0] <= LOSS_TOL and spread.max() < LOSS_BAR


@pytest.mark.parametrize("name", list(CASES))
def test_shmap_shards_gather_back_and_shared_pieces_hold_equal_bits(runs,
                                                                    name):
    """The shards gather back bit for bit; every rank holding a piece of a
    leaf that another rank holds too (the norms; yi3's one kv head on
    both model ranks, its gradient summed over them) holds the same bits
    of it, in params, m and v."""
    cfg = _cfg(name)
    mode = CASES[name][3]
    mesh = train_mesh(*MESH)
    tmpl = TZ.templates(cfg)
    specs = SH.param_layouts(tmpl, mesh, mode)
    pieces = [list(MB.tree_leaves(TPAR.rank_pieces(tmpl, specs, mesh, r)))
              for r in range(mesh.size)]
    ranks = runs[name]["ranks"]
    shared = 0
    for rank in ranks:
        assert rank["round_trip"] and rank["gathers_back"]
    for leaf in range(len(pieces[0])):
        groups = {}
        for r, held in enumerate(pieces):
            groups.setdefault(repr(held[leaf]), []).append(r)
        for members in groups.values():
            if len(members) > 1:
                shared += 1
                for kind in ("params", "m", "v"):
                    assert len({ranks[r]["digests"][kind][leaf]
                                for r in members}) == 1, (leaf, kind)
    assert shared > 0
    if name.startswith("yi3"):
        wk = [i for i, t in enumerate(MB.tree_leaves(tmpl))
              if t.axes[-1] == "kvout"]
        assert wk and all(pieces[0][i] == pieces[1][i] for i in wk)


@pytest.mark.parametrize("name", list(CASES))
def test_shmap_state_bytes_equal_the_pieces(runs, name):
    cfg = _cfg(name)
    mesh = train_mesh(*MESH)
    tmpl = TZ.templates(cfg)
    specs = SH.param_layouts(tmpl, mesh, CASES[name][3])
    for r, rank in enumerate(runs[name]["ranks"]):
        held = MB.tree_leaves(TPAR.rank_pieces(tmpl, specs, mesh, r))
        want = sum(math.prod(sum(m for _, m in dim) for dim in leaf)
                   for leaf in held)
        assert rank["state_bytes"] == 3 * 4 * want


@pytest.mark.parametrize("name", [k for k, c in CASES.items()
                                  if c[2] == "shmap"])
def test_shmap_attention_combines_once_a_layer(runs, name):
    """Each training step runs the attention combine's max once a layer's
    forward and once more in its recompute under remat (the max carries no
    gradient, so the backward runs none) on every rank."""
    cfg = _cfg(name)
    for rank in runs[name]["ranks"]:
        for calls in rank["calls"]:
            assert calls["all_reduce_max"] == 2 * cfg.n_layers


def _shard_keeps(probs, cfg, shard, n_shards):
    """The reference's shard_map dispatch over data shard `shard` of the
    tokens' router probabilities (T, E), T the whole batch's in row
    order: (top-k margins, kept choices (T_shard * k,)): its top k, lower
    index first on ties, a position per expert in token-major order from
    the shard's first token, the shard's own capacity."""
    t = probs.shape[0] // n_shards
    p = probs[shard * t:(shard + 1) * t]
    gate_i = np.argsort(-p, axis=-1, kind="stable")[:, :cfg.top_k]
    flat = gate_i.reshape(-1)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, axis=0) - 1)[np.arange(flat.size), flat]
    cap = int(max(1, math.ceil(cfg.capacity_factor * t * cfg.top_k
                               / cfg.n_experts)))
    top = np.sort(p, axis=-1)[:, ::-1]
    return top[:, cfg.top_k - 1] - top[:, cfg.top_k], pos < cap


@pytest.mark.parametrize("name", ["dbrx-tp", "dbrx-fsdp"])
def test_shmap_kept_choices_are_each_data_shards(runs, name):
    """Each rank's kept choices in every (step, layer) are the reference's
    shard_map dispatch over its data shard's tokens, where the reference's
    router leaves every token of the shard a margin; some are dropped."""
    r = runs[name]
    cfg = _cfg(name)
    probs = r["ref"]["probs"]
    assert len(probs) == STEPS * cfg.n_layers
    compared = dropped = 0
    for rank_id, rank in enumerate(r["ranks"]):
        shard = rank_id // MESH[1]
        for step in range(STEPS):
            assert len(rank["keeps"][step]) == cfg.n_layers
            for layer in range(cfg.n_layers):
                margin, want = _shard_keeps(
                    probs[step * cfg.n_layers + layer], cfg, shard, MESH[0])
                if (margin <= ROUTE_MARGIN).any():
                    continue
                np.testing.assert_array_equal(rank["keeps"][step][layer],
                                              want)
                compared += 1
                dropped += int((~want).sum())
    assert compared > 0 and dropped > 0
