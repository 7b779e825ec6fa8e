"""Remat (activation checkpointing) in the port's train step
(`zoo._remat`), the reference's `jax.checkpoint` of every block, on the
CPU at the smoke configs in float32 (B = 2, S = 32; gemma3-smoke at S =
48, past its window of 32).

  * The rematted step equals the unrematted one (the test seam
    `zoo._REMAT` off) bit for bit: the loss, every gradient, the updated
    params and Adam's m and v; each block enters the checkpoint once (a
    dense / moe / RWKV-6 layer; a hybrid's group of `attn_every` Mamba2
    layers with its shared block, and each tail layer; an encoder layer;
    a decoder layer). It stays within the bars of the reference's jitted
    step on the same numpy params (loss rtol 1e-5; step 1's m, the
    gradients, within 1e-3 of each leaf's largest: test_torch_moe's and
    test_torch_ssm's bars).
  * What the forward keeps for the backward (the distinct storages an op
    saves, counted by an outer `saved_tensors_hooks`, the parameters left
    out) grows by exactly one residual (B x S x d x 4 bytes) a block.
  * A 2 x 2 mesh of gloo ranks under "tp", "fsdp" and "zero3": each
    rank's rematted step equals its unrematted one bit for bit and the
    unsharded rematted step within test_torch_fsdp's bars (loss 1e-5, m
    1e-5 of each leaf's largest); the recompute re-issues each attention
    output's all-reduce (under "tp" / "fsdp") and each moe layer's
    dispatch sums over "data", and gathers each block's weights again
    where the backward without remat gathers them again to read them.
  * Serving (`engine.prefill` / `decode_step`) enters no checkpoint, with
    gradients on or off, and calls K8 as often.
  * A moe block's recompute chooses the experts its forward chose (moe_ffn,
    the "shmap" blocks in one process, `moe_ffn_shmap` over ranks); a
    recompute routed otherwise raises.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import zoo as JZ
from repro.optim import adam as jadam
from repro_torch import configs as TCFG
from repro_torch.kernels import ops
from repro_torch.launch import train as TLT
from repro_torch.launch.mesh import spawn_ranks, train_mesh
from repro_torch.models import base as MB
from repro_torch.models import layers as Lyr
from repro_torch.models import zoo as TZ
from repro_torch.optim import adam as tadam
from repro_torch.serving import engine as E
from torch_parity import close, perturbed_model
import torch_tp_ranks

B, S, LR = 2, 32, 1e-3
# name: (arch, config overrides, positions)
CASES = {"yi": ("yi-34b", {}, S),
         "gemma3": ("gemma3-27b", {}, 48),
         "dbrx": ("dbrx-132b", {"capacity_factor": 1.0}, S),
         "rwkv6-scan": ("rwkv6-1.6b", {"ssm_impl": "scan"}, S),
         "rwkv6-chunked": ("rwkv6-1.6b", {"ssm_impl": "chunked"}, S),
         "zamba2": ("zamba2-1.2b", {"n_layers": 3}, S),
         "seamless": ("seamless-m4t-large-v2", {}, S)}
LOSS_TOL, REF_M_TOL, OWN_M_TOL = 1e-5, 1e-3, 1e-5


def model(name):
    """(JAX cfg, port cfg, JAX params, port params, port batch) of a case:
    the smoke params with their zero- / one-init leaves perturbed
    (`perturbed_model`), carried across as numpy, and the launcher's
    batch (`lm_batch`)."""
    arch, over, s = CASES[name]
    jcfg, jp = perturbed_model(arch, over.get("ssm_impl", "scan"),
                               layers=over.get("n_layers", 0))
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(TCFG.get_smoke(arch), dtype=torch.float32,
                               **over)
    tp = TZ.params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    batch = TLT.lm_batch(tcfg, np.random.default_rng(0), B, s, "cpu")
    return jcfg, tcfg, jp, tp, batch


def blocks(cfg) -> int:
    """The blocks the reference checkpoints: each layer; a hybrid's
    groups of attn_every layers (with the shared block) and its tail
    layers; an encdec's encoder and decoder layers."""
    if cfg.arch_type == "hybrid":
        return sum(divmod(cfg.n_layers, cfg.attn_every))
    return cfg.n_layers + cfg.n_enc_layers


@pytest.fixture
def checkpoints(monkeypatch):
    """The calls of `torch.utils.checkpoint.checkpoint` (zoo's remat)."""
    entries, orig = [], torch.utils.checkpoint.checkpoint

    def counted(*args, **kw):
        entries.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    return entries


def grads(params, cfg, batch):
    leaves = MB.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = TZ.lm_loss(leaves, cfg, batch)
    return loss, torch.autograd.grad(loss, list(MB.tree_leaves(leaves)),
                                     allow_unused=True)


def step_with_grads(params, cfg, batch):
    """One Adam step of `zoo.train_step`: (params, state, loss, the
    gradients it handed the optimizer)."""
    opt, seen = tadam(LR), []

    def update(g, state, p):
        seen.extend(MB.tree_leaves(g))
        return opt.update(g, state, p)

    return (*TZ.train_step(params, opt.init(params), batch, cfg, update),
            seen)


@pytest.mark.parametrize("name", list(CASES))
def test_rematted_step_equals_the_unrematted_bit_for_bit(name, checkpoints,
                                                         monkeypatch):
    _, cfg, _, params, batch = model(name)
    got = step_with_grads(params, cfg, batch)
    assert len(checkpoints) == blocks(cfg)
    monkeypatch.setattr(TZ, "_REMAT", False)
    want = step_with_grads(params, cfg, batch)
    assert len(checkpoints) == blocks(cfg)
    assert torch.equal(got[2], want[2])
    for tree, tree0 in ((got[0], want[0]), (got[1]["m"], want[1]["m"]),
                        (got[1]["v"], want[1]["v"])):
        for a, b in zip(MB.tree_leaves(tree), MB.tree_leaves(tree0)):
            assert torch.equal(a, b)
    assert len(got[3]) == len(want[3]) == len(list(MB.tree_leaves(params)))
    for g, w in zip(got[3], want[3]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_rematted_step_within_the_reference_bars(name):
    jcfg, tcfg, jp, tp, batch = model(name)
    jo, to = jadam(LR), tadam(LR)
    js = jo.init(jp)
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    _, js, jl = jax.jit(lambda p, o, b: JZ.train_step(p, o, b, jcfg,
                                                      jo.update))(jp, js, jb)
    _, ts, tl = TZ.train_step(tp, to.init(tp), batch, tcfg, to.update)
    close(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    jm = jax.tree_util.tree_leaves(jax.device_get(js["m"]))
    tm = list(MB.tree_leaves(ts["m"]))
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        close(b, a, rtol=0, atol=REF_M_TOL * float(np.abs(a).max()))


def saved_bytes(name, layers: int, remat: bool) -> tuple[int, int]:
    """(the bytes of the distinct storages, parameters left out, that the
    forward of `lm_loss` saves for its backward at `layers` layers, one
    residual B x S x d x 4)."""
    arch, over, s = CASES[name]
    cfg = dataclasses.replace(TCFG.get_smoke(arch), dtype=torch.float32,
                              **{**over, "n_layers": layers})
    params = MB.materialize(TZ.templates(cfg),
                            torch.Generator().manual_seed(3))
    leaves = MB.tree_map(lambda p: p.requires_grad_(True), params)
    batch = TLT.lm_batch(cfg, np.random.default_rng(0), B, s, "cpu")
    held = {p.untyped_storage()._cdata for p in MB.tree_leaves(leaves)}
    seen = {}

    def pack(t):
        key = t.untyped_storage()._cdata
        if key not in held:
            seen[key] = t.untyped_storage().nbytes()
        return t

    old, TZ._REMAT = TZ._REMAT, remat
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            TZ.lm_loss(leaves, cfg, batch)
    finally:
        TZ._REMAT = old
    return sum(seen.values()), B * s * cfg.d_model * 4


# name: (depths, the blocks at each)
DEPTHS = {"yi": ((2, 4, 8), (2, 4, 8)),
          "dbrx": ((2, 3), (2, 3)),
          "rwkv6-chunked": ((2, 3), (2, 3)),
          # attn_every 2: 1 group; 1 group + a tail layer; 2 groups; ...
          "zamba2": ((2, 3, 4, 5, 6), (1, 2, 2, 3, 3)),
          "seamless": ((2, 3), (4, 5))}


@pytest.mark.parametrize("name", list(DEPTHS))
def test_saved_bytes_grow_by_one_residual_a_block(name):
    depths, n_blocks = DEPTHS[name]
    got = [saved_bytes(name, n, True) for n in depths]
    residual = got[0][1]
    for (b, _), k in zip(got, n_blocks):
        assert b - got[0][0] == (k - n_blocks[0]) * residual
    without = [saved_bytes(name, n, False)[0] for n in depths[:2]]
    # without remat each added layer keeps its intermediates: many
    # residuals' worth
    assert without[1] - without[0] > 10 * residual
    assert without[0] > got[0][0]
    if name == "yi":
        assert residual == 65_536
        assert without[1] - without[0] == 2 * 1_232_384


# -- over ranks ------------------------------------------------------------

MESH = (2, 2)
MODES = ("tp", "fsdp", "zero3")
RANK_CASES = [(f"{name}/{mode}", name, mode)
              for name in ("yi", "dbrx") for mode in MODES] + [
    ("zamba2/zero3", "zamba2", "zero3"), ("seamless/tp", "seamless", "tp")]


@pytest.fixture(scope="module")
def ranks():
    """One spawn of 2 x 2 gloo ranks (`torch_tp_ranks.remat_rank`) over
    RANK_CASES, and each case's unsharded rematted step."""
    cases, own = [], {}
    for key, name, mode in RANK_CASES:
        _, cfg, jp, tp, batch = model(name)
        opt = tadam(LR)
        _, st, loss = TZ.train_step(tp, opt.init(tp), batch, cfg,
                                    opt.update)
        own[key] = (cfg, float(loss),
                    [a.numpy() for a in MB.tree_leaves(st["m"])])
        cases.append((key, CASES[name][0], mode, CASES[name][1],
                      jax.device_get(jp),
                      {k: v.numpy() for k, v in batch.items()}, LR))
    got = spawn_ranks(4, torch_tp_ranks.remat_rank, (cases,),
                      mesh=train_mesh(*MESH), device="cpu", timeout_s=300)
    return own, got


def again_calls(cfg, mode: str) -> dict:
    """What a rank's recompute adds to its step's collectives on the 2 x
    2 mesh: under "tp" / "fsdp" each layer's attention output summed over
    "model" again (the MLP's and the experts' sums come after the last
    tensor the backward reads, and do not run again; an encdec decoder
    layer's self attention and MLP, whose output the cross attention's
    norm reads, but not its cross attention's, an encoder layer's
    attention); over two "data" ranks each moe layer's dispatch sums again
    (`layers.moe_dispatch`). The weights a block gathers are gathered
    again in its recompute as often as the backward without remat gathers
    them again to read them (`parallel.regather_saved`): the all-gathers
    are as many."""
    moe = cfg.n_layers if cfg.arch_type == "moe" and MESH[0] > 1 else 0
    attn = 0
    if mode != "zero3" and MESH[1] > 1:
        attn = (2 * cfg.n_layers + cfg.n_enc_layers
                if cfg.arch_type == "encdec" else cfg.n_layers)
    return {"all_reduce_sum": attn + moe} if attn + moe else {}


@pytest.mark.parametrize("key,name,mode", RANK_CASES,
                         ids=[c[0] for c in RANK_CASES])
def test_ranks_remat_as_the_unsharded_step(ranks, key, name, mode):
    own, got = ranks
    cfg, loss, m1 = own[key]
    for rank in got:
        run = rank[key]
        assert run["equal"], "rematted != unrematted on a rank"
        assert run["entries"] == (blocks(cfg), 0)
        close(run["loss"], loss, LOSS_TOL, LOSS_TOL)
        c1, c0 = run["calls"]
        diff = {k: c1.get(k, 0) - c0.get(k, 0) for k in {*c1, *c0}}
        assert {k: v for k, v in diff.items() if v} == again_calls(cfg,
                                                                   mode)
        if cfg.arch_type == "moe":
            held = [g for g, again in run["routes"] if not again]
            redone = [g for g, again in run["routes"] if again]
            assert len(held) == len(redone) == cfg.n_layers
            # the recompute runs the blocks last to first
            for g, h in zip(redone, reversed(held)):
                np.testing.assert_array_equal(g, h)
    m = got[0][key]["m1"]
    assert len(m) == len(m1)
    for a, want in zip(m, m1):
        close(a, want, rtol=0, atol=OWN_M_TOL * float(np.abs(want).max()))


# -- serving ----------------------------------------------------------------

@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
@pytest.mark.parametrize("name", ["yi", "gemma3", "dbrx", "rwkv6-chunked",
                                  "zamba2", "seamless"])
def test_serving_enters_no_checkpoint(name, grad, checkpoints, monkeypatch):
    """Prefill and 3 decode steps (`engine`), gradients on or off: no
    checkpoint entered, and K8 called as often and the logits equal bit
    for bit with the test seam off."""
    _, cfg, _, params, batch = model(name)
    batch = {k: v for k, v in batch.items() if k != "targets"}
    k8 = []
    orig = ops.swa_decode

    def counted(*args, **kw):
        k8.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(ops, "swa_decode", counted)

    def serve():
        b, s = batch["tokens"].shape
        enc = batch["frontend"].shape[1] if cfg.arch_type == "encdec" else 0
        cache = E.init_cache(cfg, b, s + 4, enc, device="cpu")
        with torch.set_grad_enabled(grad):
            logits, cache = E.prefill(params, cfg, batch, cache)
            out = [logits[:, -1]]
            for i in range(3):
                tok = out[-1].argmax(-1, keepdim=True)
                logits, cache = E.decode_step(params, cfg, tok, cache, s + i)
                out.append(logits[:, -1])
        return out, len(k8)

    got, calls = serve()
    assert checkpoints == []
    k8.clear()
    monkeypatch.setattr(TZ, "_REMAT", False)
    want, calls0 = serve()
    assert calls == calls0
    if cfg.arch_type != "ssm":
        assert calls > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- expert choices ---------------------------------------------------------

def routed_grads(cfg, params, batch, wrap=None):
    """The gradients of lm_loss with every routing recorded as (gate_i,
    made by a recompute); wrap(out, again) may replace a routing's
    output."""
    routes, orig = [], Lyr.moe_route

    def recorded(p, cfg_, xt):
        out = orig(p, cfg_, xt)
        again = Lyr.recomputing()
        routes.append((out[2].clone(), again))
        return out if wrap is None else wrap(out, again)

    Lyr.moe_route = recorded
    try:
        grads(params, cfg, batch)
    finally:
        Lyr.moe_route = orig
    return routes


@pytest.mark.parametrize("shmap", [False, True], ids=["moe_ffn", "shmap"])
def test_recompute_chooses_the_forwards_experts(shmap):
    """dbrx-smoke at capacity 1.0 (drops): every moe layer's recompute
    routes as its forward did, choice for choice; under "shmap" in one
    process (`layers.one_process_mesh(2, 2)`: each data shard routed on
    its own) every shard's."""
    _, cfg, _, params, batch = model("dbrx")
    per_layer = 1
    if shmap:
        cfg = dataclasses.replace(cfg, attn_shard="shmap")
        per_layer = 2
        with Lyr.one_process_mesh(2, 2):
            routes = routed_grads(cfg, params, batch)
    else:
        routes = routed_grads(cfg, params, batch)
    held = [g for g, again in routes if not again]
    redone = [g for g, again in routes if again]
    assert len(held) == len(redone) == per_layer * cfg.n_layers
    n = per_layer
    layers = [held[i:i + n] for i in range(0, len(held), n)]
    again = [redone[i:i + n] for i in range(0, len(redone), n)]
    for g, h in zip(again, reversed(layers)):
        for a, b in zip(g, h):
            assert torch.equal(a, b)


def test_recompute_routed_otherwise_raises():
    """A recompute whose router picks another expert for one token (a
    planted fault) fails the step: no gradient of other choices than the
    loss's is taken."""
    _, cfg, _, params, batch = model("dbrx")

    def flip(out, again):
        if not again:
            return out
        gate_i = out[2].clone()
        gate_i[0, 0] = (gate_i[0, 0] + 1) % cfg.n_experts
        return out[0], out[1], gate_i

    with pytest.raises(RuntimeError, match="other experts"):
        routed_grads(cfg, params, batch, wrap=flip)
