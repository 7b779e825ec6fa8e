"""The port's moe family (dbrx, arctic) on the CPU against the reference:
the configs' sizes from the templates alone, `layers.moe_ffn` against
`repro.models.layers.moe_ffn` with and without capacity drops (routing,
kept choices, output, aux loss and gradients), top-k on tied
probabilities, the smoke models' forward with drops, prefill and greedy
decode against the reference's engine and against the port's own
forward, three Adam steps, the LM train launcher, and the neural final
stage on a moe model.

The reference's parameters come from its own `materialize` and carry
across with `zoo.params_from_numpy` (torch_parity.dense_model); inputs are
numpy draws from a seed.

Tolerances: moe_ffn's output and gradients rtol/atol 1e-5 (float32 sums
in another order), the aux loss 1e-6 (a mean of E products of
probabilities); logits 2e-4 (the dense tests' LOGIT_TOL, the reference's
own bar between its prefill and its forward), decode against forward
2e-3 (the reference's bar for that check). Discrete outputs (expert
choices, kept/dropped choices, greedy tokens) exactly, after checking the
inputs leave the decision a margin: the k-th and (k+1)-th router
probabilities of every token differ by more than ROUTE_MARGIN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
import repro_torch.configs as TCFG
from repro.models import layers as JL
from repro.models import zoo as JZ
from repro.optim import adam as jadam
from repro.serving import engine as JE
from repro_torch.launch import serve as TLS
from repro_torch.launch import train as TLT
from repro_torch.models import base as TMB
from repro_torch.models import layers as TL
from repro_torch.models import zoo as TZ
from repro_torch.optim import adam as tadam
from repro_torch.serving import engine as TE
from torch_parity import MOE_ARCHS, close, dense_model, exact, n, token_batch

MOE_TOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 2e-4
FWD_TOL = 2e-3
ROUTE_MARGIN = 1e-6
BF16_ROUTE_GAP = 2 ** -5    # log-probability: a few bf16 ulps of a logit

_decode = jax.jit(JE.decode_step, static_argnums=(1,))


def _layer0_moe(arch, capacity_factor=None):
    """(JAX cfg, port cfg, JAX moe params, port moe params) of layer 0 of
    the arch's float32 smoke model, at another capacity factor if given."""
    jcfg, tcfg, jp, tp = dense_model(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"])
    tm = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    return jcfg, tcfg, jm, tm


def _jax_dispatch(p, cfg, x):
    """The reference's routing and capacity dispatch, its own lines
    (src/repro/models/layers.py moe_ffn): (probs, gate_i (T, k), keep
    (T*k,))."""
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    _, gate_i = jax.lax.top_k(probs, cfg.top_k)
    cap = int(max(1, np.ceil(cfg.capacity_factor * xt.shape[0] * cfg.top_k
                             / cfg.n_experts)))
    flat_e = gate_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                              flat_e[:, None], axis=1)[:, 0]
    return np.asarray(probs), np.asarray(gate_i), np.asarray(pos < cap)


def _assert_route_margin(probs, k):
    top = np.sort(probs, axis=-1)[:, ::-1]
    gap = top[:, k - 1] - top[:, k]
    assert (gap > ROUTE_MARGIN).all(), float(gap.min())


def _port_dispatch(p, cfg, x):
    xt = x.reshape(-1, x.shape[-1])
    probs, _, gate_i = TL.moe_route(p, cfg, xt)
    _, pos = TL.moe_positions(gate_i, cfg.n_experts)
    return probs, gate_i, pos < TL.moe_capacity(cfg, xt.shape[0])


# ---------------------------------------------------------------------------
# configs and templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers,params", [
    ("dbrx-132b", 40, 131_596_523_520), ("dbrx-132b", 2, 7_751_301_120),
    ("dbrx-132b", 1, 4_492_216_320), ("arctic-480b", 35, 476_850_275_328),
    ("arctic-480b", 1, 14_069_945_344)])
def test_full_config_sizes_from_templates_alone(arch, layers, params):
    """Parameter counts of the published widths at the depths the card
    runs (2 dbrx layers: 15.5 GB in bf16; 1 arctic layer: 28.1 GB; 1 dbrx
    layer: 18.0 GB in float32), from the templates, nothing allocated;
    equal to the reference's; the expert leaves (L, E, d, ff) stacked."""
    tcfg = dataclasses.replace(TCFG.get(arch), n_layers=layers)
    jcfg = dataclasses.replace(JCFG.get(arch), n_layers=layers)
    assert tcfg.param_count() == jcfg.param_count() == params
    assert tcfg.active_param_count() == jcfg.active_param_count()
    moe = TZ.templates(tcfg)["blocks"]["moe"]
    e, d, ff = tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff
    assert {k: t.shape for k, t in moe.items()} == {
        "router": (layers, d, e), "w_gate": (layers, e, d, ff),
        "w_in": (layers, e, d, ff), "w_out": (layers, e, ff, d)}
    assert ("dense_mlp" in TZ.templates(tcfg)["blocks"]) == (
        arch == "arctic-480b")


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_moe_ffn_matches_reference(arch, capacity_factor):
    """The same expert choices and kept / dropped sets exactly; the
    output at 1e-5, the aux at 1e-6. At capacity factor 8.0 (the smoke
    configs') nothing drops; at 1.0 and 0.5 choices do."""
    jcfg, tcfg, jm, tm = _layer0_moe(arch, capacity_factor)
    x = np.random.default_rng(3).normal(
        size=(2, 24, jcfg.d_model)).astype(np.float32)
    probs, gate_i, keep = _jax_dispatch(jm, jcfg, x)
    _assert_route_margin(probs, jcfg.top_k)
    t_probs, t_gate, t_keep = _port_dispatch(tm, tcfg, exact(x))
    close(t_probs, probs, AUX_TOL, AUX_TOL)
    np.testing.assert_array_equal(n(t_gate), gate_i)
    np.testing.assert_array_equal(n(t_keep), keep)
    assert keep.all() == (capacity_factor == 8.0)
    want, want_aux = JL.moe_ffn(jm, jcfg, jnp.asarray(x))
    got, aux = TL.moe_ffn(tm, tcfg, exact(x))
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    close(got, want, MOE_TOL, MOE_TOL)
    close(aux, want_aux, AUX_TOL, AUX_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_moe_ffn_gradients_match_reference(arch, capacity_factor):
    """Gradients of <out, r> + c * aux to the router, the experts'
    weights and x against jax.grad's, at 1e-5: a dropped choice gets no
    gradient in either (the port clamps the gather index the reference's
    gather clamps, and masks the same way)."""
    jcfg, tcfg, jm, tm = _layer0_moe(arch, capacity_factor)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    c = np.float32(3.0)

    def jloss(p, x_):
        out, aux = JL.moe_ffn(p, jcfg, x_)
        return jnp.sum(out * r) + c * aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jm, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tm.items()}
    xt = exact(x).requires_grad_(True)
    out, aux = TL.moe_ffn(leaves, tcfg, xt)
    (torch.sum(out * exact(r)) + float(c) * aux).backward()
    for k in ("router", "w_gate", "w_in", "w_out"):
        close(leaves[k].grad, jg_p[k], MOE_TOL, MOE_TOL)
    close(xt.grad, jg_x, MOE_TOL, MOE_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_in_bf16_follows_the_reference_casts(arch):
    """bfloat16 weights and activations (the reference's bf16 tree, bit for
    bit): the router logits taken in bfloat16 and then cast to float32,
    the output in bfloat16, the aux in float32, as the reference casts.
    The expert choices equal the reference's wherever the top-k logits are
    more than BF16_ROUTE_GAP apart; the output within 4 bf16 ulps of its
    scale (the two frameworks round the experts' intermediates at other
    places), the aux within 1e-3."""
    jcfg, tcfg, jp, tp = dense_model(arch, dtype="bfloat16")
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"])
    tm = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    xj = jnp.asarray(np.random.default_rng(9).normal(
        size=(2, 24, jcfg.d_model)), jnp.bfloat16)
    x = exact(xj)
    want, want_aux = JL.moe_ffn(jm, jcfg, xj)
    got, aux = TL.moe_ffn(tm, tcfg, x)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    probs, gate_i, _ = _jax_dispatch(jm, jcfg, xj)
    top = np.sort(np.log(probs), axis=-1)[:, ::-1]
    sure = top[:, jcfg.top_k - 1] - top[:, jcfg.top_k] > BF16_ROUTE_GAP
    assert sure.mean() > 0.9
    t_gate = n(_port_dispatch(tm, tcfg, x)[1])
    np.testing.assert_array_equal(t_gate[sure], gate_i[sure])
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(n(got.float()), want, rtol=0,
                               atol=4 * scale / 128)
    close(aux, want_aux, 1e-3, 1e-3)


@pytest.mark.parametrize("tie", ["all", "columns"])
def test_topk_on_tied_probabilities_takes_the_lower_index(tie):
    """Router probabilities tied exactly — all experts (a zero router) or
    experts 1..3 (equal router columns) — give the reference's
    `jax.lax.top_k` choices, the lower expert index first, and its
    output."""
    jcfg, tcfg, jm, tm = _layer0_moe("dbrx-132b")
    router = np.asarray(jm["router"]).copy()
    if tie == "all":
        router[:] = 0.0
    else:
        router[:, 2] = router[:, 3] = router[:, 1]
    jm = dict(jm, router=jnp.asarray(router))
    tm = dict(tm, router=exact(router))
    x = np.random.default_rng(5).normal(
        size=(1, 16, jcfg.d_model)).astype(np.float32)
    probs, gate_i, keep = _jax_dispatch(jm, jcfg, x)
    t_probs, t_gate, t_keep = _port_dispatch(tm, tcfg, exact(x))
    if tie == "all":
        assert (gate_i == [0, 1]).all()
    else:
        assert (n(t_probs)[:, 1] == n(t_probs)[:, 3]).all()
    np.testing.assert_array_equal(n(t_gate), gate_i)
    np.testing.assert_array_equal(n(t_keep), keep)
    close(TL.moe_ffn(tm, tcfg, exact(x))[0],
          JL.moe_ffn(jm, jcfg, jnp.asarray(x))[0], MOE_TOL, MOE_TOL)


# ---------------------------------------------------------------------------
# the model: forward with drops, prefill and decode, train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_with_capacity_drops_matches_reference(arch):
    """The smoke model at capacity factor 1.0, where layers drop choices:
    logits at LOGIT_TOL and the aux summed over the layers at 1e-6 (the
    smoke configs themselves, without drops: test_torch_models)."""
    jcfg, tcfg, jp, tp = dense_model(arch)
    jcfg = dataclasses.replace(jcfg, capacity_factor=1.0)
    tcfg = dataclasses.replace(tcfg, capacity_factor=1.0)
    jb, tb = token_batch(jcfg, 2, 40, seed=6)
    xn = np.asarray(JL.rms_norm(JZ.embed_inputs(jp, jcfg, jb),
                                jp["blocks"]["ln2"][0]))
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"])
    assert not _jax_dispatch(jm, jcfg, xn)[2].all()   # some choice drops
    want, want_aux = JZ.forward(jp, jcfg, jb)
    got, aux = TZ.forward(tp, tcfg, tb)
    close(aux, want_aux, AUX_TOL, AUX_TOL)
    close(got, want, LOGIT_TOL, LOGIT_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_own_forward(arch):
    """tests/test_arch_smoke.py's check on the port: prefill's last logits
    equal the forward's, one decode step (K8's plain version, a capacity
    of B tokens) the forward over the extended sequence."""
    _, tcfg, _, tp = dense_model(arch)
    _, tb = token_batch(tcfg, 2, 36, seed=3)
    cache = TE.init_cache(tcfg, 2, 48, device="cpu")
    assert set(cache) == {"k", "v"}
    lg, cache = TE.prefill(tp, tcfg, tb, cache)
    full, _ = TZ.forward(tp, tcfg, tb)
    close(lg[:, 0], full[:, -1], LOGIT_TOL, LOGIT_TOL)
    tok = torch.full((2, 1), 7)
    lg2, _ = TE.decode_step(tp, tcfg, tok, cache, 36)
    full2, _ = TZ.forward(tp, tcfg,
                          dict(tb, tokens=torch.cat([tb["tokens"], tok], 1)))
    close(lg2[:, 0], full2[:, -1], FWD_TOL, FWD_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_decode_matches_reference_engine(arch):
    """Prefill of 20 tokens and 6 greedy decode steps on both engines, each
    fed the reference's token: logits at LOGIT_TOL at every step, the
    greedy token exactly wherever the top-2 margin exceeds twice that, the
    caches at 1e-5."""
    jcfg, tcfg, jp, tp = dense_model(arch)
    jb, tb = token_batch(jcfg, 2, 20, seed=7)
    jc, tc = JE.init_cache(jcfg, 2, 32), TE.init_cache(tcfg, 2, 32,
                                                       device="cpu")
    assert {k: v.shape for k, v in JE.cache_shapes(jcfg, 2, 32).items()} \
        == {k: s for k, (s, _) in TE.cache_shapes(tcfg, 2, 32).items()}
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    tl, tc = TE.prefill(tp, tcfg, tb, tc)
    checked = 0
    for step in range(7):
        want, got = np.asarray(jl)[:, -1], n(tl)[:, -1]
        close(got, want, LOGIT_TOL, LOGIT_TOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL
        np.testing.assert_array_equal(got.argmax(-1)[sure],
                                      want.argmax(-1)[sure])
        checked += int(sure.sum())
        if step == 6:
            break
        tok = want.argmax(-1)[:, None]
        jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(20 + step))
        tl, tc = TE.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                20 + step)
    assert checked > 0
    for k in jc:
        close(tc[k], jc[k], MOE_TOL, MOE_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_train_step_matches_reference(arch):
    """Three Adam steps of `zoo.train_step` (NLL + 0.01 aux) against the
    reference's: losses rtol 1e-5; the first step's gradients, through
    Adam's first moment, within 1e-3 of each leaf's largest."""
    jcfg, tcfg, jp, tp = dense_model(arch)
    jo, to = jadam(1e-3), tadam(1e-3)
    js, ts = jo.init(jp), to.init(tp)
    step = jax.jit(lambda p, o, b: JZ.train_step(p, o, b, jcfg, jo.update))
    rng = np.random.default_rng(0)
    for i in range(3):
        tb = TLT.lm_batch(tcfg, rng, 2, 24, "cpu")
        jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
        jp, js, jl = step(jp, js, jb)
        tp, ts, tl = TZ.train_step(tp, ts, tb, tcfg, to.update)
        close(tl, jl, rtol=1e-5, atol=1e-5)
        if i == 0:          # m = (1 - b1) g: the gradients
            jm = jax.tree_util.tree_leaves(jax.device_get(js["m"]))
            tm = list(TMB.tree_leaves(ts["m"]))
            assert len(jm) == len(tm)
            for a, b in zip(jm, tm):
                close(b, a, rtol=0, atol=1e-3 * float(np.abs(a).max()))
    assert all(torch.isfinite(p).all() for p in TMB.tree_leaves(tp))


def test_train_launcher_lm_target_moe_on_cpu(capsys):
    losses = TLT.main(["--target", "lm", "--arch", "dbrx-132b", "--smoke",
                       "--steps", "3", "--seq", "16", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "[train] dbrx-smoke" in out and "final loss" in out


def test_neural_stage_scores_with_a_moe_model():
    """`launch.serve --neural dbrx-132b`'s scorer (the smoke model in
    float32) runs the moe blocks: its hidden state through the LM head is
    the forward's logits bit for bit, and its scores are finite. The
    reference's scorer runs the dense block alone, so it has no moe
    counterpart to hold this to."""
    scorer = TLS.build_neural("dbrx-132b", device="cpu")
    assert scorer.cfg.arch_type == "moe"
    feats = torch.from_numpy(np.random.default_rng(8).normal(
        size=(5, 24)).astype(np.float32))
    tokens = scorer.tokenize(feats)
    hidden = scorer._hidden(tokens)
    logits, _ = TZ.forward(scorer.params, scorer.cfg, {"tokens": tokens})
    assert torch.equal(TZ._lm_head(scorer.params, scorer.cfg, hidden),
                       logits)
    scores = scorer.score(feats)
    assert tuple(scores.shape) == (5,) and torch.isfinite(scores).all()
