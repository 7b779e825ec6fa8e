"""The port's encdec family (seamless-m4t-large-v2) on the CPU against the
reference: the full config's size from the templates alone, cross
attention with several queries and with one (the latter through K8's plain
version), the smoke model's forward and its `lm_loss` gradients, bf16,
prefill and decode against the port's own forward and against the
reference's engine (logits, greedy tokens and every cache leaf, the cross
K/V included), the cache's encoder length refusing another frontend, K8's
calls per decode step, three Adam steps, the LM launcher's batch against
the reference's `train_lm` draw, the neural stage on seamless, and
`configs.shapes` against the reference's for every arch and shape.

The reference's parameters come from its own `materialize`; every leaf the
templates initialise to zeros (the norms) then gets NOISE * N(0, 1) drawn
with numpy, and the tree carries across with `zoo.params_from_numpy`.
Inputs are numpy draws from a seed.

Tolerances: cross attention 2e-5 (the mixers' bar of
tests/test_torch_ssm.py); logits 2e-4 (LOGIT_TOL, the reference's bar
between its prefill and its forward), decode against forward 2e-3 (the
reference's bar for that check); gradients 1e-5 (the absolute part times
the leaf's largest where that exceeds 1); cache leaves 2e-5; bf16 logits
within 4 bf16 ulps of their scale (tests/test_torch_models.py); train
steps at tests/test_torch_trainer.py's bars. Greedy tokens exactly where
the top-2 margin exceeds twice LOGIT_TOL.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
import repro_torch.configs as TCFG
from repro.configs import shapes as JSH
from repro.launch import train as JLT
from repro.models import base as JMB
from repro.models import layers as JL
from repro.models import zoo as JZ
from repro.optim import adam as jadam
from repro.serving import engine as JE
from repro.serving.cascade_server import NeuralScorer as JNeural
from repro_torch.configs import shapes as TSH
from repro_torch.launch import serve as TLS
from repro_torch.launch import train as TLT
from repro_torch.models import base as TMB
from repro_torch.models import layers as TL
from repro_torch.models import zoo as TZ
from repro_torch.optim import adam as tadam
from repro_torch.serving import engine as TE
from repro_torch.serving.cascade_server import NeuralScorer as TNeural
from torch_parity import ENC_FRAMES, close, exact, n, token_batch

ARCH = "seamless-m4t-large-v2"
CROSS_TOL = 2e-5
LOGIT_TOL = 2e-4
FWD_TOL = 2e-3
GRAD_TOL = 1e-5
CACHE_TOL = 2e-5
NOISE = 0.1

_decode = jax.jit(JE.decode_step, static_argnums=(1,))


def encdec_model(dtype="float32", seed=1, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) of seamless-smoke in
    `dtype` (with `overrides` of its config): the reference's
    `materialize` from PRNGKey(seed), its zero-initialised leaves plus
    NOISE * N(0, 1) drawn with numpy, carried over bit for bit."""
    jcfg = dataclasses.replace(JCFG.get_smoke(ARCH), dtype=getattr(jnp, dtype),
                               **overrides)
    tcfg = dataclasses.replace(TCFG.get_smoke(ARCH),
                               dtype=getattr(torch, dtype), **overrides)
    tmpl = JZ.templates(jcfg)
    jp = JMB.materialize(tmpl, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)

    def perturb(t, a):
        a = np.asarray(a)
        if t.init in ("zeros", "ones"):
            a = a + NOISE * rng.normal(size=a.shape).astype(np.float32)
        return jnp.asarray(a, jcfg.dtype)

    jp = jax.tree_util.tree_map(perturb, tmpl, jp)
    tp = TZ.params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _greedy_equal(got, want) -> int:
    """The greedy tokens of logits (B, V) equal wherever want's top-2
    margin exceeds twice LOGIT_TOL; returns how many were compared."""
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    return int(sure.sum())


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_full_config_size_from_templates_alone():
    """2,034,784,256 parameters at the published widths and full depth
    (24 + 24 layers), from the templates, nothing allocated; equal to the
    reference's; the decoder's blocks carry ln_cross and cross."""
    tcfg, jcfg = TCFG.get(ARCH), JCFG.get(ARCH)
    assert tcfg.param_count() == jcfg.param_count() == 2_034_784_256
    t = TZ.templates(tcfg)
    assert t["enc_blocks"]["attn"]["wq"].shape == (24, 1024, 1024)
    assert t["blocks"]["cross"]["wk"].shape == (24, 1024, 1024)
    assert t["blocks"]["ln_cross"].shape == (24, 1024)
    assert t["enc_norm"].shape == (1024,) and "head" in t


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("sq,s_enc", [(5, 16), (1, 16), (1, 37), (3, 8193)])
def test_cross_attention_matches_reference(sq, s_enc, qk_norm):
    """`attention(..., cross_kv=(k, v, "heads"))` on the decoder's layer-0
    cross weights: no rope, q normed only under qk_norm, no mask. Several
    queries take the full attention (blockwise past 8192 keys), one query
    K8's plain version over every encoder position, at 2e-5."""
    jcfg, tcfg, jp, tp = encdec_model(qk_norm=qk_norm)
    jx = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["cross"])
    tx = {k: v[0] for k, v in tp["blocks"]["cross"].items()}
    hkv, hd = jcfg.n_kv_heads, jcfg.hd
    x = _np((2, sq, jcfg.d_model), 3, 0.5)
    k = _np((2, s_enc, hkv, hd), 4)
    v = _np((2, s_enc, hkv, hd), 5)
    pos = np.arange(sq)[None].repeat(2, 0)
    want, _ = JL.attention(jx, jcfg, jnp.asarray(x),
                           positions=jnp.asarray(pos), causal=False,
                           cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    calls = []
    k8 = TL.ops.swa_decode
    TL.ops.swa_decode = lambda *a, **kw: calls.append(a[3]) or k8(*a, **kw)
    try:
        got, cache = TL.attention(tx, tcfg, exact(x),
                                  positions=torch.from_numpy(pos),
                                  causal=False,
                                  cross_kv=(exact(k), exact(v), "heads"))
    finally:
        TL.ops.swa_decode = k8
    assert cache is None and tuple(got.shape) == (2, sq, jcfg.d_model)
    assert calls == ([s_enc - 1] if sq == 1 else [])
    close(got, want, CROSS_TOL, CROSS_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_matches_reference():
    """Logits at LOGIT_TOL over 16 frames and 20 tokens, aux 0; the
    frontend is the encoder's input, so the logits cover the tokens
    alone."""
    jcfg, tcfg, jp, tp = encdec_model()
    jb, tb = token_batch(jcfg, 2, 20, seed=1)
    assert tuple(tb["frontend"].shape) == (2, ENC_FRAMES, jcfg.d_model)
    want, _ = JZ.forward(jp, jcfg, jb)
    got, aux = TZ.forward(tp, tcfg, tb)
    assert tuple(got.shape) == (2, 20, jcfg.vocab)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    close(got, want, LOGIT_TOL, LOGIT_TOL)


def test_lm_loss_gradients_match_reference():
    """`lm_loss` and its gradient to every leaf (encoder, decoder, cross
    weights, norms, head, embedding) against jax.grad's, at GRAD_TOL."""
    jcfg, tcfg, jp, tp = encdec_model()
    rng = np.random.default_rng(2)
    tb = TLT.lm_batch(tcfg, rng, 2, 12, "cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    want, jg = jax.value_and_grad(JZ.lm_loss)(jp, jcfg, jb)
    leaves = TMB.tree_map(lambda a: a.clone().requires_grad_(True), tp)
    loss = TZ.lm_loss(leaves, tcfg, tb)
    loss.backward()
    close(loss, want, GRAD_TOL, GRAD_TOL)
    jl = jax.tree_util.tree_leaves(jax.device_get(jg))
    tl = list(TMB.tree_leaves(leaves))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        scale = max(1.0, float(np.abs(a).max()))
        close(b.grad, a, GRAD_TOL, GRAD_TOL * scale)


def test_forward_in_bf16_stays_near_reference():
    """The reference's bfloat16 weights: logits within 4 bf16 ulps of
    their scale."""
    jcfg, tcfg, jp, tp = encdec_model(dtype="bfloat16")
    jb, tb = token_batch(jcfg, 2, 12, seed=2)
    want = np.asarray(JZ.forward(jp, jcfg, jb)[0], np.float32)
    got = TZ.forward(tp, tcfg, tb)[0]
    assert got.dtype == torch.bfloat16
    got = n(got.float())
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * scale / 128)


def test_prefill_and_decode_match_own_forward():
    """Prefill's last logits equal the forward's (LOGIT_TOL); two decode
    steps (self and cross attention through K8's plain version) the
    forward over the extended sequence (FWD_TOL)."""
    _, tcfg, _, tp = encdec_model()
    _, tb = token_batch(tcfg, 2, 20, seed=3)
    cache = TE.init_cache(tcfg, 2, 24, ENC_FRAMES, device="cpu")
    lg, cache = TE.prefill(tp, tcfg, tb, cache)
    full, _ = TZ.forward(tp, tcfg, tb)
    close(lg[:, 0], full[:, -1], LOGIT_TOL, LOGIT_TOL)
    toks = tb["tokens"]
    for step, t in enumerate((7, 11)):
        tok = torch.full((2, 1), t)
        lg, cache = TE.decode_step(tp, tcfg, tok, cache, 20 + step)
        toks = torch.cat([toks, tok], 1)
        full, _ = TZ.forward(tp, tcfg, dict(tb, tokens=toks))
        close(lg[:, 0], full[:, -1], FWD_TOL, FWD_TOL)


def test_engine_matches_reference_engine():
    """Prefill of 20 tokens over 16 frames and 4 greedy decode steps on
    both engines, each fed the reference's token: logits at LOGIT_TOL at
    every step, the greedy token exactly where the margin allows, and
    every cache leaf (k, v, cross_k, cross_v, shapes and dtypes equal)
    against the reference's at CACHE_TOL after the prefill and after the
    last step; K8's plain version 2 x n_layers times a step, half of them
    at cache_len S_enc - 1 (the cross attention)."""
    jcfg, tcfg, jp, tp = encdec_model()
    jb, tb = token_batch(jcfg, 2, 20, seed=7)
    shapes = JE.cache_shapes(jcfg, 2, 32, ENC_FRAMES)
    got_shapes = TE.cache_shapes(tcfg, 2, 32, ENC_FRAMES)
    assert {k: v.shape for k, v in shapes.items()} == {
        k: s for k, (s, _) in got_shapes.items()}
    assert {k: str(v.dtype) for k, v in shapes.items()} == {
        k: str(dt).removeprefix("torch.") for k, (_, dt) in got_shapes.items()}
    jc = JE.init_cache(jcfg, 2, 32, ENC_FRAMES)
    tc = TE.init_cache(tcfg, 2, 32, ENC_FRAMES, device="cpu")
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    tl, tc = TE.prefill(tp, tcfg, tb, tc)
    for k in jc:
        close(tc[k], jc[k], CACHE_TOL, CACHE_TOL)
    checked, calls, k8 = 0, [], TL.ops.swa_decode
    TL.ops.swa_decode = lambda *a, **kw: calls.append(a[3]) or k8(*a, **kw)
    try:
        for step in range(5):
            want, got = np.asarray(jl)[:, -1], n(tl)[:, -1]
            close(got, want, LOGIT_TOL, LOGIT_TOL)
            checked += _greedy_equal(got, want)
            if step == 4:
                break
            tok = want.argmax(-1)[:, None]
            jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                             jnp.int32(20 + step))
            tl, tc = TE.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                    20 + step)
    finally:
        TL.ops.swa_decode = k8
    assert checked > 0
    assert len(calls) == 4 * 2 * tcfg.n_layers
    assert calls.count(ENC_FRAMES - 1) == 4 * tcfg.n_layers
    for k in jc:
        close(tc[k], jc[k], CACHE_TOL, CACHE_TOL)


def test_prefill_refuses_another_encoder_length():
    """A frontend whose length differs from the cache's S_enc raises, as
    the self cache does when it is too short."""
    _, tcfg, _, tp = encdec_model()
    _, tb = token_batch(tcfg, 2, 8, seed=4)
    cache = TE.init_cache(tcfg, 2, 16, ENC_FRAMES + 4, device="cpu")
    with pytest.raises(ValueError, match="encoder frames"):
        TE.prefill(tp, tcfg, tb, cache)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_decode_step_runs_k8_twice_per_layer(n_layers):
    """Each decode step calls ops.swa_decode 2 x n_layers times: each
    decoder layer's self attention at cache_len, its cross attention at
    S_enc - 1 with no window."""
    _, tcfg, _, tp = encdec_model(n_layers=n_layers, n_enc_layers=n_layers)
    _, tb = token_batch(tcfg, 2, 6, seed=5)
    cache = TE.prefill(tp, tcfg, tb, TE.init_cache(tcfg, 2, 9, ENC_FRAMES,
                                                   device="cpu"))[1]
    calls, k8 = [], TL.ops.swa_decode
    TL.ops.swa_decode = lambda *a, **kw: calls.append(
        (a[3], kw.get("window"))) or k8(*a, **kw)
    try:
        for step in range(3):
            TE.decode_step(tp, tcfg, torch.full((2, 1), 3), cache, 6 + step)
            want = [(6 + step, TL.NO_WINDOW),
                    (ENC_FRAMES - 1, TL.NO_WINDOW)] * n_layers
            assert calls == want, (step, calls)
            calls.clear()
    finally:
        TL.ops.swa_decode = k8


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_lm_train_step_matches_reference():
    """Three Adam steps of `zoo.train_step` against the reference's on the
    launcher's batches: the loss at rtol 1e-5 at every step, the first
    step's gradients (Adam's m = (1 - b1) g) within 1e-3 of each leaf's
    largest, finite params."""
    jcfg, tcfg, jp, tp = encdec_model()
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
        if i == 0:
            jm = jax.tree_util.tree_leaves(jax.device_get(js["m"]))
            tm = list(TMB.tree_leaves(ts["m"]))
            assert len(jm) == len(tm)
            for a, b in zip(jm, tm):
                close(b, a, rtol=0, atol=1e-3 * float(np.abs(a).max()))
    assert int(ts["step"]) == 3
    assert all(torch.isfinite(p).all() for p in TMB.tree_leaves(tp))


def test_lm_batch_matches_reference_train_lm_draw(monkeypatch):
    """The launcher's batches equal the ones the reference's `train_lm`
    draws from the same seed (its step replaced by a recorder): the
    tokens, the targets and ENC_FRAMES frontend frames drawn after them,
    the tokens uncut."""
    seen = []

    def record(params, opt_state, batch, cfg, opt_update):
        seen.append({k: np.asarray(v) for k, v in batch.items()})
        return params, opt_state, jnp.float32(0.0)

    monkeypatch.setattr(JZ, "train_step", record)
    monkeypatch.setattr(jax, "jit", lambda fn, *a, **kw: fn)
    JLT.train_lm(argparse.Namespace(arch=ARCH, smoke=True, seed=4, lr=1e-3,
                                    steps=3, batch=2, seq=10))
    cfg = dataclasses.replace(TCFG.get_smoke(ARCH), dtype=torch.float32)
    rng = np.random.default_rng(4)
    assert len(seen) == 3
    for want in seen:
        got = TLT.lm_batch(cfg, rng, 2, 10, "cpu")
        assert set(got) == set(want) == {"tokens", "targets", "frontend"}
        assert tuple(got["frontend"].shape) == (2, ENC_FRAMES, cfg.d_model)
        assert tuple(got["tokens"].shape) == (2, 10)
        for k in want:
            np.testing.assert_array_equal(n(got[k]), want[k])


def test_train_launcher_lm_layers_cuts_encoder_and_decoder(capsys):
    """`--layers 1` keeps the first layer of the encoder and of the
    decoder, and the header says so."""
    losses = TLT.main(["--target", "lm", "--arch", ARCH, "--smoke",
                       "--layers", "1", "--steps", "2", "--seq", "8",
                       "--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    cfg = dataclasses.replace(TCFG.get_smoke(ARCH), n_layers=1,
                              n_enc_layers=1)
    out = capsys.readouterr().out
    assert (f"[train] seamless-smoke: 1 layers + 1 encoder layers, "
            f"{cfg.param_count() / 1e6:.1f}M params") in out


# ---------------------------------------------------------------------------
# the neural stage
# ---------------------------------------------------------------------------

def test_neural_stage_scores_like_reference():
    """`build_neural` runs seamless; with the reference's weights the
    scorer's tokens equal and its scores agree (test_torch_neural.py's
    bars): the decoder blocks' self attention and MLP over the item
    tokens, no encoder, no cross attention."""
    scorer = TLS.build_neural(ARCH, device="cpu")
    assert scorer.cfg.arch_type == "encdec"
    jcfg = dataclasses.replace(JCFG.get_smoke(ARCH), dtype=jnp.float32)
    js = JNeural.create(jcfg, jax.random.PRNGKey(3))
    tp = TZ.params_from_numpy(jax.device_get(js.params), scorer.cfg,
                              device="cpu")
    ts = TNeural(cfg=scorer.cfg, params=tp, head=exact(js.head))
    feats = 1.5 * _np((29, 24), 6)
    np.testing.assert_array_equal(n(ts.tokenize(torch.from_numpy(feats))),
                                  np.asarray(js.tokenize(feats)))
    close(ts.score(torch.from_numpy(feats)), js.score(feats), 1e-4, 1e-7)
    assert np.isfinite(n(scorer.score(torch.from_numpy(feats)))).all()


# ---------------------------------------------------------------------------
# configs.shapes
# ---------------------------------------------------------------------------

def _spec(s) -> tuple:
    """A reference ShapeDtypeStruct as (shape, dtype name)."""
    return tuple(s.shape), str(s.dtype)


def _tspec(s) -> tuple:
    shape, dt = s
    return tuple(shape), str(dt).removeprefix("torch.")


@pytest.mark.parametrize("shape", list(JSH.SHAPES))
@pytest.mark.parametrize("arch", JCFG.all_archs())
def test_shapes_match_reference(arch, shape):
    """`applicable` and every input spec's shape and dtype equal the
    reference's; the decode step's cache_len is a host int."""
    jcfg, tcfg = JCFG.get(arch), TCFG.get(arch)
    assert dataclasses.asdict(TSH.SHAPES[shape]) == dataclasses.asdict(
        JSH.SHAPES[shape])
    assert TSH.SUBQUADRATIC_ARCHS == JSH.SUBQUADRATIC_ARCHS
    ok, why = TSH.applicable(tcfg, shape)
    assert ok == JSH.applicable(jcfg, shape)[0]
    assert bool(why) == (not ok)
    want, got = JSH.input_specs(jcfg, shape), TSH.input_specs(tcfg, shape)
    assert set(got) == set(want)
    for part in ("batch", "cache"):
        if part in want:
            assert {k: _spec(v) for k, v in want[part].items()} == {
                k: _tspec(v) for k, v in got[part].items()}, part
    if "cache_len" in want:
        assert _spec(want["cache_len"]) == ((), "int32")
        assert got["cache_len"] == ((), int)
