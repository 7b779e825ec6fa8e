"""The port's ssm (rwkv6) and hybrid (zamba2) families on the CPU against
the reference: the configs' sizes from the templates alone, each sequence
mixer in both forms (`mamba2_scan` / `mamba2_chunked`, `rwkv6_timemix` /
`rwkv6_timemix_chunked`, and `rwkv6_channelmix`) with and without an
initial state, their gradients against `jax.grad`, the smoke models'
forward in both forms (and zamba2 with a tail layer after its last shared
block), prefill and decode against the port's own forward and against the
reference's engine (logits, greedy tokens and every cache leaf), three Adam
steps, the LM train launcher, and the neural stage's refusal of both
families.

The reference's parameters come from its own `materialize`; every leaf the
templates initialise to zeros or ones (the LoRA B's, mu_*, w0, u, dt_bias,
conv_b, A_log, D and the norms) then gets small numpy noise, so the LoRA
paths, the bonus term and the data-dependent shift are not zero, and the
tree carries across with `zoo.params_from_numpy`. Inputs are numpy draws
from a seed.

Tolerances: mixer outputs and states 2e-5, the reference's own bar between
its two forms (tests/test_perf_variants.py); gradients 1e-5 (absolute
part times the leaf's largest gradient where that exceeds 1); logits 2e-4
(LOGIT_TOL, the reference's bar between its prefill and its forward),
decode against forward 2e-3 (the reference's bar for that check); bf16
logits within 4 bf16 ulps of their scale (tests/test_torch_models.py);
train steps at tests/test_torch_trainer.py's bars. Greedy tokens exactly
where the top-2 margin exceeds twice LOGIT_TOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
import repro_torch.configs as TCFG
from repro.models import base as JMB
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
from torch_parity import SSM_ARCHS, close, exact, n, token_batch

MIX_TOL = 2e-5
GRAD_TOL = 1e-5
LOGIT_TOL = 2e-4
FWD_TOL = 2e-3
NOISE = 0.1
NOISE_GRAD = 1e-2    # see test_lm_train_step_matches_reference

_decode = jax.jit(JE.decode_step, static_argnums=(1,))


def ssm_model(arch, dtype="float32", seed=1, n_layers=None, impl="scan"):
    """(JAX cfg, port cfg, JAX params, port params) of the arch's smoke
    variant (n_layers deep, if given) in `dtype`: the reference's
    `materialize` from PRNGKey(seed), its zero- and one-initialised leaves
    plus NOISE * N(0, 1) drawn with numpy, carried over bit for bit."""
    jcfg = dataclasses.replace(JCFG.get_smoke(arch), dtype=getattr(jnp, dtype),
                               ssm_impl=impl)
    tcfg = dataclasses.replace(TCFG.get_smoke(arch),
                               dtype=getattr(torch, dtype), ssm_impl=impl)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
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


def _layer0(jp, tp, key):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])[key],
            TMB.tree_map(lambda a: a[0], tp["blocks"])[key])


def _np(shape, seed, scale):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


# mixer name -> (arch, block key, reference fn, port fn, chunked)
MIXERS = {
    "mamba2_scan": ("zamba2-1.2b", "mixer", JL.mamba2_scan, TL.mamba2_scan,
                    False),
    "mamba2_chunked": ("zamba2-1.2b", "mixer", JL.mamba2_chunked,
                       TL.mamba2_chunked, True),
    "rwkv6_timemix": ("rwkv6-1.6b", "tm", JL.rwkv6_timemix,
                      TL.rwkv6_timemix, False),
    "rwkv6_timemix_chunked": ("rwkv6-1.6b", "tm", JL.rwkv6_timemix_chunked,
                              TL.rwkv6_timemix_chunked, True),
    "rwkv6_channelmix": ("rwkv6-1.6b", "cm", JL.rwkv6_channelmix,
                         TL.rwkv6_channelmix, False),
}


def _state(name, cfg, b, seed):
    """A random initial state of the mixer (numpy arrays)."""
    d = cfg.d_model
    if name.startswith("mamba2"):
        return {"conv": _np((b, cfg.ssm_conv - 1,
                             cfg.ssm_d_inner + 2 * cfg.ssm_state), seed, 0.3),
                "ssm": _np((b, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), seed + 1, 0.3)}
    if name == "rwkv6_channelmix":
        return {"shift": _np((b, d), seed, 0.2)}
    hd = cfg.rwkv_head_dim
    return {"shift": _np((b, d), seed, 0.2),
            "wkv": _np((b, d // hd, hd, hd), seed + 1, 0.2)}


def _call(fn, name, p, cfg, x, state, chunk, chunked):
    if name == "rwkv6_channelmix":
        return fn(p, x, state)
    kw = {"chunk": chunk} if chunked else {}
    return fn(p, cfg, x, state, **kw)


def _mixer_case(name, s, chunk, with_state, seed=0):
    arch, key, jfn, tfn, chunked = MIXERS[name]
    jcfg, tcfg, jp, tp = ssm_model(arch)
    jm, tm = _layer0(jp, tp, key)
    x = _np((2, s, jcfg.d_model), seed + s, 0.5)
    st = _state(name, jcfg, 2, seed + 7) if with_state else None

    def jrun(p, x_, st_):
        return _call(jfn, name, p, jcfg, x_, st_, chunk, chunked)

    def trun(p, x_, st_):
        return _call(tfn, name, p, tcfg, x_, st_, chunk, chunked)

    return jm, tm, x, st, jrun, trun


_CASES = ([(nm, s, c) for nm in ("mamba2_chunked", "rwkv6_timemix_chunked")
           for s in (1, 33, 70) for c in (8, 16)]
          + [(nm, s, None) for nm in ("mamba2_scan", "rwkv6_timemix",
                                      "rwkv6_channelmix")
             for s in (1, 33, 70)])


# ---------------------------------------------------------------------------
# configs and templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers,params", [
    ("rwkv6-1.6b", 24, 1_615_351_296), ("rwkv6-1.6b", 2, 380_680_320),
    ("zamba2-1.2b", 38, 1_178_862_464), ("zamba2-1.2b", 7, 385_681_088)])
def test_full_config_sizes_from_templates_alone(arch, layers, params):
    """Parameter counts at the published widths, at full depth and at the
    depths the card's float32 checks run (rwkv6 2 layers, zamba2 7: one
    group and a tail layer), from the templates, nothing allocated; equal
    to the reference's; zamba2's shared block unstacked, once."""
    tcfg = dataclasses.replace(TCFG.get(arch), n_layers=layers)
    jcfg = dataclasses.replace(JCFG.get(arch), n_layers=layers)
    assert tcfg.param_count() == jcfg.param_count() == params
    t = TZ.templates(tcfg)
    assert ("shared_attn" in t) == (arch == "zamba2-1.2b")
    if arch == "zamba2-1.2b":
        d = tcfg.d_model
        assert t["shared_attn"]["proj_in"].shape == (2 * d, d)
        assert TZ.shared_applications(tcfg) == layers // 6


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name,s,chunk", _CASES)
def test_mixer_matches_reference(name, s, chunk, with_state):
    """Output and every state leaf at 2e-5, in float32."""
    jm, tm, x, st, jrun, trun = _mixer_case(name, s, chunk, with_state)
    want, want_st = jrun(jm, jnp.asarray(x),
                         None if st is None else
                         {k: jnp.asarray(v) for k, v in st.items()})
    got, got_st = trun(tm, exact(x),
                       None if st is None else
                       {k: exact(v) for k, v in st.items()})
    assert got.shape == want.shape and set(got_st) == set(want_st)
    close(got, want, MIX_TOL, MIX_TOL)
    for k in want_st:
        assert got_st[k].dtype == exact(np.asarray(want_st[k])).dtype, k
        close(got_st[k], want_st[k], MIX_TOL, MIX_TOL)


@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_gradients_match_reference(name):
    """Gradients of <out, r> + sum_k <state_k, r_k> to every parameter, the
    input and the initial state against jax.grad's, at 1e-5 of each leaf's
    scale (S = 33, a chunk of 8: a partial last chunk)."""
    jm, tm, x, st, jrun, trun = _mixer_case(name, 33, 8, True)
    rng = np.random.default_rng(11)
    out0, st0 = jrun(jm, jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in st.items()})
    r = rng.normal(size=out0.shape).astype(np.float32)
    rs = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in st0.items()}

    def jloss(p, x_, st_):
        out, new = jrun(p, x_, st_)
        return jnp.sum(out * r) + sum(jnp.sum(new[k] * rs[k]) for k in rs)

    jg_p, jg_x, jg_s = jax.grad(jloss, argnums=(0, 1, 2))(
        jm, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    leaves = TMB.tree_map(lambda a: a.clone().requires_grad_(True), tm)
    xt = exact(x).requires_grad_(True)
    stt = {k: exact(v).requires_grad_(True) for k, v in st.items()}
    out, new = trun(leaves, xt, stt)
    (torch.sum(out * exact(r))
     + sum(torch.sum(new[k] * exact(rs[k])) for k in rs)).backward()
    for k in jg_p:
        _close_grad(leaves[k].grad, jg_p[k])
    _close_grad(xt.grad, jg_x)
    for k in jg_s:
        _close_grad(stt[k].grad, jg_s[k])


def _close_grad(got, want):
    """GRAD_TOL, its absolute part scaled by the leaf's largest gradient
    where that exceeds 1: rwkv6's wr / wk gradients reach ~12, sums over
    66 tokens of terms that went through a 33-step float32 recurrence,
    and the two frameworks' orders differ there by up to ~3e-6 of that
    scale."""
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    close(got, want, GRAD_TOL, GRAD_TOL * scale)


def test_softplus_is_logaddexp_past_the_threshold():
    """jax.nn.softplus(x) = logaddexp(x, 0) also above 20, where
    F.softplus returns x itself."""
    x = np.array([-30.0, -1.0, 0.0, 19.5, 20.5, 40.0], np.float32)
    close(TL.softplus(exact(x)), jax.nn.softplus(jnp.asarray(x)), 0, 0)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

MODELS = [("rwkv6-1.6b", None), ("zamba2-1.2b", None), ("zamba2-1.2b", 3)]


@pytest.mark.parametrize("impl", ["scan", "chunked"])
@pytest.mark.parametrize("arch,layers", MODELS)
def test_forward_matches_reference(arch, layers, impl):
    """Logits at LOGIT_TOL and an aux loss of 0, in both ssm_impl forms
    (zamba2 at 3 layers: one group of 2 and a tail layer after the shared
    block)."""
    jcfg, tcfg, jp, tp = ssm_model(arch, n_layers=layers, impl=impl)
    jb, tb = token_batch(jcfg, 2, 40, seed=1)
    want, _ = JZ.forward(jp, jcfg, jb)
    got, aux = TZ.forward(tp, tcfg, tb)
    assert tuple(got.shape) == (2, 40, jcfg.vocab)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    close(got, want, LOGIT_TOL, LOGIT_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_forward_in_bf16_stays_near_reference(arch):
    """The reference's bfloat16 weights: logits within 4 bf16 ulps of
    their scale (the two frameworks round bf16 intermediates at other
    places; each form keeps its own casts)."""
    jcfg, tcfg, jp, tp = ssm_model(arch, dtype="bfloat16")
    jb, tb = token_batch(jcfg, 2, 12, seed=2)
    want = np.asarray(JZ.forward(jp, jcfg, jb)[0], np.float32)
    got = TZ.forward(tp, tcfg, tb)[0]
    assert got.dtype == torch.bfloat16
    got = n(got.float())
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * scale / 128)


@pytest.mark.parametrize("impl", ["scan", "chunked"])
@pytest.mark.parametrize("arch,layers", MODELS)
def test_prefill_and_decode_match_own_forward(arch, layers, impl):
    """tests/test_arch_smoke.py's check on the port: prefill's last logits
    equal the forward's (LOGIT_TOL), one decode step from the cached state
    (K8's plain version on zamba2's shared block) the forward over the
    extended sequence (FWD_TOL)."""
    _, tcfg, _, tp = ssm_model(arch, n_layers=layers, impl=impl)
    _, tb = token_batch(tcfg, 2, 36, seed=3)
    cache = TE.init_cache(tcfg, 2, 48, device="cpu")
    lg, cache = TE.prefill(tp, tcfg, tb, cache)
    full, _ = TZ.forward(tp, tcfg, tb)
    close(lg[:, 0], full[:, -1], LOGIT_TOL, LOGIT_TOL)
    tok = torch.full((2, 1), 7)
    lg2, _ = TE.decode_step(tp, tcfg, tok, cache, 36)
    full2, _ = TZ.forward(tp, tcfg,
                          dict(tb, tokens=torch.cat([tb["tokens"], tok], 1)))
    close(lg2[:, 0], full2[:, -1], FWD_TOL, FWD_TOL)


@pytest.mark.parametrize("impl", ["scan", "chunked"])
@pytest.mark.parametrize("arch,layers", MODELS)
def test_engine_matches_reference_engine(arch, layers, impl):
    """Prefill of 20 tokens over a cache holding noise (prefill must not
    read it) and 4 greedy decode steps on both engines, each fed the
    reference's token: logits at LOGIT_TOL at every step, the greedy token
    exactly where the margin allows, and every cache leaf against the
    reference's returned cache at 2e-5 after the prefill and after the
    last step; K8's plain version once per shared-block application per
    step."""
    jcfg, tcfg, jp, tp = ssm_model(arch, n_layers=layers, impl=impl)
    jb, tb = token_batch(jcfg, 2, 20, seed=7)
    shapes = JE.cache_shapes(jcfg, 2, 32)
    assert {k: v.shape for k, v in shapes.items()} == {
        k: s for k, (s, _) in TE.cache_shapes(tcfg, 2, 32).items()}
    assert {k: str(v.dtype) for k, v in shapes.items()} == {
        k: str(dt).removeprefix("torch.")
        for k, (_, dt) in TE.cache_shapes(tcfg, 2, 32).items()}
    jc = JE.init_cache(jcfg, 2, 32)
    tc = TE.init_cache(tcfg, 2, 32, device="cpu")
    for k, v in tc.items():       # prefill starts every recurrence at zero
        if k not in ("attn_k", "attn_v"):
            v.normal_(generator=torch.Generator().manual_seed(5))
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    tl, tc = TE.prefill(tp, tcfg, tb, tc)
    for k in jc:
        close(tc[k], jc[k], MIX_TOL, MIX_TOL)
    checked, k8 = 0, TL.ops.swa_decode
    calls = []
    TL.ops.swa_decode = lambda *a, **kw: calls.append(1) or k8(*a, **kw)
    try:
        for step in range(5):
            want, got = np.asarray(jl)[:, -1], n(tl)[:, -1]
            close(got, want, LOGIT_TOL, LOGIT_TOL)
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL
            np.testing.assert_array_equal(got.argmax(-1)[sure],
                                          want.argmax(-1)[sure])
            checked += int(sure.sum())
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
    g = TZ.shared_applications(tcfg) if arch == "zamba2-1.2b" else 0
    assert len(calls) == 4 * g
    for k in jc:
        close(tc[k], jc[k], MIX_TOL, MIX_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_lm_train_step_matches_reference(arch):
    """Three Adam steps of `zoo.train_step` against the reference's, each
    taken by the port from the reference's params and optimizer state of
    that step: the loss at rtol 1e-5; the first moment (the gradients'
    running mean) within 1e-3 of each leaf's largest; the new params at
    1e-5 wherever the step's gradient exceeds NOISE_GRAD of its leaf's
    largest. The two packages' gradients agree to ~3e-5 of each leaf's
    scale, and Adam's update moves by about lr times that over the
    gradient: for the smallest gradients it is +-lr on a sign that
    float32 rounding decides (~11 of rwkv6-smoke's 2.1M elements flip in
    the first step), and below NOISE_GRAD it can exceed 1e-5. Carried
    along, the flips move the next batch's loss by ~1e-5 relative, so
    each step starts from the reference's state rather than from the
    port's last."""
    jcfg, tcfg, jp, tp = ssm_model(arch)
    jo, to = jadam(1e-3), tadam(1e-3)
    js = jo.init(jp)
    step = jax.jit(lambda p, o, b: JZ.train_step(p, o, b, jcfg, jo.update))
    rng = np.random.default_rng(0)
    for i in range(3):
        tb = TLT.lm_batch(tcfg, rng, 2, 24, "cpu")
        jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
        tp = TZ.params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
        ts = {"step": torch.tensor(int(js["step"]), dtype=torch.int32),
              **{k: TZ.params_from_numpy(jax.device_get(js[k]), tcfg,
                                         device="cpu") for k in ("m", "v")}}
        jm0 = jax.tree_util.tree_leaves(jax.device_get(js["m"]))
        jp, js, jl = step(jp, js, jb)
        tp, ts, tl = TZ.train_step(tp, ts, tb, tcfg, to.update)
        close(tl, jl, rtol=1e-5, atol=1e-5)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        jm = jax.tree_util.tree_leaves(jax.device_get(js["m"]))
        tm = list(TMB.tree_leaves(ts["m"]))
        want_p = jax.tree_util.tree_leaves(jax.device_get(jp))
        got_p = list(TMB.tree_leaves(tp))
        assert len(jm) == len(tm) == len(want_p) == len(got_p)
        for m0, a, b, pa, pb in zip(jm0, jm, tm, want_p, got_p):
            close(b, a, rtol=0, atol=1e-3 * float(np.abs(a).max()))
            g = np.abs(np.asarray(a) - 0.9 * np.asarray(m0))   # (1-b1)|g|
            sure = g > NOISE_GRAD * g.max()
            close(n(pb)[sure], np.asarray(pa)[sure], 1e-5, 1e-5)
    assert all(torch.isfinite(p).all() for p in TMB.tree_leaves(tp))


def test_train_launcher_lm_target_on_cpu(capsys):
    losses = TLT.main(["--target", "lm", "--arch", "rwkv6-1.6b", "--smoke",
                       "--steps", "3", "--seq", "16", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "[train] rwkv6-smoke" in out and "final loss" in out


@pytest.mark.parametrize("layers,applications", [(1, 0), (2, 1)])
def test_train_launcher_counts_shared_applications(layers, applications,
                                                   capsys):
    """`--layers N` on zamba2 keeps N // attn_every shared-block
    applications (none below attn_every = 2 in the smoke config), and the
    header says so."""
    losses = TLT.main(["--target", "lm", "--arch", "zamba2-1.2b", "--smoke",
                       "--layers", str(layers), "--steps", "1", "--seq", "8",
                       "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert (f"{layers} layers, {applications} shared-block applications"
            in capsys.readouterr().out)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_neural_stage_refuses_recurrent_families(arch, monkeypatch):
    """`--neural` with either family raises ValueError before a weight is
    drawn: the reference's scorer runs the dense block alone."""
    monkeypatch.setattr(TMB, "materialize", None)   # drawing would fail
    with pytest.raises(ValueError, match="neural final stage"):
        TLS.build_neural(arch, device="cpu")
