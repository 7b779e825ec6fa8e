"""The port's dense model zoo on the CPU against the reference: the
configs, the parameter templates and `materialize`'s init rule, every
layer on the same numpy inputs, and `zoo.forward` for every dense smoke
config from the reference's own `materialize` carried over by
`params_from_numpy` (bit for bit, bfloat16 included).

Tolerances: layers rtol/atol 1e-5 in float32 (sums taken in another
order); forward logits 2e-4, the reference's own bar between its prefill
and its forward (tests/test_arch_smoke.py)."""

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
from repro_torch.models import base as TMB
from repro_torch.models import layers as TL
from repro_torch.models import zoo as TZ
from torch_parity import DENSE_ARCHS, close, dense_model, exact, n, \
    token_batch

LAYER_TOL = 1e-5
LOGIT_TOL = 2e-4


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# configs and templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JCFG.all_archs())
def test_configs_match_reference(arch):
    assert TCFG.ARCH_IDS == JCFG.ARCH_IDS
    assert TCFG.ALIASES == JCFG.ALIASES
    assert TCFG.all_archs() == JCFG.all_archs()
    if arch not in DENSE_ARCHS:
        for get in (TCFG.get, TCFG.get_smoke):
            with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
                get(arch)
        return
    for jget, tget in ((JCFG.get, TCFG.get), (JCFG.get_smoke, TCFG.get_smoke)):
        jc, tc = dataclasses.asdict(jget(arch)), dataclasses.asdict(tget(arch))
        assert (jc.pop("dtype"), tc.pop("dtype")) == (jnp.bfloat16,
                                                      torch.bfloat16)
        assert jc == tc


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_templates_and_param_counts_match_reference(arch):
    jcfg, tcfg = JCFG.get(arch), TCFG.get(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    jt = jax.tree_util.tree_leaves(JZ.templates(jcfg))
    tt = list(TMB.tree_leaves(TZ.templates(tcfg)))
    assert [(a.shape, a.axes, a.init, a.scale) for a in jt] \
        == [(b.shape, b.axes, b.init, b.scale) for b in tt]
    assert (TZ.window_schedule(tcfg) == JZ.window_schedule(jcfg)).all()


def test_gemma3_27b_fits_one_card_in_bf16():
    cfg = TCFG.get("gemma3-27b")
    assert cfg.param_count() == 21_250_080_512     # 42.5 GB in bf16
    assert [cfg.is_global_layer(i) for i in range(12)] == [False] * 5 + [
        True] + [False] * 5 + [True]


def test_materialize_follows_the_init_rule():
    tmpl = {"w": TMB.ParamTemplate((64, 512), ("a", "b")),
            "z": TMB.ParamTemplate((7,), (None,), "zeros"),
            "o": TMB.ParamTemplate((3, 5), (None, None), "ones"),
            "s": TMB.ParamTemplate((256, 400), ("a", "b"), "small", 2.0),
            "blocks": TMB.stack_tree(
                {"x": TMB.ParamTemplate((128, 64), ("a", "b"))}, 3)}
    p = TMB.materialize(tmpl, torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    assert p["blocks"]["x"].shape == (3, 128, 64)
    assert all(t.dtype == torch.bfloat16 for t in TMB.tree_leaves(p))
    assert not p["z"].any() and (p["o"] == 1).all()
    assert abs(p["w"].float().std().item() - 0.02) < 0.002
    assert abs(p["s"].float().std().item() - 2.0 / 20.0) < 0.01
    again = TMB.materialize(tmpl, torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(TMB.tree_leaves(p),
                                                 TMB.tree_leaves(again)))


def test_unstack_gives_views_of_each_layer():
    stacked = {"a": torch.arange(12.0).reshape(3, 4),
               "m": {"b": torch.arange(6.0).reshape(3, 2)}}
    layers = TMB.unstack(stacked, 3)
    assert torch.equal(layers[2]["a"], stacked["a"][2])
    assert torch.equal(layers[1]["m"]["b"], stacked["m"]["b"][1])
    assert layers[0]["a"].data_ptr() == stacked["a"].data_ptr()


def test_bf16_params_cross_bit_for_bit():
    """A bfloat16 tree from the reference's materialize arrives in the port
    with the same bits in every leaf."""
    _, tcfg, jp, tp = dense_model("gemma3-27b", dtype="bfloat16")
    jl = jax.tree_util.tree_leaves(jp)
    tl = list(TMB.tree_leaves(tp))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      b.view(torch.int16).numpy()
                                      .view(np.uint16))


def test_params_from_numpy_refuses_a_wrong_tree():
    jcfg, tcfg, jp, _ = dense_model("yi-34b")
    tree = jax.device_get(jp)
    bad = dict(tree, head=tree["head"][:, :7])
    with pytest.raises(ValueError, match="template wants"):
        TZ.params_from_numpy(bad, tcfg, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "head"}
    with pytest.raises(ValueError, match="keys"):
        TZ.params_from_numpy(bad, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    x, g = _np(2, 5, 64, seed=1, scale=3.0), _np(64, seed=2, scale=0.1)
    close(TL.rms_norm(exact(x), exact(g)), JL.rms_norm(x, g),
          LAYER_TOL, LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    x = _np(2, 6, 32, seed=3)
    p = {"wg": _np(32, 48, seed=4, scale=0.2), "wi": _np(32, 48, seed=5,
                                                         scale=0.2),
         "wo": _np(48, 32, seed=6, scale=0.2)}
    if act == "gelu":
        del p["wg"]
    got = TL.mlp(exact(x), {k: exact(v) for k, v in p.items()}, act)
    close(got, JL.mlp(x, p, act), LAYER_TOL, LAYER_TOL)


@pytest.mark.parametrize("positions_shape", [(7,), (2, 7)])
def test_rope_matches_reference(positions_shape):
    x = _np(2, 7, 3, 64, seed=7)
    pos = np.random.default_rng(8).integers(0, 5000, positions_shape)
    got = TL.rope(exact(x), torch.from_numpy(pos), 1_000_000.0)
    close(got, JL.rope(x, jnp.asarray(pos), 1_000_000.0), LAYER_TOL,
          LAYER_TOL)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, JL.NO_WINDOW, 0), (True, 5, 0), (False, JL.NO_WINDOW, 0),
    (True, 9, 4)])
def test_dot_and_blockwise_attention_match_reference(causal, window,
                                                     q_offset):
    q, k, v = _np(2, 13, 4, 64, seed=9), _np(2, 17, 2, 64, seed=10), \
        _np(2, 17, 2, 64, seed=11)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = JL.dot_attention(q, k, v, **kw)
    close(TL.dot_attention(exact(q), exact(k), exact(v), **kw), want,
          LAYER_TOL, LAYER_TOL)
    # kv_chunk 4 leaves a ragged last chunk (17 = 4 * 4 + 1)
    got = TL.blockwise_attention(exact(q), exact(k), exact(v), kv_chunk=4,
                                 **kw)
    close(got, JL.blockwise_attention(q, k, v, kv_chunk=4, **kw),
          LAYER_TOL, LAYER_TOL)
    close(got, want, LAYER_TOL, LAYER_TOL)


@pytest.mark.parametrize("arch", ["gemma3-27b", "yi-34b"])
@pytest.mark.parametrize("window", [JL.NO_WINDOW, 6])
def test_attention_matches_reference(arch, window):
    """Projections, qk-norm (gemma3), rope and the causal attention with
    no cache, on layer 0 of the smoke model."""
    jcfg, tcfg, jp, tp = dense_model(arch)
    x = _np(2, 11, jcfg.d_model, seed=12)
    pos = np.arange(11)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    tattn = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    want, _ = JL.attention(jattn, jcfg, x, positions=jnp.asarray(pos),
                           window=window)
    got, cache = TL.attention(tattn, tcfg, exact(x),
                              positions=torch.from_numpy(pos), window=window)
    assert cache is None
    close(got, want, LAYER_TOL, LAYER_TOL)


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = dense_model(arch)
    jb, tb = token_batch(jcfg, 2, 40, seed=1)       # > gemma3-smoke's window
    want, _ = JZ.forward(jp, jcfg, jb)
    got, aux = TZ.forward(tp, tcfg, tb)
    assert tuple(got.shape) == (2, 40 + jcfg.frontend_positions, jcfg.vocab)
    assert float(aux) == 0.0
    close(got, want, LOGIT_TOL, LOGIT_TOL)


def test_non_dense_families_are_not_ported():
    moe = dataclasses.replace(TCFG.get_smoke("gemma3-27b"), arch_type="moe")
    for fn in (TZ.templates, lambda c: TZ.forward({}, c, {})):
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            fn(moe)


def test_forward_in_bf16_stays_near_reference():
    """gemma3-smoke with the reference's bfloat16 weights: the logits agree
    within bf16 rounding. The two frameworks round matmul outputs and
    intermediates to bfloat16 at different places, so the bar is 4 bf16
    ulps of the logits' scale, not the float32 one."""
    jcfg, tcfg, jp, tp = dense_model("gemma3-27b", dtype="bfloat16")
    jb, tb = token_batch(jcfg, 2, 12, seed=2)
    want = np.asarray(JZ.forward(jp, jcfg, jb)[0], np.float32)
    got = n(TZ.forward(tp, tcfg, tb)[0].float())
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * scale / 128)
