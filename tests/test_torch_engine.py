"""The port's serving engine on the CPU against the reference's
(src/repro/serving/engine.py): cache layouts, prefill and several greedy
decode steps for every dense smoke config, gemma3-smoke with a prompt
longer than its 32-token window (every local ring wraps) and decoding past
further wraps. Decode runs K8's plain version through the mapping of
`layers.decode_attention`. Also the port's decode against its own forward
over the extended sequence, which never runs K8.

Tolerances: logits 2e-4 (the reference's own bar between prefill and
forward, tests/test_arch_smoke.py); cache contents 1e-5 (float32
projections); greedy tokens exactly, at every step whose top-2 logit
margin exceeds the logit tolerance (both sides then must pick the same
token); decode against forward 2e-3 (the reference's bar for that check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import engine as JE
from repro_torch.models import zoo as TZ
from repro_torch.serving import engine as TE
from torch_parity import DENSE_ARCHS, close, dense_model, n, token_batch

LOGIT_TOL = 2e-4
CACHE_TOL = 1e-5
FWD_TOL = 2e-3

_decode = jax.jit(JE.decode_step, static_argnums=(1,))


def _greedy_run(arch, prompt, steps, max_len):
    """Prefill `prompt` tokens, then `steps` greedy decode steps on both
    packages, feeding both the reference's greedy token. Returns the
    per-step logit pairs and the final caches."""
    jcfg, tcfg, jp, tp = dense_model(arch)
    jb, tb = token_batch(jcfg, 2, prompt, seed=len(arch))
    jc = JE.init_cache(jcfg, 2, max_len)
    tc = TE.init_cache(tcfg, 2, max_len, device="cpu")
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    tl, tc = TE.prefill(tp, tcfg, tb, tc)
    logits = [(np.asarray(jl), n(tl))]
    pos = prompt + jcfg.frontend_positions
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(pos + step))
        tl, tc = TE.decode_step(tp, tcfg, torch.tensor(tok), tc,
                                pos + step)
        logits.append((np.asarray(jl), n(tl)))
    return logits, jc, tc


def _check_run(logits, jc, tc):
    checked = 0
    for want, got in logits:
        close(got, want, LOGIT_TOL, LOGIT_TOL)
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL
        np.testing.assert_array_equal(got[:, -1].argmax(-1)[sure],
                                      want[:, -1].argmax(-1)[sure])
        checked += int(sure.sum())
    assert checked > 0
    assert set(jc) == set(tc)
    for k in jc:
        close(tc[k], jc[k], CACHE_TOL, CACHE_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_cache_layout_matches_reference(arch):
    jcfg, tcfg, _, _ = dense_model(arch)
    want = JE.cache_shapes(jcfg, 3, 48)
    got = TE.cache_shapes(tcfg, 3, 48)
    assert {k: v.shape for k, v in want.items()} \
        == {k: s for k, (s, _) in got.items()}
    assert all(dt == torch.float32 for _, dt in got.values())
    cache = TE.init_cache(tcfg, 3, 48, device="cpu")
    assert all(not c.any() for c in cache.values())
    if arch == "gemma3-27b":
        assert set(cache) == {"gk", "gv", "lk", "lv", "tlk", "tlv"}


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    logits, jc, tc = _greedy_run(arch, prompt=20, steps=5, max_len=48)
    _check_run(logits, jc, tc)


def test_gemma_rings_wrap_in_prefill_and_decode():
    """A 40-token prompt over gemma3-smoke's 32-slot rings, then 30 decode
    steps: positions 40..69 wrap the rings again at 64."""
    logits, jc, tc = _greedy_run("gemma3-27b", prompt=40, steps=30,
                                 max_len=80)
    _check_run(logits, jc, tc)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_matches_own_forward(arch):
    """Prefill + one decode step equal the port's forward over the
    extended sequence (gemma3: a prompt past the window, so the decode
    reads wrapped rings)."""
    _, tcfg, _, tp = dense_model(arch)
    _, tb = token_batch(tcfg, 2, 36, seed=3)
    cache = TE.init_cache(tcfg, 2, 64, device="cpu")
    lg, cache = TE.prefill(tp, tcfg, tb, cache)
    full, _ = TZ.forward(tp, tcfg, tb)
    close(lg[:, 0], full[:, -1], LOGIT_TOL, LOGIT_TOL)
    tok = torch.full((2, 1), 7)
    lg2, _ = TE.decode_step(tp, tcfg, tok, cache,
                            36 + tcfg.frontend_positions)
    tb2 = dict(tb, tokens=torch.cat([tb["tokens"], tok], dim=1))
    full2, _ = TZ.forward(tp, tcfg, tb2)
    close(lg2[:, 0], full2[:, -1], FWD_TOL, FWD_TOL)


def test_decode_writes_the_cache_in_place_at_cache_len():
    _, tcfg, _, tp = dense_model("yi-34b")
    _, tb = token_batch(tcfg, 2, 16, seed=4)
    cache = TE.init_cache(tcfg, 2, 24, device="cpu")
    ptr = cache["k"].data_ptr()
    _, out = TE.prefill(tp, tcfg, tb, cache)
    assert out is cache and cache["k"].data_ptr() == ptr
    assert cache["k"][:, :, :16].any() and not cache["k"][:, :, 16:].any()
    TE.decode_step(tp, tcfg, torch.full((2, 1), 5), cache, 16)
    assert cache["k"][:, :, 16].any() and not cache["k"][:, :, 17:].any()
    with pytest.raises(ValueError, match="cannot take"):
        TE.decode_step(tp, tcfg, torch.full((2, 1), 5), cache, 24)


def test_cuda_default_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg, _, _ = dense_model("qwen3-8b")
    with pytest.raises((AssertionError, RuntimeError)):
        TE.init_cache(tcfg, 1, 8)          # device defaults to "cuda"
