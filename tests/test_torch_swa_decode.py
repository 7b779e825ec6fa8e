"""K8, the one-token flash-decode attention, on the CPU: its plain PyTorch
version against the reference's Pallas kernel in interpret mode and its
`swa_decode_ref`, on the same numpy inputs; the mapping of the engine's
decode attention onto K8 (contiguous cache and ring buffer) against the
reference's `decode_attention`; the kernel's edge cases (one slot, a
window of one, rep 1, 7 and 12); the host-side launch plan (the window
covered once, one wave of the card); and the CUDA wrapper's refusal of
what its kernel does not take. The CUDA kernel
itself is held to this plain version on the card by chip_smoke.py.

Tolerances: float32 2e-5 (the reference's own bar between its kernel and
its ref, tests/test_kernels.py: softmax sums in another order); bfloat16
3e-2 (the reference's bar: the output is rounded to bfloat16, whose ulp
is 2^-7 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro.models import layers as JL
from repro_torch.kernels import ops as TK
from repro_torch.kernels.swa_decode import kernel as swa_kernel
from repro_torch.kernels.swa_decode.ref import swa_decode_ref
from repro_torch.models import layers as TL
from torch_parity import exact, n

F32_TOL, BF16_TOL = 2e-5, 3e-2


def _case(b, h, hkv, hd, s, dtype, seed):
    """q (B, H, hd), k, v (B, S, Hkv, hd) drawn with numpy, as JAX arrays
    of `dtype`."""
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype)
                 for shape in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


def _close(got, want, dtype):
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(n(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


_SLOW = pytest.mark.slow     # the grid's larger cases, as the reference's


@pytest.mark.parametrize("b,h,hkv,hd", [
    (1, 4, 4, 64),
    pytest.param(2, 8, 2, 64, marks=_SLOW),
    pytest.param(3, 8, 1, 128, marks=_SLOW),
    pytest.param(2, 16, 16, 128, marks=_SLOW)])
@pytest.mark.parametrize("s,cache_len,window", [
    (1024, 1000, JK.NO_WINDOW),
    pytest.param(1024, 511, 256, marks=_SLOW),
    pytest.param(2048, 2047, 1024, marks=_SLOW),
    pytest.param(512, 0, JK.NO_WINDOW, marks=_SLOW)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_matches_reference_kernel_and_ref(b, h, hkv, hd, s, cache_len,
                                                window, dtype):
    q, k, v = _case(b, h, hkv, hd, s, dtype, seed=b * 7 + s + cache_len)
    got = TK.swa_decode(exact(q), exact(k), exact(v), cache_len,
                        window=window)
    assert got.dtype == exact(q).dtype and tuple(got.shape) == (b, h, hd)
    _close(got, JK.swa_decode(q, k, v, cache_len, window=window,
                              interpret=True), dtype)
    _close(got, JK.swa_decode_ref(q, k, v, cache_len, window), dtype)


@pytest.mark.parametrize("h,hkv", [
    pytest.param(4, 4, marks=_SLOW, id="rep1"), pytest.param(8, 4, id="rep2"),
    pytest.param(14, 2, marks=_SLOW, id="rep7")])
@pytest.mark.parametrize("s,cache_len,window", [
    (700, 0, JK.NO_WINDOW), (700, 511, JK.NO_WINDOW), (700, 512, 100),
    (700, 699, 513), (1000, 999, 1)])
def test_rep_and_block_edges(h, hkv, s, cache_len, window):
    """General rep, S not a multiple of the reference's 512-block, and
    cache_len at 0, at a block edge and at S - 1; window 1 keeps one
    position."""
    q, k, v = _case(2, h, hkv, 128, s, jnp.float32, seed=h + s + cache_len)
    got = TK.swa_decode(exact(q), exact(k), exact(v), cache_len,
                        window=window)
    _close(got, JK.swa_decode_ref(q, k, v, cache_len, window), jnp.float32)
    _close(got, JK.swa_decode(q, k, v, cache_len, window=window,
                              interpret=True), jnp.float32)


@pytest.mark.parametrize("b,h,hkv,s,cache_len,window", [
    pytest.param(1, 4, 4, 1, 0, JK.NO_WINDOW, id="b1_s1"),
    pytest.param(2, 8, 2, 300, 250, 1, id="window1"),
    pytest.param(2, 4, 4, 300, 299, JK.NO_WINDOW, id="rep1"),
    pytest.param(1, 14, 2, 300, 123, 64, id="rep7"),
    pytest.param(1, 12, 1, 300, 299, JK.NO_WINDOW, id="rep12")])
def test_kernel_edges(b, h, hkv, s, cache_len, window):
    """The edges the CUDA kernel's plan and head groups meet (one slot, a
    window of one position, rep 1 in the group-2 instance, rep 7 in the
    group-8 one, rep 12 in two groups of 8) against the reference's kernel
    and ref."""
    q, k, v = _case(b, h, hkv, 64, s, jnp.float32, seed=h + s + cache_len)
    got = TK.swa_decode(exact(q), exact(k), exact(v), cache_len,
                        window=window)
    _close(got, JK.swa_decode_ref(q, k, v, cache_len, window), jnp.float32)
    _close(got, JK.swa_decode(q, k, v, cache_len, window=window,
                              interpret=True), jnp.float32)
    p = swa_kernel.plan(b, s, h, hkv, cache_len, window, n_sm=132,
                        blocks_per_sm=3, tile=64)
    assert p["hi"] - p["lo"] == min(cache_len + 1, window)


def test_window_excludes_old_positions():
    """With window=W, changing K/V outside the window (and beyond
    cache_len) must not change the output."""
    q, k, v = (exact(a) for a in _case(1, 4, 4, 64, 1024, jnp.float32, 9))
    cache_len, w = 900, 128
    out1 = TK.swa_decode(q, k, v, cache_len, window=w)
    k2, v2 = k.clone(), v.clone()
    k2[:, :cache_len - w + 1] = 99.0
    v2[:, :cache_len - w + 1] = -99.0
    k2[:, cache_len + 1:] = 77.0
    v2[:, cache_len + 1:] = -77.0
    out2 = TK.swa_decode(q, k2, v2, cache_len, window=w)
    np.testing.assert_allclose(n(out1), n(out2), atol=1e-6)


# ---------------------------------------------------------------------------
# The engine's decode attention mapped onto K8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [0, 37, 511, 1023])
@pytest.mark.parametrize("window", [JK.NO_WINDOW, 256])
def test_contiguous_decode_maps_onto_k8(cache_len, window):
    """Slots past cache_len hold junk: the reference masks them with
    valid_len = cache_len + 1, K8 with pos <= cache_len."""
    q, k, v = _case(2, 8, 2, 64, 1024, jnp.float32, seed=cache_len)
    q = q[:, None]
    want = JL.decode_attention(q, k, v, q_offset=cache_len, window=window,
                               valid_len=cache_len + 1)
    got = TL.decode_attention(exact(q), exact(k), exact(v),
                              q_offset=cache_len, window=window)
    _close(got, want, jnp.float32)


@pytest.mark.parametrize("cache_len", [0, 5, 30, 31, 32, 33, 100, 1000],
                         ids=lambda c: f"len{c}")
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 8)])
def test_ring_decode_maps_onto_k8(cache_len, h, hkv):
    """A ring of W = 32 slots after the token at position cache_len was
    written at slot cache_len % W: the reference attends with the slots'
    positions (ring_slot_positions, -1 for never-written slots, which hold
    junk here); the port runs K8 with no window and cache_len
    min(cache_len, W - 1). Covers cache_len < W - 1, = W - 1, = W and >> W."""
    w = 32
    q, k, v = _case(2, h, hkv, 64, w, jnp.float32, seed=cache_len + h)
    q = q[:, None]
    kpos = JL.ring_slot_positions(cache_len + 1, w)
    want = JL.decode_attention(q, k, v, q_offset=cache_len, window=w,
                               k_pos=kpos)
    got = TL.decode_attention(exact(q), exact(k), exact(v),
                              q_offset=cache_len, window=w, ring=True)
    _close(got, want, jnp.float32)
    np.testing.assert_array_equal(
        n(TL.ring_slot_positions(cache_len + 1, w)), np.asarray(kpos))


@pytest.mark.parametrize("case", ["several_tokens", "ring_narrower"])
def test_decode_attention_refusals(case):
    """decode_attention takes one query token (decode_step never passes
    more), and a ring only with a window that covers it."""
    rng = np.random.default_rng(3)
    sq, w = (3, 48) if case == "several_tokens" else (1, 47)
    q = torch.from_numpy(rng.normal(size=(2, sq, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 48, 2, 64)).astype(np.float32))
    match = "one token" if case == "several_tokens" else "needs window"
    for ring in (False, True) if case == "several_tokens" else (True,):
        with pytest.raises(ValueError, match=match):
            TL.decode_attention(q, k, k, q_offset=40, window=w, ring=ring)


# ---------------------------------------------------------------------------
# The CUDA wrapper's launch plan and refusals (host side only)
# ---------------------------------------------------------------------------

_PLAN_CASES = [
    (4, 4096, 32, 16, 4095, JK.NO_WINDOW), (4, 1024, 32, 16, 1023,
                                            JK.NO_WINDOW),
    (1, 131072, 32, 16, 131071, JK.NO_WINDOW), (1, 4096, 32, 16, 4000, 1024),
    (2, 700, 24, 2, 0, JK.NO_WINDOW), (1, 64, 12, 1, 63, 1),
    (1, 1, 4, 4, 0, JK.NO_WINDOW), (2, 1037, 14, 2, 1036, 100)]


@pytest.mark.parametrize("blocks_per_sm,tile", [(3, 32), (1, 16), (2, 64)])
@pytest.mark.parametrize("b,s,h,hkv,cache_len,window", _PLAN_CASES)
def test_launch_plan_covers_the_window_once(b, s, h, hkv, cache_len,
                                            window, blocks_per_sm, tile):
    p = swa_kernel.plan(b, s, h, hkv, cache_len, window, n_sm=132,
                        blocks_per_sm=blocks_per_sm, tile=tile)
    assert p["lo"] == max(0, cache_len - window + 1)
    assert p["hi"] == cache_len + 1
    starts = [p["lo"] + i * p["split_len"] for i in range(p["n_split"])]
    assert all(st < p["hi"] for st in starts)          # no empty split
    assert starts[-1] + p["split_len"] >= p["hi"]       # the last reaches hi
    assert p["split_len"] % tile == 0                   # whole stages
    assert p["group"] >= min(h // hkv, swa_kernel.MAX_HEAD_GROUP)
    assert p == swa_kernel.plan(b, s, h, hkv, cache_len, window, n_sm=132,
                                blocks_per_sm=blocks_per_sm, tile=tile)


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
@pytest.mark.parametrize("b,s,h,hkv", [
    (4, 4096, 32, 16), (4, 1024, 32, 16), (1, 131072, 32, 16),
    (2, 8192, 24, 2)])
def test_launch_plan_fills_one_wave(b, s, h, hkv, blocks_per_sm):
    """Where the window is long enough, the grid is one wave of the card
    (SMs x the instance's blocks per SM), and splits one stage shorter
    would overflow it."""
    n_sm, tile = 132, 32
    p = swa_kernel.plan(b, s, h, hkv, s - 1, JK.NO_WINDOW, n_sm=n_sm,
                        blocks_per_sm=blocks_per_sm, tile=tile)
    slots = n_sm * blocks_per_sm
    assert p["blocks"] == p["units"] * p["n_split"] <= slots
    assert p["waves"] == 1
    shorter = -(-s // (p["split_len"] - tile))
    assert shorter * p["units"] > slots
    assert p["blocks_per_sm"] == blocks_per_sm


def test_launch_plan_keeps_splits_worth_a_block():
    """A short window is not cut below MIN_SPLIT positions a split, and one
    unit per block slot or more leaves one split."""
    p = swa_kernel.plan(1, 4096, 32, 16, 4000, 100, n_sm=132,
                        blocks_per_sm=3, tile=32)
    assert p["n_split"] == 2 and p["split_len"] == 64
    p = swa_kernel.plan(64, 4096, 32, 16, 4095, JK.NO_WINDOW, n_sm=132,
                        blocks_per_sm=3, tile=32)
    assert p["n_split"] == 1 and p["waves"] == 3


def test_head_groups():
    assert [swa_kernel.head_group(r) for r in (1, 2, 3, 4, 7, 12)] \
        == [2, 2, 4, 4, 8, 8]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (exact(a) for a in _case(1, 4, 2, 64, 16, jnp.float32, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa_kernel.swa_decode(q, k, v, 3)
    with pytest.raises(ValueError, match="head dim"):
        swa_kernel.check_args("swa_decode", q[..., :32], k[..., :32],
                              v[..., :32], 3, TK.NO_WINDOW)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        swa_kernel.check_args("swa_decode", q[:, :3], k, v, 3, TK.NO_WINDOW)
    with pytest.raises(ValueError, match="outside the cache"):
        swa_kernel.check_args("swa_decode", q, k, v, 16, TK.NO_WINDOW)
    with pytest.raises(TypeError, match="share one dtype"):
        swa_kernel.check_args("swa_decode", q, k.bfloat16(), v, 3,
                              TK.NO_WINDOW)
    with pytest.raises(ValueError, match="rank-mismatched"):
        TK.swa_decode(q[:, None], k, v, 3)


def test_plain_version_is_the_reference_formula():
    """swa_decode_ref on the CPU is what ops.swa_decode runs there."""
    q, k, v = (exact(a) for a in _case(2, 8, 2, 64, 100, jnp.bfloat16, 1))
    assert torch.equal(TK.swa_decode(q, k, v, 50, window=20),
                       swa_decode_ref(q, k, v, 50, 20))
