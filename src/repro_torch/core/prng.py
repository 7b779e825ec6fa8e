"""The reference's seeded draws, replayed in numpy.

The reference starts a fit from `C.init_params(cfg, jax.random.PRNGKey(
seed))`: `split(key, 3)`, then `scale * normal` for `w_x` and `w_q`. This
module computes the same numbers without JAX, so a seed alone gives both
packages the same initial weights:

  * `prng_key(seed)` — the uint32 pair of the default threefry key;
  * `split(key, n)` and `random_bits(key, shape)` — Threefry-2x32 (20
    rounds) over the "partitionable" counters (the flat element index as
    a (hi, lo) uint32 pair; 32-bit draws are the two output words XORed),
    the layout `jax.random` uses when `jax_threefry_partitionable` is on,
    its default since JAX 0.5;
  * `normal(key, shape)` — uniform floats in (-1, 1) from the top 23 bits,
    then sqrt(2) * erfinv, with XLA's float32 erfinv (Giles'
    single-precision polynomial) evaluated step by step in float32.

Integer and uniform draws are bit-exact. `normal` is within 3 float32
ulp of `jax.random.normal` (measured over seeds 0..19 and 2,000 draws
each; most draws are equal): the erfinv polynomial is XLA's, but its first
step, log1p, is numpy's here and XLA's own approximation there, and the
two differ by up to 2 ulp (tests/test_torch_paper.py holds the bound)."""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
# coefficients of the two branches, highest degree first.
_ERFINV_SMALL = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941], np.float32)
_ERFINV_LARGE = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682], np.float32)


def prng_key(seed: int) -> np.ndarray:
    """The uint32 pair `jax.random.PRNGKey(seed)` gives for an int32 seed
    (the default threefry key, 64-bit mode off)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the uint32 counter pairs (x0, x1)
    under `key`, as `jax.random`'s threefry2x32 primitive."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32).copy()
    x1 = np.asarray(x1, np.uint32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r) ^ x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The flat index 0..n-1 as (hi, lo) uint32 words."""
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: (n, 2) uint32 keys."""
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.bits(key, shape)` for 32-bit draws: uint32 of `shape`."""
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv, each step rounded to float32."""
    x = np.asarray(x, np.float32)
    one = np.float32(1.0)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = np.where(small, cs, cl) + p * w
    out = (p * x).astype(np.float32)
    with np.errstate(over="ignore"):
        edge = x * np.finfo(np.float32).max
    return np.where(np.abs(x) == one, edge, out).astype(np.float32)


def uniform(key: np.ndarray, shape: tuple[int, ...], minval=0.0,
            maxval=1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    one_bits = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one_bits).view(np.float32) - 1
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.normal(key, shape)` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).astype(np.float32)


def reference_init(cfg, seed: int,
                   scale: float = 0.01) -> dict[str, np.ndarray]:
    """The reference's `init_params(cfg, PRNGKey(seed), scale)` for a
    cascade config (its n_stages, d_x, d_q): float32 numpy arrays
    {"w_x" (T, d_x), "w_q" (T, d_q), "b" (T,) zeros}."""
    kx, kq, _ = split(prng_key(seed), 3)
    s = np.float32(scale)
    t = cfg.n_stages
    return {"w_x": s * normal(kx, (t, cfg.d_x)),
            "w_q": s * normal(kq, (t, cfg.d_q)),
            "b": np.zeros((t,), np.float32)}
