"""JAX's default random numbers in numpy: threefry2x32 keys, ``split``,
float32 ``uniform`` and ``normal``.

The JAX package draws the random-conv embedder's weights from
``jax.random.PRNGKey(20260816)`` (``eval/embeddings.py:87-96``). The port
has no JAX, so it draws the same arrays here, bit for bit in the bits and
to float32 rounding in the floats, with JAX's defaults:

- a key is two uint32 words, ``PRNGKey(seed)`` is ``[0, seed &
  0xFFFFFFFF]`` (64-bit types off);
- ``jax_threefry_partitionable`` on (the default since JAX 0.5): element
  ``i`` of a shape (row-major, as a 64-bit counter split into high and
  low words) is ``threefry2x32(key, (hi, lo))``; ``split`` keeps both
  output words as the new key, 32-bit random bits are their xor;
- ``uniform`` puts the bits' top 23 into a float in [1, 2), takes 1 away,
  scales to ``[minval, maxval)`` (a fused multiply-add) and clamps below
  at ``minval``;
- ``normal`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform in
  ``(nextafter(-1, 0), 1)`` and XLA's single-precision ``erf_inv``
  (M. Giles' polynomial, "Approximating the erfinv function", its steps
  fused multiply-adds). XLA's float32 ``log1p`` is its own polynomial, not
  numpy's correctly rounded one, so about 1.3% of the normals differ from
  JAX's by one float32 ulp (at most 4.8e-7 absolute in the embedder's
  draws).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block cipher of ``key`` (two uint32) over
    the counter words ``x0``, ``x1`` (uint32 arrays of one shape)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(_U32) + ks[0]
        x1 = x1.astype(_U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default):
    the seed's low 32 bits, under a zero high word."""
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` uint32."""
    return np.stack(threefry2x32(key, *_counters(num)), axis=-1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32-bit random bits of ``shape``, as ``jax.random.bits``."""
    x0, x1 = threefry2x32(key, *_counters(int(np.prod(shape))))
    return (x0 ^ x1).reshape(shape)


def uniform(key: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    minval, maxval = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    # floats * (maxval - minval) + minval as one fused multiply-add, as XLA's
    # CPU code computes it
    scaled = (floats.astype(np.float64) * (maxval - minval) + minval).astype(np.float32)
    return np.maximum(minval, scaled)


# XLA's single-precision erf_inv: polynomials in w = -log1p(-x^2), one for
# w < 5 (in w - 2.5) and one for w >= 5 (in sqrt(w) - 3).
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                          1.50140941], np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                          2.83297682], np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 ``lax.erf_inv``, evaluated in float32 as XLA does."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):
        w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for i in range(1, len(_ERFINV_SMALL)):
        # a fused multiply-add, as XLA's CPU code evaluates it: the float32
        # product is exact in float64, so one rounding to float32 remains
        c = np.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i])
        p = (c.astype(np.float64) + p.astype(np.float64) * w).astype(np.float32)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), p * x)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * erf_inv(u)
