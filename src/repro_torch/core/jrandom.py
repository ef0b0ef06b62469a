"""``jax.random``'s default bits in numpy: the threefry2x32 key, ``split``,
``fold_in``, the 32-bit random bits, ``uniform``, ``normal`` and
``randint``, so the port draws the reference's starting points (the DLRM
weights, the least-squares data, Fig 2's sample indices, the LM token
stream) without importing ``jax``.

It follows the *partitionable* derivation (``jax_threefry_partitionable``,
the default since jax 0.5): the bits and the split of a key hash a 64-bit
iota over the output's shape, split into its high and low 32-bit words,
and 32-bit bits are the two hash words XORed. ``normal`` is the
reference's ``√2 · erf_inv(u)`` with u uniform on ``(nextafter(−1, 0),
1)``, and ``erf_inv`` is XLA's f32 polynomial (Giles), its Horner steps fused
multiply-adds as XLA:CPU contracts them (ROADMAP C8). Keys, bits,
``uniform`` and ``randint`` equal ``jax.random``'s bitwise; ``normal``
differs on about 1% of elements by at most a few ulps: XLA:CPU's f32
``log1p`` is not correctly rounded, and this one is (ROADMAP C20;
tests/test_torch_jrandom.py states the bound).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["PRNGKey", "threefry2x32", "split", "fold_in", "bits", "uniform", "normal",
           "randint", "erf_inv"]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the word pairs ``(x0, x1)``
    under ``key`` (two uint32), as ``jax._src.prng`` computes it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (a raw (2,) uint32 key) for a
    non-negative seed below 2**32."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return np.array([0, seed], np.uint32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota over ``shape`` as its high and low 32-bit words."""
    n = math.prod(shape)
    it = np.arange(n, dtype=np.uint64).reshape(shape)
    return (it >> np.uint64(32)).astype(np.uint32), (it & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    hi, lo = _iota_2x32((num,))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the pair (0, data)."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` at 32 bits: uint32 of ``shape``."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota_2x32(shape)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to [minval, maxval), clamped below
    at minval."""
    lo, hi = np.float32(minval), np.float32(maxval)
    fb = (bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = fb.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, f * (hi - lo) + lo).astype(np.float32)


# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"):
# coefficients for w < 5 and for w >= 5, highest degree first
_ERF_INV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                         0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                         1.50140941], np.float32)
_ERF_INV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                         0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                         2.83297682], np.float32)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """f32 ``a·b + c`` with one rounding of the exact product's sum (the
    product of two f32 values is exact in f64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv``: ``w = −log1p(−x²)`` (rounded once from f64),
    a degree-8 polynomial in ``w − 2.5`` (w < 5) or ``√w − 3`` by fused
    Horner steps, times x; ±inf at ±1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
        lt = w < np.float32(5)
        t = np.where(lt, w + np.float32(-2.5), np.sqrt(w) + np.float32(-3)).astype(np.float32)
        p = np.where(lt, _ERF_INV_LT5[0], _ERF_INV_GE5[0]).astype(np.float32)
        for c_lt, c_ge in zip(_ERF_INV_LT5[1:], _ERF_INV_GE5[1:]):
            p = _fma32(p, t, np.where(lt, c_lt, c_ge).astype(np.float32))
        out = (p * x).astype(np.float32)
        return np.where(np.abs(x) == np.float32(1), x * np.float32(np.inf), out)


_SQRT2 = np.float32(np.sqrt(2))


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: ``√2 · erf_inv(u)``, u uniform on
    ``(nextafter(−1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)
    return (_SQRT2 * erf_inv(uniform(key, shape, lo, np.float32(1)))).astype(np.float32)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` to int32: two 32-bit words per value (the
    split key's), reduced modulo the span as ``jax.random`` reduces them
    (uint32 arithmetic, wrapping)."""
    k1, k2 = split(key)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = np.uint32(max(int(maxval) - int(minval), 1) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = np.uint32(mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
