"""The reference's random initial params, drawn without JAX.

``JaxKey`` is a ``jax.random`` threefry key (``jax.random.PRNGKey(seed)``,
two uint32 words) with JAX's partitionable ``split`` and 32-bit
``random_bits``, written with numpy's wrapping uint32 arithmetic. The
initializers (``utils/initializers.py``) take one in place of a
``torch.Generator`` and then give the values ``jax.random`` gives:
``uniform`` bit for bit, ``truncated_normal`` to an ulp (``erf_inv`` is
XLA's float32 polynomial with fused multiply-adds, its ``log1p`` numpy's),
as JAX computes them on the CPU. With a ``JaxKey``, a model's
``init_params`` splits keys in the reference's order, so
``init_params(JaxKey(2019))`` is the reference's
``init_params(jax.random.PRNGKey(2019))``: the draws behind the quality
rows of ``docs/model_zoo.md``.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, over uint32 arrays (JAX's
    ``threefry2x32_p``)."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


class JaxKey:
    """A threefry PRNG key, ``jax.random.PRNGKey(seed)`` for a seed below
    2**32."""

    def __init__(self, seed: int = 0, words=None):
        if words is None:
            if not 0 <= seed < 2**32:
                raise ValueError(f"JaxKey takes a seed in [0, 2**32), got {seed}")
            words = (0, seed)
        self.words = tuple(int(w) for w in words)

    def _threefry(self, n: int):
        # the row-major iota of the draws' shape, as (hi, lo) uint32 words
        with np.errstate(over="ignore"):
            return threefry2x32(*self.words, np.zeros(n, np.uint32),
                                np.arange(n, dtype=np.uint32))

    def split(self, n: int) -> list:
        """``jax.random.split(key, n)``."""
        b1, b2 = self._threefry(n)
        return [JaxKey(words=(b1[i], b2[i])) for i in range(n)]

    def bits(self, shape) -> np.ndarray:
        """``jax.random.bits(key, shape)`` (uint32)."""
        b1, b2 = self._threefry(math.prod(shape))
        return (b1 ^ b2).reshape(shape)


def uniform(key: JaxKey, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = ((key.bits(shape) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    floats = (floats - np.float32(1.0)).astype(np.float64)
    # floats * (hi - lo) + lo in one rounding, the fused multiply-add XLA emits
    return np.maximum(lo, (floats * np.float64(hi - lo) + np.float64(lo)).astype(np.float32))


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# a polynomial in w = -log1p(-x^2), one for w < 5 and one past it
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """``lax.erf_inv`` in float32 for |x| < 1; each Horner step is one
    rounding, as a fused multiply-add gives it."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float64)
    p = np.where(lt, _ERFINV_LT[0], _ERFINV_GT[0]).astype(np.float32)
    for c_lt, c_gt in zip(_ERFINV_LT[1:], _ERFINV_GT[1:]):
        c = np.where(lt, np.float32(c_lt), np.float32(c_gt)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    return p * x


def truncated_normal(key: JaxKey, lower, upper, shape) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32."""
    sqrt2 = np.float32(math.sqrt(2.0))
    lower, upper = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lower / sqrt2)))
    b = np.float32(math.erf(float(upper / sqrt2)))
    u = uniform(key, shape, a, b)
    out = sqrt2 * erf_inv(u)
    return np.clip(out, np.nextafter(lower, np.float32(np.inf)),
                   np.nextafter(upper, np.float32(-np.inf)))


def split_rng(rng, n: int):
    """n keys for n sub-initialisers: ``jax.random.split`` of a ``JaxKey``,
    the generator itself n times (its draws run on in call order), or n
    Nones."""
    if isinstance(rng, JaxKey):
        return rng.split(n)
    return (rng,) * n
