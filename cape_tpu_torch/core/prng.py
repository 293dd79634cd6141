"""JAX's default PRNG in numpy: keys, splits and the draws the port needs.

The JAX package draws its sampled latents, its GMM components and its
GMM noise from `jax.random` (threefry2x32, `jax_threefry_partitionable`
on, JAX's default). This module computes the same bits on the host, so a
seed gives the port the same draw:

  key = PRNGKey(seed)                 # uint32 [2]
  key = fold_in(key, i)               # uint32 [2]
  k1, k2 = split(key)                 # uint32 [2, 2]
  random_bits(key, shape)             # uint32, bit-equal to jax.random.bits
  uniform(key, shape, lo, hi)         # float32, bit-equal to jax.random.uniform
  normal(key, shape)                  # float32, sqrt(2) * erfinv(u)
  categorical(key, logits, shape)     # int32, gumbel argmax

`normal` evaluates XLA's float32 `erf_inv` polynomial (Giles' single
precision approximation) in float32 numpy, each Horner step rounded once
as XLA's fused multiply-add rounds it; `log1p` comes from another math
library, so a normal draw agrees to within a few float32 ulps (under
1e-6 absolute), not bit for bit. `categorical` takes its gumbel noise in float32
the same way, so the argmax agrees unless two components tie within an
ulp.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2)
    under `key` ([2], or [..., 2] broadcast against the counts), as
    `jax._src.prng._threefry2x32_lowering` computes it."""
    key = np.asarray(key, _U32)
    k1, k2 = key[..., 0], key[..., 1]
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for an integer seed: the seed's high and
    low 32-bit words (a seed below 2**32 has a high word of 0)."""
    seed = int(seed)
    if seed < 0:
        seed &= (1 << 64) - 1
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data): the hash of the pair (0, data)."""
    o1, o2 = threefry2x32(key, np.zeros(1, _U32), np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([o1[0], o2[0]], _U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) -> uint32 [num, 2]."""
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(key, hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.bits(key, shape) (32-bit): uint32 of `shape`."""
    shape = tuple(shape)
    hi, lo = _iota_2x32(shape)
    b1, b2 = threefry2x32(key, hi, lo)
    return b1 ^ b2


def _uniform_from_bits(bits: np.ndarray, minval, maxval) -> np.ndarray:
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (bits >> _U32(9)) | _U32(0x3F800000)
    floats = (bits.view(np.float32) - np.float32(1.0)).astype(np.float64)
    # floats * (hi - lo) + lo rounded once, as XLA's fused multiply-add
    return np.maximum(lo, (floats * np.float64(hi - lo) + np.float64(lo)).astype(np.float32))


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform in float32: 23 random mantissa bits under an
    exponent of 0 give [1, 2); minus 1, scaled, shifted, clamped below."""
    return _uniform_from_bits(random_bits(key, shape), minval, maxval)


# XLA's float32 erf_inv: Giles, "Approximating the erfinv function" (2010)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """Inverse error function in float32 arithmetic, XLA's polynomial, for
    |x| < 1 (the open interval `normal` draws from)."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # c + p * w rounded once, as a fused multiply-add (exact in float64)
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    return (p * x).astype(np.float32)


def _normal_from_bits(bits: np.ndarray) -> np.ndarray:
    u = _uniform_from_bits(bits, np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.normal in float32: sqrt(2) * erfinv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    return _normal_from_bits(random_bits(key, shape))


def gumbel(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.gumbel (mode "low") in float32."""
    tiny = np.finfo(np.float32).tiny
    return (-np.log(-np.log(uniform(key, shape, tiny, 1.0)))).astype(np.float32)


def categorical(key: np.ndarray, logits: np.ndarray, shape=None) -> np.ndarray:
    """jax.random.categorical over the last axis of `logits` [..., M]: the
    argmax of logits plus gumbel noise of shape (*shape, M)."""
    logits = np.asarray(logits, np.float32)
    batch = logits.shape[:-1]
    shape = batch if shape is None else tuple(shape)
    g = gumbel(key, shape + logits.shape[-1:])
    return np.argmax(g + logits, axis=-1).astype(np.int32)


def normal_rows(seed: int, n: int, dim: int) -> np.ndarray:
    """Row-keyed N(0, 1) draws [n, dim]: row i from
    normal(fold_in(PRNGKey(seed), i)), the JAX engine's sampler. A row's
    draw depends only on (seed, i), not on how the rows are batched."""
    rows = np.arange(n, dtype=np.uint64).astype(_U32)
    k1, k2 = threefry2x32(PRNGKey(seed), np.zeros(n, _U32), rows)  # fold_in per row
    hi, lo = _iota_2x32((dim,))
    b1, b2 = threefry2x32(np.stack([k1, k2], -1)[:, None], hi[None], lo[None])
    return _normal_from_bits(b1 ^ b2).reshape(n, dim)
