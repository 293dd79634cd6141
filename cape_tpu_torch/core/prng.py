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
  normal(key, shape, dtype)           # sqrt(2) * erfinv(u), in float32, bfloat16 or float16
  normal_folded(key, data, shape, dtype)  # normal(fold_in(key, d), shape) for each d
  truncated_normal(key, lo, hi, shape)    # float32, as jax.random.truncated_normal
  categorical(key, logits, shape)     # int32, gumbel argmax

`normal` evaluates XLA's float32 `erf_inv` polynomial (Giles' single
precision approximation) in float32 numpy, each Horner step rounded once
as XLA's fused multiply-add rounds it; `log1p` comes from another math
library, so a float32 normal draw agrees to within a few float32 ulps
(under 1e-6 absolute), not bit for bit. In bfloat16 and float16 JAX draws
other bits than in float32 (`jax._src.random._uniform` takes 8 random bits
for bfloat16 and 16 for float16, from the low bits of the 32-bit draw)
and rounds to the dtype after each operation; `normal` does the same, so
a 16-bit draw is JAX's bit for bit (the float32 erf_inv's few ulps vanish
in the rounding to 16 bits). numpy has no bfloat16, so a 16-bit draw comes
back as float32 holding the dtype's values exactly: `torch.from_numpy(a)
.to(dtype)` is JAX's array. `categorical` takes its gumbel noise in float32
the same way, so the argmax agrees unless two components tie within an
ulp.
"""

from __future__ import annotations

import math

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


# the 16-bit dtypes: (mantissa bits, random bits jax draws, the bit pattern of 1.0)
_HALF = {"bfloat16": (7, 8, 0x3F80), "float16": (10, 16, 0x3C00)}


def dtype_name(dtype) -> str:
    """"float32", "bfloat16" or "float16" from a name or a torch or numpy
    dtype."""
    name = str(dtype).removeprefix("torch.")
    if name not in ("float32", "bfloat16", "float16"):
        raise ValueError(f"dtype {dtype!r}: float32, bfloat16 or float16")
    return name


def _round_to(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 `x` rounded to nearest even in `dtype` ("bfloat16" or
    "float16"), as float32."""
    x = np.asarray(x, np.float32)
    if dtype == "float16":
        return x.astype(np.float16).astype(np.float32)
    u = x.view(_U32)
    with np.errstate(over="ignore"):
        u = (u + _U32(0x7FFF) + ((u >> _U32(16)) & _U32(1))) & _U32(0xFFFF0000)
    return u.view(np.float32)


def _half_from_bits(h: np.ndarray, dtype: str) -> np.ndarray:
    """16-bit patterns (in uint32) of `dtype` as float32."""
    if dtype == "float16":
        return h.astype(np.uint16).view(np.float16).astype(np.float32)
    return (h << _U32(16)).view(np.float32)


def _normal_from_bits(bits: np.ndarray, dtype: str = "float32") -> np.ndarray:
    if dtype == "float32":
        u = _uniform_from_bits(bits, np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)
        return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
    # jax._src.random._uniform and _normal_real in a 16-bit dtype, each
    # operation rounded to the dtype
    nmant, rng_bits, one = _HALF[dtype]
    r = lambda v: _round_to(v, dtype)
    b = bits & _U32((1 << rng_bits) - 1)
    floats = _half_from_bits((b >> _U32(rng_bits - nmant)) | _U32(one), dtype) - np.float32(1.0)
    lo = np.float32(-1.0 + 2.0 ** -(nmant + 1))   # nextafter(-1, 0) in the dtype
    u = np.maximum(lo, r(r(floats * r(np.float32(1.0) - lo)) + lo))
    return r(r(np.float32(np.sqrt(2))) * r(erfinv_f32(u)))


def normal(key: np.ndarray, shape, dtype="float32") -> np.ndarray:
    """jax.random.normal(key, shape, dtype): sqrt(2) * erfinv(u), u uniform
    on (nextafter(-1, 0), 1) in `dtype` (float32, bfloat16 or float16; a
    16-bit draw comes back as float32 holding its values exactly)."""
    return _normal_from_bits(random_bits(key, shape), dtype_name(dtype))


def normal_folded(key: np.ndarray, data, shape, dtype="float32") -> np.ndarray:
    """normal(fold_in(key, d), shape, dtype) for each d of `data` [n],
    stacked [n, *shape] in one vectorised draw (JAX's vmap of fold_in and
    normal over `data`)."""
    shape = tuple(shape)
    data = (np.asarray(data, np.int64).ravel() & 0xFFFFFFFF).astype(_U32)
    k1, k2 = threefry2x32(key, np.zeros(len(data), _U32), data)   # fold_in per d
    keys = np.stack([k1, k2], axis=-1).reshape((len(data),) + (1,) * len(shape) + (2,))
    hi, lo = _iota_2x32(shape)
    b1, b2 = threefry2x32(keys, hi[None], lo[None])
    return _normal_from_bits(b1 ^ b2, dtype_name(dtype))


def truncated_normal(key: np.ndarray, lower: float, upper: float, shape) -> np.ndarray:
    """jax.random.truncated_normal(key, lower, upper, shape) in float32:
    sqrt(2) * erfinv(u), u uniform on (erf(lower / sqrt 2), erf(upper /
    sqrt 2)), clipped inside (lower, upper). The two erf bounds are
    math.erf's rounded to float32 (JAX's lax.erf for the bounds +-2 the
    initializers use); erf_inv is within a few float32 ulps of XLA's, as
    `normal`'s."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = (np.float32(math.erf(float(v / sqrt2))) for v in (lo, hi))
    out = (sqrt2 * erfinv_f32(uniform(key, shape, a, b))).astype(np.float32)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf))).astype(np.float32)


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


def normal_rows(seed: int, n: int, dim: int, dtype="float32") -> np.ndarray:
    """Row-keyed N(0, 1) draws [n, dim] in `dtype`: row i from
    normal(fold_in(PRNGKey(seed), i), (dim,), dtype), the JAX engine's
    sampler. A row's draw depends only on (seed, i), not on how the rows
    are batched."""
    return normal_folded(PRNGKey(seed), np.arange(n), (dim,), dtype)
