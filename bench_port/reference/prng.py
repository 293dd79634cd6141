"""JAX's threefry2x32 normal draw in float32 numpy, frozen for the reference.

A copy of the float32 path of `cape_tpu_torch/core/prng.py` as it stood
when the benchmark was written (PRNGKey, threefry2x32, the 32-bit uniform
and XLA's float32 erf_inv polynomial, normal_folded). The reference derives
each train step's reparameterization noise here, so it takes nothing the
program drew: the program's step s draws normal(fold_in(PRNGKey(seed), s),
(batch, nz)) in float32.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 (20 rounds) of the count pairs (x1, x2) under `key`
    ([2], or [..., 2] broadcast against the counts)."""
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
    """jax.random.PRNGKey(seed): the seed's high and low 32-bit words."""
    seed = int(seed)
    if seed < 0:
        seed &= (1 << 64) - 1
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def _uniform_from_bits(bits: np.ndarray, minval, maxval) -> np.ndarray:
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (bits >> _U32(9)) | _U32(0x3F800000)
    floats = (bits.view(np.float32) - np.float32(1.0)).astype(np.float64)
    return np.maximum(lo, (floats * np.float64(hi - lo) + np.float64(lo)).astype(np.float32))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    return (p * x).astype(np.float32)


def normal_folded(key: np.ndarray, data, shape) -> np.ndarray:
    """float32 normal(fold_in(key, d), shape) for each d of `data`,
    stacked [len(data), *shape]."""
    shape = tuple(shape)
    data = (np.asarray(data, np.int64).ravel() & 0xFFFFFFFF).astype(_U32)
    k1, k2 = threefry2x32(key, np.zeros(len(data), _U32), data)
    keys = np.stack([k1, k2], axis=-1).reshape((len(data),) + (1,) * len(shape) + (2,))
    hi, lo = _iota_2x32(shape)
    b1, b2 = threefry2x32(keys, hi[None], lo[None])
    u = _uniform_from_bits(b1 ^ b2, np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).astype(np.float32)


def step_noise(seed: int, steps, batch: int, nz: int) -> np.ndarray:
    """The train steps' noise [len(steps), batch, nz]."""
    return normal_folded(PRNGKey(seed), np.asarray(list(steps)), (batch, nz))
