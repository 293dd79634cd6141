"""The port's numpy copy of JAX's default PRNG (`cape_tpu_torch.core.prng`)
against `jax.random` on the CPU: keys, fold_in and split bit for bit, the
32-bit draws and uniforms bit for bit, float32 normals within 1e-6
absolute, bfloat16 and float16 normals bit for bit (also folded over many
data values and row by row), truncated normals within one float32 ulp,
and categorical draws equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cape_tpu.apps.inference import _sample_z_rows
from cape_tpu_torch.core import prng

SEEDS = [0, 1, 7, 123, 2**31 - 1, 2**32 - 1]


def _jkey(seed):
    # seeds of 2**31 and above need an unsigned scalar in JAX's 32-bit mode
    return jax.random.PRNGKey(np.uint32(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_are_bit_equal(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(_jkey(seed)))
    for data in (0, 5, 2**31 + 3):
        np.testing.assert_array_equal(
            prng.fold_in(key, data), np.asarray(jax.random.fold_in(_jkey(seed), data)))
    for num in (2, 3, 9):
        np.testing.assert_array_equal(
            prng.split(key, num), np.asarray(jax.random.split(_jkey(seed), num)))


def test_key_of_a_64_bit_seed():
    np.testing.assert_array_equal(prng.PRNGKey(2**32 + 5), [1, 5])
    np.testing.assert_array_equal(prng.PRNGKey(-1), [0xFFFFFFFF, 0xFFFFFFFF])


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (1000,)])
@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_bits_and_uniform_are_bit_equal(seed, shape):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.random_bits(key, shape),
                                  np.asarray(jax.random.bits(_jkey(seed), shape)))
    np.testing.assert_array_equal(prng.uniform(key, shape),
                                  np.asarray(jax.random.uniform(_jkey(seed), shape)))
    np.testing.assert_array_equal(
        prng.uniform(key, shape, -2.5, 3.0),
        np.asarray(jax.random.uniform(_jkey(seed), shape, minval=-2.5, maxval=3.0)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_1e_6(seed):
    """XLA's float32 erf_inv polynomial on the same uniforms: within 1e-6
    absolute (a few float32 ulps at |x| ~ 4.5) over 10^5 draws."""
    got = prng.normal(prng.PRNGKey(seed), (100_000,))
    want = np.asarray(jax.random.normal(_jkey(seed), (100_000,)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 4.0  # the tail branch of the polynomial is reached


def test_erfinv_values():
    """Both branches of the polynomial (w = -log(1 - x^2) below and above
    5): within 1e-6 of XLA's float32 erf_inv, and within the
    approximation's 5e-6 relative of scipy's float64 erfinv."""
    from scipy.special import erfinv

    x = np.array([0.0, 0.5, -0.9, 0.99, 0.9999, -0.999999], np.float32)
    got = prng.erfinv_f32(x)
    np.testing.assert_allclose(got, np.asarray(jax.scipy.special.erfinv(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, erfinv(x.astype(np.float64)), rtol=5e-6)


@pytest.mark.parametrize("seed", [0, 3, 11, 123, 999])
def test_categorical_is_equal(seed):
    w = np.array([0.05, 0.1, 0.15, 0.2, 0.5], np.float32)
    got = prng.categorical(prng.PRNGKey(seed), np.log(w), shape=(200,))
    want = np.asarray(jax.random.categorical(_jkey(seed), jnp.log(w), shape=(200,)))
    np.testing.assert_array_equal(got, want)
    logits = np.random.default_rng(seed).standard_normal((6, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        prng.categorical(prng.PRNGKey(seed), logits),
        np.asarray(jax.random.categorical(_jkey(seed), logits)))


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_normal_rows_match_the_jax_engine_sampler(seed):
    """normal_rows is the eps of the JAX engine's `_sample_z_rows`: row i
    from fold_in(PRNGKey(seed), i), here with mu = 0 and logvar = 0."""
    zeros = np.zeros((9, 18), np.float32)
    want = np.asarray(_sample_z_rows(np.uint32(seed), np.arange(9, dtype=np.int32), zeros, zeros))
    got = prng.normal_rows(seed, 9, 18)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a row's draw does not depend on how many rows are drawn
    np.testing.assert_array_equal(prng.normal_rows(seed, 4, 18), got[:4])
    assert prng.normal_rows(seed, 0, 18).shape == (0, 18)


HALF = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("shape", [(2, 8), (64, 64), (3, 5, 7), (32, 64)])
@pytest.mark.parametrize("seed", [0, 7, 123, 2**32 - 1])
def test_half_precision_normal_is_bit_equal(seed, shape, dtype):
    """jax.random.normal in bfloat16 and float16 is another draw than the
    float32 one rounded (8 and 16 random bits, each operation rounded to
    the dtype); prng.normal reproduces it bit for bit under keys folded
    with several data values, and its float32 array cast to the dtype in
    torch is JAX's array."""
    for data in (0, 3, 2**31 + 5):
        key = prng.fold_in(prng.PRNGKey(seed), data)
        want = np.asarray(jax.random.normal(jax.random.fold_in(_jkey(seed), data), shape,
                                            HALF[dtype]))
        got = prng.normal(key, shape, dtype)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got, want.astype(np.float32))
        cast = torch.from_numpy(got).to(getattr(torch, dtype))
        np.testing.assert_array_equal(cast.float().numpy(), got)
    # not the float32 draw rounded
    f32 = prng.normal(prng.PRNGKey(seed), shape)
    rounded = torch.from_numpy(f32).to(getattr(torch, dtype)).float().numpy()
    assert (rounded != prng.normal(prng.PRNGKey(seed), shape, dtype)).mean() > 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_folded_draw_is_jax_vmapped_fold_in(dtype):
    """normal_folded(key, data, shape, dtype) is JAX's normal(fold_in(key,
    d), shape, dtype) for each d (the Trainer's k steps of noise in one
    call), and normal_rows in each dtype is the JAX engine's row-keyed
    sampler in that dtype."""
    jdt = {"float32": jnp.float32, **HALF}[dtype]
    data = np.array([0, 1, 5, 17, 2**31 + 1])
    got = prng.normal_folded(prng.PRNGKey(123), data, (4, 8), dtype)
    want = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(123), int(d)), (4, 8), jdt)) for d in data])
    assert got.shape == (5, 4, 8)
    exact = dtype != "float32"
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=0, atol=0 if exact else 1e-6)
    for i, d in enumerate(data):
        np.testing.assert_array_equal(
            got[i], prng.normal(prng.fold_in(prng.PRNGKey(123), int(d)), (4, 8), dtype))
    zeros = jnp.zeros((9, 18), jdt)
    rows = np.asarray(_sample_z_rows(np.uint32(7), np.arange(9, dtype=np.int32), zeros, zeros))
    np.testing.assert_allclose(prng.normal_rows(7, 9, 18, dtype), rows.astype(np.float32),
                               rtol=0, atol=0 if exact else 1e-6)
    assert prng.normal_rows(7, 9, 18, getattr(torch, dtype)).shape == (9, 18)


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_truncated_normal_within_one_ulp(seed):
    """jax.random.truncated_normal(key, -2, 2, shape), the conv weights'
    initializer: within one float32 ulp of 2 (2.384e-7; erf_inv is within a
    few ulps, as normal's), every value inside (-2, 2), and most values
    equal."""
    shape = (3, 64, 64)
    want = np.asarray(jax.random.truncated_normal(_jkey(seed), -2.0, 2.0, shape))
    got = prng.truncated_normal(prng.PRNGKey(seed), -2.0, 2.0, shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    assert (got != want).mean() < 0.05
    assert np.abs(got).max() < 2.0
