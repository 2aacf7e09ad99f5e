"""Blocked triangular-matmul prefix sums (`ops/prefix.py`) vs jnp.cumsum
oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from dsptoolbox_jax.ops.prefix import cumsum_matmul


@pytest.mark.parametrize("T", [17, 255, 256, 1000, 4097])
@pytest.mark.parametrize("reverse", [False, True])
def test_cumsum_matmul_matches_cumsum(T, reverse):
    rng = np.random.default_rng(7 + T)
    x = rng.standard_normal((3, T)).astype(np.float32)
    got = np.asarray(cumsum_matmul(jnp.asarray(x), reverse=reverse))
    ref = np.cumsum(x[:, ::-1] if reverse else x, axis=-1, dtype=np.float64)
    if reverse:
        ref = ref[:, ::-1]
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4 * np.sqrt(T))


def test_cumsum_matmul_energy_accuracy():
    # all-positive energy input: blockwise summation must stay within fp32
    # reordering error of the f64 truth over long signals
    rng = np.random.default_rng(0)
    e = (rng.standard_normal((2, 48000)).astype(np.float32)) ** 2
    got = np.asarray(cumsum_matmul(jnp.asarray(e), reverse=True))
    ref = np.cumsum(e[:, ::-1].astype(np.float64), axis=-1)[:, ::-1]
    np.testing.assert_allclose(got, ref, rtol=5e-6)


def test_cumsum_matmul_batched_nd():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 700)).astype(np.float32)
    got = np.asarray(cumsum_matmul(jnp.asarray(x)))
    ref = np.cumsum(x, axis=-1, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=3e-3)


def test_cumsum_matmul_f64():
    import jax

    if not jax.config.jax_enable_x64:
        pytest.skip("x64 not enabled in this session")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 900))
    got = np.asarray(cumsum_matmul(jnp.asarray(x, dtype=jnp.float64)))
    ref = np.cumsum(x, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
