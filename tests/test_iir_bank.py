"""Band-stacked blocked IIR (`ops.iir_block.sosfilt_bank_apply`) against
`scipy.signal.sosfilt` in float64, band by band: real and complex
cascades, a length that is not a multiple of the block, and one band."""

import numpy as np
import pytest
from scipy.signal import butter

import jax
import jax.numpy as jnp

from _plain_reference import scale_relative_error, sosfilt
from dsptoolbox_jax.ops.iir_block import (
    sosfilt_bank_apply,
    sosfilt_bank_operators,
)


def _complex_bank():
    poles = 0.95 * np.exp(1j * np.linspace(0.1, 1.0, 6))
    bank = np.zeros((6, 4, 6), np.complex128)
    bank[:, :, 0] = 0.3
    bank[:, :, 3] = 1.0
    bank[:, :, 4] = -poles[:, None]
    return bank


def _real_bank():
    return np.stack(
        [
            butter(4, [f, f * 1.4], btype="bandpass", fs=48000, output="sos")
            for f in (200.0, 500.0, 1200.0, 3000.0)
        ]
    )


@pytest.mark.parametrize(
    "bank,shape,tol",
    [
        # 6 complex bands, T = 5000 (39 blocks of 128 plus a remainder)
        (_complex_bank(), (2, 5000), 1e-5),
        # 8th-order bandpasses down to 200-280 Hz at 48 kHz have poles
        # within 2e-3 of the unit circle: fp32 rounding is amplified by
        # ~1 / (1 - |p|) through the recursion (measured 1.6e-3)
        (_real_bank(), (3000,), 5e-3),
        # T = 1000 is not a multiple of the block; a single band
        (butter(4, 0.2, output="sos")[None], (1, 1000), 1e-5),
    ],
    ids=["complex-6-bands", "real-narrow-bands", "single-band-remainder"],
)
def test_bank_matches_scipy_per_band(bank, shape, tol):
    rng = np.random.default_rng(71)
    x = (rng.standard_normal(shape) * 0.4).astype(np.float32)
    ops = sosfilt_bank_operators(bank, x.shape[-1])
    got = np.asarray(
        jax.jit(lambda v: sosfilt_bank_apply(ops, v))(jnp.asarray(x))
    )
    assert got.shape == (len(bank),) + x.shape
    for b in range(len(bank)):
        assert scale_relative_error(got[b], sosfilt(bank[b], x)) < tol, b
