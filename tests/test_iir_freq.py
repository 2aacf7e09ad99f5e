"""Frequency-sampling IIR path (`ops.iir_freq`) and the blocked IIR
(`ops.iir_block.sosfilt_block`) against the scipy float64 oracle."""

import numpy as np
import pytest
from scipy.signal import butter, cheby1, ellip, sosfilt, sosfilt_zi

import jax.numpy as jnp
from dsptoolbox_jax.ops.iir import sosfilt_zero_state
from dsptoolbox_jax.ops.iir_block import sosfilt_block
from dsptoolbox_jax.ops.iir_freq import (
    decay_margin,
    plan_nfft,
    sosfilt_bank_freq,
    sosfilt_freq,
)

RNG = np.random.default_rng(7)


def _rel_err(got, want):
    return np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))


class TestSosfiltFreq:
    x = RNG.standard_normal((2, 44100)).astype(np.float32)

    @pytest.mark.parametrize(
        "sos",
        [
            butter(4, 0.2, output="sos"),
            butter(8, [0.0105, 0.0115], btype="bandpass", output="sos"),
            cheby1(6, 0.5, 0.7, btype="highpass", output="sos"),
            ellip(4, 0.5, 60, [0.3, 0.31], btype="bandstop", output="sos"),
        ],
        ids=["butter-lp", "narrow-bp", "cheby-hp", "ellip-bs"],
    )
    def test_matches_scipy_f64(self, sos):
        y = sosfilt_freq(sos, jnp.asarray(self.x))
        y_ref = sosfilt(sos, self.x.astype(np.float64), axis=-1)
        assert _rel_err(y, y_ref) < 5e-6

    def test_complex_gammatone_section(self):
        fs, f0 = 44100, 500.0
        erb = 24.7 + f0 / 9.265
        a_g = np.pi * 720 * 2**-6 / 36
        lam = np.exp(-2 * np.pi * (erb / a_g) / fs)
        c = lam * np.exp(1j * 2 * np.pi * f0 / fs)
        sos = np.tile(np.array([[1, 0, 0, 1, -c, 0]]), (4, 1))
        sos[3, 0] = 2 * (1 - np.abs(c)) ** 4
        y = sosfilt_freq(sos, jnp.asarray(self.x))
        y_ref = sosfilt(sos, self.x.astype(np.complex128), axis=-1)
        assert np.iscomplexobj(np.asarray(y))
        assert _rel_err(y, y_ref) < 5e-6

    def test_bank(self):
        bank = np.stack(
            [butter(4, f, output="sos") for f in (0.1, 0.3, 0.5, 0.8)]
        )
        y = np.asarray(sosfilt_bank_freq(bank, jnp.asarray(self.x)))
        assert y.shape == (4,) + self.x.shape
        for i in range(4):
            y_ref = sosfilt(bank[i], self.x.astype(np.float64), axis=-1)
            assert _rel_err(y[i], y_ref) < 5e-6

    def test_margin_none_for_integrator(self):
        # pole exactly on the unit circle: frequency sampling must refuse
        sos = np.array([[1.0, 0, 0, 1.0, -1.0, 0]])
        assert decay_margin(sos) is None
        assert plan_nfft(sos, 10000) is None

    def test_zero_state_dispatch_consistency(self):
        """Long (freq) and short (blocked) dispatch agree with scipy."""
        sos = butter(4, 0.25, output="sos")
        for T in (1024, 50000):  # below / above the dispatch threshold
            x = self.x[:, :T]
            y = sosfilt_zero_state(sos, jnp.asarray(x))
            y_ref = sosfilt(sos, x.astype(np.float64), axis=-1)
            assert _rel_err(y, y_ref) < 5e-6


class TestSosfiltBlock:
    @pytest.mark.parametrize(
        "B,T,order,L",
        [(3, 1024, 4, 128), (1, 4096, 8, 128), (5, 2000, 2, 100)],
    )
    def test_matches_scipy(self, B, T, order, L):
        sos = butter(order, 0.2, output="sos")
        x = RNG.standard_normal((B, T)).astype(np.float32)
        y, zf = sosfilt_block(sos, jnp.asarray(x), block_size=L)
        y_ref, zf_ref = sosfilt(
            sos, x.astype(np.float64), axis=-1,
            zi=np.zeros((sos.shape[0], B, 2)),
        )
        assert _rel_err(y, y_ref) < 5e-6
        zf_got = np.asarray(zf)  # (B, S, 2)
        assert np.max(
            np.abs(zf_got - np.transpose(zf_ref, (1, 0, 2)))
        ) < 1e-6

    def test_long_signal_with_remainder_and_state(self):
        """32 full blocks plus a 77-sample tail, carried initial state:
        output and final state against scipy."""
        sos = butter(6, 0.3, output="sos")
        x = RNG.standard_normal((2, 4096 + 77)).astype(np.float32)
        zi1 = np.tile(sosfilt_zi(sos)[None], (2, 1, 1)) * 0.3
        y, zf = sosfilt_block(
            sos, jnp.asarray(x), zi=jnp.asarray(zi1, jnp.float32)
        )
        y_ref, zf_ref = sosfilt(
            sos, x.astype(np.float64), axis=-1,
            zi=np.transpose(zi1, (1, 0, 2)),
        )
        assert _rel_err(y, y_ref) < 5e-6
        assert np.max(
            np.abs(np.asarray(zf) - np.transpose(zf_ref, (1, 0, 2)))
        ) < 1e-6

    def test_initial_state_and_zf(self):
        sos = butter(4, 0.2, output="sos")
        B, T, L = 3, 1024, 128
        x = RNG.standard_normal((B, T)).astype(np.float32)
        zi1 = np.tile(sosfilt_zi(sos)[None], (B, 1, 1)) * RNG.standard_normal(
            (B, 1, 1)
        )
        y, zf = sosfilt_block(
            sos,
            jnp.asarray(x),
            zi=jnp.asarray(zi1, jnp.float32),
            block_size=L,
        )
        y_ref, zf_ref = sosfilt(
            sos,
            x.astype(np.float64),
            axis=-1,
            zi=np.transpose(zi1, (1, 0, 2)),
        )
        assert _rel_err(y, y_ref) < 5e-6
        zf_got = np.asarray(zf).reshape(B, -1, 2)
        assert np.max(
            np.abs(zf_got - np.transpose(zf_ref, (1, 0, 2)))
        ) < 1e-6
