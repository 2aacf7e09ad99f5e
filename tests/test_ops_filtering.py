"""Oracle tests: filtering/conv/resample ops vs scipy (the reference's L0)."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import signal as ss

from dsptoolbox_jax.ops.iir import (
    filtfilt_ba,
    lfilter,
    sosfilt,
    sosfilt_zi,
    sosfiltfilt,
)
from dsptoolbox_jax.ops.fft_conv import (
    fft_convolve,
    fft_correlate,
    resample_poly,
    upfirdn,
)

rng = np.random.default_rng(7)
X = rng.standard_normal((3, 2048)).astype(np.float32)


class TestIIR:
    def test_sosfilt_matches_scipy(self, close):
        sos = ss.butter(8, [0.1, 0.4], btype="bandpass", output="sos")
        ref = ss.sosfilt(sos, X.astype(np.float64), axis=-1)
        y, zf = sosfilt(sos, jnp.asarray(X))
        close(y, ref, 2e-5, "sosfilt")
        assert zf.shape == (3, sos.shape[0], 2)

    def test_sosfilt_with_zi(self, close):
        sos = ss.butter(4, 0.25, output="sos")
        zi = sosfilt_zi(sos)
        zi_scipy = np.broadcast_to(zi[:, None, :], (zi.shape[0], 3, 2))
        ref, zf_ref = ss.sosfilt(sos, X.astype(np.float64), axis=-1, zi=zi_scipy)
        y, zf = sosfilt(sos, jnp.asarray(X), zi=np.moveaxis(zi_scipy, 0, 1))
        close(y, ref, 2e-5, "sosfilt_zi")
        close(zf, np.moveaxis(zf_ref, 0, 1), 2e-5, "zf")

    def test_streaming_blocks_equal_offline(self, close):
        """Chunked filtering with carried state == one-shot (streaming parity)."""
        sos = ss.butter(6, 0.2, output="sos")
        x = jnp.asarray(X)
        full, _ = sosfilt(sos, x)
        zi = jnp.zeros((3, sos.shape[0], 2))
        outs = []
        for k in range(4):
            blk, zi = sosfilt(sos, x[:, k * 512 : (k + 1) * 512], zi=zi)
            outs.append(blk)
        close(jnp.concatenate(outs, axis=-1), np.asarray(full), 1e-6, "blocks")

    def test_lfilter_matches_scipy(self, close):
        b, a = ss.cheby1(5, 1, 0.3)
        ref = ss.lfilter(b, a, X.astype(np.float64), axis=-1)
        y, _ = lfilter(b, a, jnp.asarray(X))
        close(y, ref, 2e-5, "lfilter")

    def test_lfilter_fir_path(self, close):
        b = ss.firwin(33, 0.3)
        ref = ss.lfilter(b, [1.0], X.astype(np.float64), axis=-1)
        y, _ = lfilter(b, np.array([1.0]), jnp.asarray(X))
        close(y, ref, 2e-5, "lfilter_fir")

    def test_sosfiltfilt(self, close):
        sos = ss.butter(4, 0.2, output="sos")
        ref = ss.sosfiltfilt(sos, X.astype(np.float64), axis=-1)
        close(sosfiltfilt(sos, jnp.asarray(X)), ref, 2e-5, "sosfiltfilt")

    @pytest.mark.slow
    def test_filtfilt_ba(self, close):
        b, a = ss.butter(3, 0.35)
        ref = ss.filtfilt(b, a, X.astype(np.float64), axis=-1)
        close(filtfilt_ba(b, a, jnp.asarray(X)), ref, 2e-5, "filtfilt")


class TestConv:
    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    def test_fft_convolve(self, mode, close):
        h = rng.standard_normal(65)
        ref = ss.convolve(X.astype(np.float64), h[None], mode=mode)
        y = fft_convolve(jnp.asarray(X), jnp.asarray(h, dtype=jnp.float32))
        # slice per-mode like scipy
        got = fft_convolve(
            jnp.asarray(X), jnp.asarray(h, dtype=jnp.float32), mode=mode
        )
        close(got, ref, 2e-5, f"conv_{mode}")

    def test_fft_correlate(self, close):
        y2 = rng.standard_normal((3, 500))
        ref = ss.correlate(X.astype(np.float64), y2, mode="full")
        # per-channel correlate in scipy is 2D; use single channel
        ref1 = ss.correlate(X[0].astype(np.float64), y2[0], mode="full")
        got = fft_correlate(jnp.asarray(X[0]), jnp.asarray(y2[0], jnp.float32))
        close(got, ref1, 2e-5, "correlate")

    def test_upfirdn(self, close):
        h = ss.firwin(48, 0.4)
        ref = ss.upfirdn(h, X.astype(np.float64), up=3, down=2, axis=-1)
        got = upfirdn(h, jnp.asarray(X), up=3, down=2)
        close(got, ref, 2e-5, "upfirdn")

    @pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (3, 5), (160, 147)])
    def test_resample_poly(self, up, down, close):
        ref = ss.resample_poly(X.astype(np.float64), up, down, axis=-1)
        got = resample_poly(jnp.asarray(X), up, down)
        assert got.shape == ref.shape
        close(got, ref, 2e-5, f"resample_{up}_{down}")


class TestReviewRegressions:
    """Regressions from the round-1 ops code review."""

    def test_fft_correlate_complex_conjugates(self, close):
        """scipy.signal.correlate conjugates in2; complex inputs must too."""
        rng2 = np.random.default_rng(5)
        a = (
            rng2.standard_normal(257) + 1j * rng2.standard_normal(257)
        ).astype(np.complex64)
        b = (
            rng2.standard_normal(63) + 1j * rng2.standard_normal(63)
        ).astype(np.complex64)
        ref = ss.correlate(a.astype(np.complex128), b.astype(np.complex128))
        got = fft_correlate(jnp.asarray(a), jnp.asarray(b))
        close(got, ref, 2e-5, "complex correlate")

    def test_sosfilt_block_empty_input(self):
        from dsptoolbox_jax.ops.iir_block import sosfilt_block

        sos = ss.butter(4, 0.3, output="sos")
        x = jnp.zeros((3, 0), jnp.float32)
        y, zf = sosfilt_block(sos, x)
        assert y.shape == (3, 0)
        assert zf.shape == (3, sos.shape[0], 2)
