"""Transfer functions tests vs the reference oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

import dsptoolbox_jax as dsp
from dsptoolbox_jax import transfer_functions as tf

EXAMPLE = "/root/reference/example_data"


def _ref_tf(ref):
    return ref.transfer_functions


class TestSpectralDeconvolve:
    def test_regularized_vs_reference(self, ref, close):
        exc_m = dsp.Signal(f"{EXAMPLE}/chirp.wav")
        out_m = dsp.Signal(f"{EXAMPLE}/chirp_stereo.wav")
        exc_r = ref.Signal(f"{EXAMPLE}/chirp.wav")
        out_r = ref.Signal(f"{EXAMPLE}/chirp_stereo.wav")
        ir_m = tf.spectral_deconvolve(out_m, exc_m)
        ir_r = _ref_tf(ref).spectral_deconvolve(out_r, exc_r)
        close(ir_m.time_data, ir_r.time_data, 2e-5, "deconv")

    def test_padding_variants(self, ref, close):
        exc_m = dsp.Signal(f"{EXAMPLE}/chirp.wav")
        out_m = dsp.Signal(f"{EXAMPLE}/chirp_mono.wav")
        exc_r = ref.Signal(f"{EXAMPLE}/chirp.wav")
        out_r = ref.Signal(f"{EXAMPLE}/chirp_mono.wav")
        # NOTE: apply_regularization=False is excluded: plain spectral
        # division amplifies fp32 rounding unboundedly at near-zero
        # denominator bins, so exact parity with the f64 oracle is not a
        # meaningful target there.
        for kwargs in [
            dict(padding=True),
            dict(padding=True, keep_original_length=True),
        ]:
            ir_m = tf.spectral_deconvolve(out_m, exc_m, **kwargs)
            ir_r = _ref_tf(ref).spectral_deconvolve(out_r, exc_r, **kwargs)
            close(ir_m.time_data, ir_r.time_data, 2e-5, str(kwargs))


class TestWindowing:
    def _irs(self, ref):
        exc = dsp.Signal(f"{EXAMPLE}/chirp.wav")
        out = dsp.Signal(f"{EXAMPLE}/chirp_stereo.wav")
        ir_m = tf.spectral_deconvolve(out, exc)
        exc_r = ref.Signal(f"{EXAMPLE}/chirp.wav")
        out_r = ref.Signal(f"{EXAMPLE}/chirp_stereo.wav")
        ir_r = _ref_tf(ref).spectral_deconvolve(out_r, exc_r)
        return ir_m, ir_r

    def test_window_ir(self, ref, close):
        ir_m, ir_r = self._irs(ref)
        w_m, s_m = tf.window_ir(ir_m, 4096)
        w_r, s_r = _ref_tf(ref).window_ir(ir_r, 4096)
        np.testing.assert_array_equal(np.asarray(s_m), s_r)
        close(w_m.time_data, w_r.time_data, 2e-5, "window_ir")
        # the Hann flanks are built in-graph in the compute dtype (the
        # zero-sync fused path), so parity is fp32-level, not bit-exact
        close(np.asarray(w_m.window), w_r.window, 2e-5, "window")

    def test_window_ir_tukey(self, ref, close):
        ir_m, ir_r = self._irs(ref)
        w_m = tf.window_ir_tukey(ir_m, 0.01, 0.05)
        w_r = _ref_tf(ref).window_ir_tukey(ir_r, 0.01, 0.05)
        close(w_m.time_data, w_r.time_data, 2e-5, "window_ir_tukey")

    def test_window_centered_ir(self, ref, close):
        ir_m, ir_r = self._irs(ref)
        w_m, _ = tf.window_centered_ir(ir_m, 2048)
        w_r, _ = _ref_tf(ref).window_centered_ir(ir_r, 2048)
        close(w_m.time_data, w_r.time_data, 2e-5, "window_centered")


class TestEstimators:
    def test_h1_h2_h3(self, ref, close):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((8192, 1)) * 0.3
        from scipy.signal import lfilter

        y = lfilter([0.3, 0.2, 0.1], [1.0], x, axis=0) + (
            rng.standard_normal((8192, 1)) * 0.01
        )
        for mode_m, mode_r in [
            (tf.TransferFunctionType.H1, "H1"),
            (tf.TransferFunctionType.H2, "H2"),
            (tf.TransferFunctionType.H3, "H3"),
        ]:
            out_m = tf.compute_transfer_function(
                dsp.Signal(None, y.copy(), 16000),
                dsp.Signal(None, x.copy(), 16000),
                1024,
                mode=mode_m,
            )
            out_r = _ref_tf(ref).compute_transfer_function(
                ref.Signal(None, y.copy(), 16000),
                ref.Signal(None, x.copy(), 16000),
                1024,
                mode=getattr(
                    ref.transfer_functions.TransferFunctionType, mode_r
                ),
            )
            # NOTE: the DC bin is excluded — with detrend=True both
            # implementations produce a noise/noise ratio there (the
            # per-frame mean removal zeroes Gxx(0)), which is numerically
            # meaningless in either precision.
            close(
                np.abs(np.asarray(out_m.spectral_data))[1:],
                np.abs(out_r.spectral_data)[1:],
                5e-4,
                mode_r,
            )
            close(
                out_m.coherence[1:], out_r.coherence[1:], 5e-4, "coherence"
            )

    def test_h1_complex_psd_scaling(self, ref, close):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((8192, 1)) * 0.3
        from scipy.signal import lfilter

        y = lfilter([0.3, 0.2, 0.1], [1.0], x, axis=0)
        sig_x_m = dsp.Signal(None, x.copy(), 16000)
        sig_x_m.set_spectrum_parameters(
            scaling=dsp.SpectrumScaling.PowerSpectralDensity
        )
        sig_x_r = ref.Signal(None, x.copy(), 16000)
        sig_x_r.set_spectrum_parameters(
            scaling=ref.SpectrumScaling.PowerSpectralDensity
        )
        out_m = tf.compute_transfer_function(
            dsp.Signal(None, y.copy(), 16000), sig_x_m, 1024,
            mode=tf.TransferFunctionType.H1,
        )
        out_r = _ref_tf(ref).compute_transfer_function(
            ref.Signal(None, y.copy(), 16000), sig_x_r, 1024,
            mode=ref.transfer_functions.TransferFunctionType.H1,
        )
        close(
            np.asarray(out_m.spectral_data)[1:],
            out_r.spectral_data[1:],
            5e-3,
            "H1 complex psd",
        )


class TestPhaseTools:
    def test_min_phase_ir(self, ref, close):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        m = tf.min_phase_ir(rir_m)
        r = _ref_tf(ref).min_phase_ir(rir_r)
        close(m.time_data, r.time_data, 1e-4, "min_phase_ir")

    def test_group_delay(self, ref, close):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        f_m, gd_m = tf.group_delay(rir_m, analytic_computation=False)
        f_r, gd_r = _ref_tf(ref).group_delay(
            rir_r, analytic_computation=False
        )
        np.testing.assert_allclose(f_m, f_r)
        close(gd_m, gd_r, 1e-4, "group delay")

    def test_minimum_and_excess_group_delay(self, ref, close):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        f_m, gd_m = tf.minimum_group_delay(rir_m)
        f_r, gd_r = _ref_tf(ref).minimum_group_delay(rir_r)
        close(gd_m, gd_r, 1e-5, "min gd")

    def test_minimum_phase(self, ref, close):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        f_m, ph_m = tf.minimum_phase(rir_m)
        f_r, ph_r = _ref_tf(ref).minimum_phase(rir_r)
        close(ph_m, ph_r, 1e-5, "min phase")

    def test_min_phase_from_mag(self, ref, close):
        f = np.linspace(0, 4000, 257)
        mag = np.abs(np.random.default_rng(1).standard_normal((257, 1))) + 0.3
        m = tf.min_phase_from_mag(dsp.Spectrum(f, mag), 8000, 512)
        r = _ref_tf(ref).min_phase_from_mag(
            ref.Spectrum(f, mag.copy()), 8000, 512
        )
        close(m.time_data, r.time_data, 1e-6, "min_phase_from_mag")

    def test_lin_phase_from_mag(self, ref, close):
        f = np.linspace(0, 4000, 257)
        mag = np.abs(np.random.default_rng(2).standard_normal((257, 1))) + 0.3
        m = tf.lin_phase_from_mag(
            dsp.Spectrum(f, mag), 8000, group_delay_ms=20,
            check_causality=False,
        )
        r = _ref_tf(ref).lin_phase_from_mag(
            ref.Spectrum(f, mag.copy()), 8000, group_delay_ms=20,
            check_causality=False,
        )
        # measured 8e-6: fp32 interpolation of an (adversarial) white
        # random magnitude onto the dense design grid. Was 1e-2 before the
        # design grid pinned Nyquist exactly (an ulp overshoot zeroed the
        # Nyquist bin through the interpolator's zero-pad edge handling)
        close(m.time_data, r.time_data, 5e-5, "lin_phase_from_mag")


class TestIRTools:
    def test_ir_to_filter_roundtrip(self, ref, close):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        filt = tf.ir_to_filter(rir_m, 0)
        assert filt.is_fir
        back = tf.filter_to_ir(filt)
        close(
            back.time_data[:, 0], rir_m.time_data[:, 0], 1e-6, "roundtrip"
        )

    def test_trim_ir(self, ref):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        t_m, start_m, stop_m = tf.trim_ir(rir_m, channel=0)
        t_r, start_r, stop_r = _ref_tf(ref).trim_ir(rir_r, channel=0)
        assert start_m == start_r
        assert abs(stop_m - stop_r) <= 2

    def test_find_ir_latency(self, ref):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        lat_m = tf.find_ir_latency(rir_m)
        lat_r = _ref_tf(ref).find_ir_latency(rir_r)
        np.testing.assert_allclose(lat_m, lat_r, atol=1e-2)

    def test_window_frequency_dependent(self, ref, close):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        # shorten for speed
        rir_m.time_data = rir_m.time_data[:2048]
        rir_r.time_data = rir_r.time_data[:2048]
        m = tf.window_frequency_dependent(rir_m, cycles=8)
        r = _ref_tf(ref).window_frequency_dependent(rir_r, cycles=8)
        close(
            np.abs(np.asarray(m.spectral_data)),
            np.abs(r.spectral_data),
            1e-3,
            "fdw",
        )

    def test_fdw_core_phase_accuracy_long_signal(self):
        # Regression: the rotation phase f*n/T reaches ~1e4 cycles at
        # measurement lengths, past fp32 mantissa. The coarse/fine mod-1
        # split must keep complex (not just magnitude) error near the
        # fp32 accumulation floor vs a float64 direct-sum oracle.
        from dsptoolbox_jax.transfer_functions._backend import fdw_core

        rng = np.random.default_rng(7)
        T, C = 16384, 2
        x = rng.standard_normal((T, C)).astype(np.float32)
        freqs = np.linspace(50.0, T / 2 - 50.0, 32)  # fractional bins
        alpha = np.full(32, 3.0)
        peaks = np.array([64, T - 200])

        spec = np.asarray(fdw_core(x, freqs, alpha, peaks, chunk=32))

        half = (T - 1) / 2
        n_rel = np.arange(T)[:, None] - peaks[None, :]
        n = np.arange(T)
        oracle = np.zeros((32, C), complex)
        for i, (f, a) in enumerate(zip(freqs, alpha)):
            win = np.exp(-0.5 * (n_rel / half) ** 2 * a)
            rot = np.exp(-2j * np.pi * f * n / T)
            oracle[i] = (win * rot[:, None] * x).sum(0)

        scale = np.abs(oracle).max()
        err = np.abs(spec - oracle) / scale
        # fp32 accumulation floor here is ~7e-5; the pre-split fp32 phase
        # path measured ~2e-3 on the same inputs.
        assert err.max() < 2e-4, f"fdw complex error {err.max():.2e}"

    def test_complex_smoothing(self, ref, close):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_m.time_data = rir_m.time_data[:4096]
        rir_r.time_data = rir_r.time_data[:4096]
        m = tf.complex_smoothing(
            rir_m, 3, tf.SmoothingDomain.RealImaginary
        )
        r = _ref_tf(ref).complex_smoothing(
            rir_r,
            3,
            ref.transfer_functions.SmoothingDomain.RealImaginary,
        )
        close(
            np.asarray(m.spectral_data),
            r.spectral_data,
            1e-4,
            "complex smoothing",
        )

    @pytest.mark.slow
    def test_complex_smoothing_long_banded_oracle(self, ref, close):
        # full-length rir.wav → F > 4096 → the O(F·W) banded device path
        # (formerly a host fallback); oracle = the reference package
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        m = tf.complex_smoothing(
            rir_m, 6, tf.SmoothingDomain.RealImaginary
        )
        r = _ref_tf(ref).complex_smoothing(
            rir_r,
            6,
            ref.transfer_functions.SmoothingDomain.RealImaginary,
        )
        close(
            np.asarray(m.spectral_data),
            r.spectral_data,
            1e-4,
            "banded complex smoothing",
        )

    def test_banded_plan_matches_host_kernel(self):
        # the vectorized banded plan must reproduce the per-row reference
        # kernel (complex_smoothing_host shares its code with the dense
        # operator) on a long spectrum
        from dsptoolbox_jax.transfer_functions import _backend as bk2

        rng = np.random.default_rng(4)
        F = 6000
        fs = 48000
        freqs = np.fft.rfftfreq(2 * (F - 1), 1 / fs)
        x = (
            rng.standard_normal((F, 2))
            + 1j * rng.standard_normal((F, 2))
        ).astype(np.complex64)
        wy = np.asarray(dsp.standard.enums.Window.Hann(3000, True))
        want = bk2.complex_smoothing_host(x, freqs, 5, wy)
        got = np.asarray(
            bk2.complex_smoothing_banded(jnp.asarray(x), freqs, 5, wy)
        )
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 2e-6

    @pytest.mark.parametrize(
        "offsets", [(0, 100, 333), (0, 0, 744)], ids=["spread", "edges"]
    )
    def test_banded_matmul_matches_dense_band(self, offsets):
        # the gathered batched matmul equals the dense (rows x F) band
        # matrix built from the same slabs, applied in float64
        from dsptoolbox_jax.transfer_functions._backend import (
            banded_matmul_xla,
        )

        rng = np.random.default_rng(7)
        nb, tr, span, c = 3, 128, 256, 2
        slab = rng.standard_normal((nb, tr, span)).astype(np.float32)
        offsets = np.array(offsets, np.int32)
        x = rng.standard_normal((1000, c)).astype(np.float32)
        dense = np.zeros((nb * tr, x.shape[0]))
        for b in range(nb):
            dense[b * tr:(b + 1) * tr, offsets[b]:offsets[b] + span] = slab[b]
        want = dense @ x.astype(np.float64)
        got = np.asarray(
            banded_matmul_xla(
                jnp.asarray(slab), jnp.asarray(offsets), jnp.asarray(x)
            )
        )
        assert got.shape == want.shape
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    def test_harmonics_from_chirp_ir(self, ref, close):
        # synthetic exponential chirp measurement
        chirp_m, Tm = dsp.generators.chirp(
            48000,
            dsp.generators.ChirpType.SyncLog,
            [20, 20000],
            2.0,
            padding_end_seconds=1.0,
        )
        exc = dsp.Signal(None, chirp_m.time_data, 48000)
        ir = tf.spectral_deconvolve(exc, exc, padding=True)
        harms = tf.harmonics_from_chirp_ir(ir, [20, 20000], 2.0, 3)
        assert len(harms) == 3

    def test_average_irs(self, ref, close):
        rir = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        two = dsp.append_signals([rir, rir])
        two_ir = dsp.ImpulseResponse.from_signal(two)
        avg = tf.average_irs(two_ir, time_average=False)
        close(
            avg.time_data[:, 0],
            rir.time_data[:, 0] / np.max(np.abs(rir.time_data)) * np.max(np.abs(avg.time_data)),
            2e-1,
            "averaging sanity",
        )

    def test_average_irs_time_branch_vs_reference(self, ref, close):
        # regression: the time-average branch wrote into the read-only host
        # view returned by the time_data getter
        rir = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        td2 = np.concatenate([np.asarray(rir.time_data)] * 2, axis=1)
        td2[:, 1] = np.roll(td2[:, 1], 7)
        got = tf.average_irs(
            dsp.ImpulseResponse.from_time_data(td2, rir.sampling_rate_hz),
            time_average=True,
        )
        ref_ir = _ref_tf(ref).average_irs(
            ref.ImpulseResponse.from_time_data(
                td2.copy(), rir.sampling_rate_hz
            ),
            time_average=True,
        )
        assert np.all(np.isfinite(got.time_data))
        close(
            got.time_data[:, 0],
            ref_ir.time_data[:, 0],
            1e-3,
            "time-averaged IR",
        )


class TestHarmonicDistortionAnalysis:
    @pytest.mark.slow
    def test_oracle(self, ref):
        ir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        ir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        out_m = tf.harmonic_distortion_analysis(
            ir_m, chirp_range_hz=[20, 20e3], chirp_length_s=2,
            n_harmonics=7,
        )
        out_r = ref.transfer_functions.harmonic_distortion_analysis(
            ir_r, chirp_range_hz=[20, 20e3], chirp_length_s=2,
            n_harmonics=7,
        )
        # compare the THD spectra dictionaries
        for key in ("thd", "thd_n"):
            a = np.asarray(out_m[key].spectral_data)
            b = np.asarray(out_r[key].spectral_data)
            scale = np.max(np.abs(b))
            assert np.max(np.abs(a - b)) / scale < 5e-2, key


class TestCombineIrWithDirac:
    @pytest.mark.parametrize(
        "keep_low,norm", [(True, None), (False, None), (False, "energy")]
    )
    def test_oracle(self, ref, close, keep_low, norm):
        ir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        ir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        out_m = tf.combine_ir_with_dirac(
            ir_m, 1000, keep_low, normalization=norm
        )
        out_r = ref.transfer_functions.combine_ir_with_dirac(
            ir_r, 1000, keep_low, normalization=norm
        )
        close(
            out_m.time_data, out_r.time_data, 5e-4,
            f"combine dirac {keep_low} {norm}",
        )


class TestDeconvolveReviewRegressions:
    """Oracle regressions from the round-1 review: padded FFT length and
    channel-0 regularization-range reuse."""

    def test_deconvolve_preserves_caller_state_and_caches(self):
        # deconvolve must not leave the callers' signals mutated nor drop
        # their cached Welch spectra (regression: setter-based override)
        from dsptoolbox_jax.standard.enums import SpectrumMethod

        rng = np.random.default_rng(5)
        exc = dsp.Signal(
            None, rng.standard_normal((8192, 1)) * 0.4, 48000,
            activate_cache=True,
        )
        rec = dsp.Signal(
            None, rng.standard_normal((8192, 1)) * 0.4, 48000,
            activate_cache=True,
        )
        assert exc.spectrum_method == SpectrumMethod.WelchPeriodogram
        exc.get_spectrum()  # populate the Welch cache (device-backed in
        # lazy mode, host otherwise)
        cached = exc._cache.get("spectrum_dev") or exc._cache.get(
            "spectrum"
        )
        assert cached is not None
        dsp.transfer_functions.spectral_deconvolve(rec, exc)
        assert exc.spectrum_method == SpectrumMethod.WelchPeriodogram
        assert rec.spectrum_method == SpectrumMethod.WelchPeriodogram
        assert (
            exc._cache.get("spectrum_dev") or exc._cache.get("spectrum")
        ) is cached, "deconvolve dropped the caller's cached spectrum"

    def test_non_fast_length_matches_reference(self, ref):
        rng = np.random.default_rng(31)
        L = 4001  # not 5-smooth: exercises next_fast_len padding
        exc = rng.standard_normal((L, 1)) * 0.4
        rec = rng.standard_normal((L, 1)) * 0.4
        ir_m = dsp.transfer_functions.spectral_deconvolve(
            dsp.Signal(None, rec, 48000), dsp.Signal(None, exc, 48000)
        )
        ir_r = ref.transfer_functions.spectral_deconvolve(
            ref.Signal(None, rec, 48000), ref.Signal(None, exc, 48000)
        )
        np.testing.assert_allclose(
            ir_m.time_data, ir_r.time_data, rtol=1e-3,
            atol=2e-5 * np.max(np.abs(ir_r.time_data)),
        )

    def test_multichannel_regularization_matches_reference(self, ref):
        """Channels with different bandwidths: the automatic range comes
        from channel 0 only (reference loop reassignment)."""
        from scipy.signal import sosfilt, butter

        rng = np.random.default_rng(32)
        L = 4096
        wide = rng.standard_normal(L)
        narrow = sosfilt(
            butter(4, [500, 4000], btype="bandpass", fs=48000,
                   output="sos"),
            rng.standard_normal(L),
        )
        exc = np.stack([wide, narrow], axis=1) * 0.2
        rec = rng.standard_normal((L, 2)) * 0.2
        ir_m = dsp.transfer_functions.spectral_deconvolve(
            dsp.Signal(None, rec, 48000), dsp.Signal(None, exc, 48000)
        )
        ir_r = ref.transfer_functions.spectral_deconvolve(
            ref.Signal(None, rec, 48000), ref.Signal(None, exc, 48000)
        )
        np.testing.assert_allclose(
            ir_m.time_data, ir_r.time_data, rtol=1e-3,
            atol=1e-4 * np.max(np.abs(ir_r.time_data)),  # fp32
        )


class TestWindowIrFusedPath:
    """The zero-sync fused window_ir program must agree with the host
    index-arithmetic path (`window_this_ir_tukey`) for every parameter
    combination, including peaks near the edges."""

    def _one_case(self, peak, T, total_length, adaptive, cp, offset, ratio):
        rng = np.random.default_rng(peak + T)
        td = rng.standard_normal(T) * 0.01
        td[peak] = 1.0
        sig = dsp.ImpulseResponse(None, td, 48000)
        w_sig, starts = tf.window_ir(
            sig,
            total_length,
            adaptive=adaptive,
            constant_percentage=cp,
            offset_samples=offset,
            left_to_right_flank_length_ratio=ratio,
        )
        from dsptoolbox_jax.transfer_functions import _backend as bk

        try:
            exp_td, exp_win, exp_start = bk.window_this_ir_tukey(
                np.asarray(sig.time_data)[:, 0],
                total_length,
                dsp.standard.enums.Window.Hann,
                cp,
                True,
                offset,
                ratio,
                adaptive,
            )
        except AssertionError:
            return  # host path rejects; fused path clamps (documented)
        assert int(np.asarray(starts)[0]) == int(exp_start)
        scale = max(np.max(np.abs(exp_td)), 1e-12)
        np.testing.assert_allclose(
            np.asarray(w_sig.time_data)[:, 0], exp_td,
            atol=2e-6 * scale, rtol=2e-6,
        )
        np.testing.assert_allclose(
            np.asarray(w_sig.window)[:, 0], exp_win, atol=2e-6, rtol=2e-6
        )

    def test_sweep(self):
        T = 4000
        total_length = 1024
        for adaptive in (True, False):
            for cp in (0.75, 0.5):
                for offset in (0, 100):
                    for ratio in (1.0, 0.7, 1.6):
                        for peak in (3, 40, T // 2, T - 700, T - 5):
                            self._one_case(
                                peak, T, total_length, adaptive, cp,
                                offset, ratio,
                            )
