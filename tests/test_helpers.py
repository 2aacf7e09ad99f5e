"""Oracle tests: helpers vs the reference package's private helpers."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsptoolbox_jax import helpers as H

rng = np.random.default_rng(3)


class TestInterpolation:
    def test_pchip_matches_scipy(self, close):
        from scipy.interpolate import PchipInterpolator

        x = np.sort(rng.uniform(0, 10, 50))
        y = rng.standard_normal((50, 4))
        xq = np.linspace(x[0], x[-1], 333)
        ref = PchipInterpolator(x, y, axis=0)(xq)
        got = H.pchip_interpolate(x, jnp.asarray(y, jnp.float32), xq, axis=0)
        close(got, ref, 2e-5, "pchip")

    def test_linear(self, close):
        x = np.linspace(0, 1, 20)
        y = rng.standard_normal((20, 3))
        xq = np.linspace(0, 1, 77)
        ref = np.stack([np.interp(xq, x, y[:, i]) for i in range(3)], axis=1)
        got = H.linear_interpolate(x, jnp.asarray(y, jnp.float32), xq, axis=0)
        close(got, ref, 2e-5, "linear")


class TestSmoothing:
    def test_fractional_octave_smoothing(self, ref, close):
        from dsptoolbox.helpers.smoothing import _fractional_octave_smoothing

        vec = np.abs(rng.standard_normal((513, 2))) + 0.1
        expected = _fractional_octave_smoothing(vec.copy(), None, 3)
        got = H.fractional_octave_smoothing(jnp.asarray(vec, jnp.float32), None, 3)
        close(got, expected, 5e-5, "foct_smoothing")

    def test_time_smoothing_single(self, ref, close):
        from dsptoolbox.helpers.smoothing import _time_smoothing

        x = np.abs(rng.standard_normal((2000, 2)))
        expected = _time_smoothing(x.copy(), 4000, 0.05)
        got = H.time_smoothing(jnp.asarray(x.T, jnp.float32), 4000, 0.05)
        close(np.asarray(got).T, expected, 2e-4, "ema")

    def test_time_smoothing_attack_release(self, ref, close):
        from dsptoolbox.helpers.smoothing import _time_smoothing

        x = np.abs(rng.standard_normal((500, 2)))
        expected = _time_smoothing(x.copy(), 4000, 0.05, 0.2)
        got = H.time_smoothing(jnp.asarray(x.T, jnp.float32), 4000, 0.05, 0.2)
        close(np.asarray(got).T, expected, 2e-4, "ema_ar")


class TestMinimumPhase:
    def test_min_phase_ir(self, ref, close):
        from dsptoolbox.helpers.minimum_phase import (
            _min_phase_ir_from_real_cepstrum,
        )

        x = rng.standard_normal((256, 2))
        x[:20] = 0
        expected = _min_phase_ir_from_real_cepstrum(x.copy(), 2)
        got = H.min_phase_ir_from_real_cepstrum(
            jnp.asarray(x.T, jnp.float32), 2
        )
        close(np.asarray(got).T, expected, 1e-4, "min_phase_ir")


class TestLatency:
    def test_fractional_latency(self, ref):
        from dsptoolbox.helpers.latency import _fractional_latency

        T = 2000
        x = np.zeros((T, 1))
        x[100] = 1.0
        x[101] = 0.5
        y = np.zeros((T, 1))
        y[400] = 1.0
        y[401] = 0.5
        expected = _fractional_latency(y, x, 1)
        got = H.fractional_latency(y, x, 1)
        np.testing.assert_allclose(got, expected, atol=1e-3)


class TestGainLevel:
    def test_to_db_from_db(self, ref, close):
        from dsptoolbox.helpers.gain_and_level import to_db as ref_to_db

        x = np.abs(rng.standard_normal(100)) + 1e-3
        close(H.to_db(jnp.asarray(x, jnp.float32), True), ref_to_db(x, True), 1e-5)
        close(
            H.to_db(jnp.asarray(x, jnp.float32), False, 30),
            ref_to_db(x, False, 30),
            1e-5,
        )

    def test_db_conversion_location_dispatch(self, ref):
        # contract: host inputs stay numpy (f64, matching the reference's
        # own dtype), device inputs stay device arrays — host decision
        # logic must never pay a device round trip for dB math
        from dsptoolbox.helpers.gain_and_level import (
            from_db as ref_from_db,
            to_db as ref_to_db,
        )

        x = np.abs(rng.standard_normal(64)) + 1e-3
        out_host = H.to_db(x, True)
        assert isinstance(out_host, np.ndarray)
        assert not isinstance(out_host, jnp.ndarray)
        np.testing.assert_allclose(out_host, ref_to_db(x, True), rtol=1e-12)
        np.testing.assert_allclose(
            H.from_db(-6.0, True), ref_from_db(-6.0, True), rtol=1e-12
        )
        out_dev = H.to_db(jnp.asarray(x, jnp.float32), True)
        assert isinstance(out_dev, jnp.ndarray)
        assert not isinstance(out_dev, np.ndarray)
        # dynamic-range floor agrees across locations
        np.testing.assert_allclose(
            np.asarray(H.to_db(jnp.asarray(x, jnp.float32), True, 20)),
            H.to_db(x, True, 20),
            rtol=1e-5,
        )

    def test_normalize(self, ref, close):
        from dsptoolbox.helpers.gain_and_level import _normalize

        x = rng.standard_normal((400, 2)) * 3
        for peak in (True, False):
            for per_ch in (True, False):
                expected = _normalize(x.copy(), -6, peak, per_ch)
                got = H.normalize(
                    jnp.asarray(x.T, jnp.float32), -6, peak, per_ch
                )
                close(np.asarray(got).T, expected, 2e-5, f"norm_{peak}_{per_ch}")

    def test_fade(self, ref, close):
        from dsptoolbox.helpers.gain_and_level import _fade
        from dsptoolbox_jax.standard.enums import FadeType as MyFade
        from dsptoolbox.standard.enums import FadeType as RefFade

        x = rng.standard_normal((1000, 2))
        for mine, theirs in [
            (MyFade.Linear, RefFade.Linear),
            (MyFade.Exponential, RefFade.Exponential),
            (MyFade.Logarithmic, RefFade.Logarithmic),
        ]:
            expected = _fade(x.copy(), 0.01, theirs, 16000, True)
            got = H.fade(jnp.asarray(x.T, jnp.float32), 0.01, mine, 16000, True)
            close(np.asarray(got).T, expected, 2e-5, str(mine))


class TestSpectrumUtilities:
    def test_scale_spectrum(self, ref, close):
        from dsptoolbox.helpers.spectrum_utilities import _scale_spectrum
        from dsptoolbox.standard.enums import SpectrumScaling as RefScaling
        from dsptoolbox_jax.standard.enums import SpectrumScaling as MyScaling

        T = 512
        x = rng.standard_normal((T, 2))
        sp = np.fft.rfft(x, axis=0)
        for name in [
            "AmplitudeSpectrum",
            "AmplitudeSpectralDensity",
            "PowerSpectrum",
            "PowerSpectralDensity",
        ]:
            expected = _scale_spectrum(
                sp.copy(), getattr(RefScaling, name), T, 48000, None
            )
            got = H.scale_spectrum(
                jnp.asarray(sp.copy(), jnp.complex64),
                getattr(MyScaling, name),
                T,
                48000,
                None,
            )
            close(np.abs(np.asarray(got)), np.abs(expected), 5e-5, name)

    def test_interpolate_fr(self, ref, close):
        from dsptoolbox.helpers.spectrum_utilities import _interpolate_fr

        f_in = np.linspace(0, 24000, 257)
        fr = np.abs(rng.standard_normal((257, 2))) + 0.2
        f_t = np.linspace(100, 20000, 301)
        for scheme in ("linear", "cubic"):
            expected = _interpolate_fr(f_in, fr.copy(), f_t, None, scheme)
            got = H.interpolate_fr(
                f_in, jnp.asarray(fr, jnp.float32), f_t, None, scheme
            )
            close(got, expected, 5e-5, scheme)

    def test_wrap_phase(self, close):
        ph = rng.uniform(-20, 20, (64, 2))
        expected = (ph + np.pi) % (2 * np.pi) - np.pi
        close(H.wrap_phase(jnp.asarray(ph, jnp.float32)), expected, 1e-5)


class TestAR:
    def test_yule_walker(self, ref, close):
        from dsptoolbox.helpers.ar_estimation import _yw_ar_estimation

        x = rng.standard_normal((1024, 2))
        coeff_ref, err_ref = _yw_ar_estimation(x, 8)
        coeff, err = H.yule_walker_ar(jnp.asarray(x, jnp.float32), 8)
        close(coeff, coeff_ref, 1e-3, "yw_coeff")
        close(err, err_ref, 1e-3, "yw_err")

    def test_burg(self, ref, close):
        from dsptoolbox.helpers.ar_estimation import _burg_ar_estimation

        x = rng.standard_normal((1024, 2))
        coeff_ref, err_ref = _burg_ar_estimation(x, 6)
        coeff, err = H.burg_ar(jnp.asarray(x, jnp.float32), 6)
        # reference quirk: its 2D output is allocated (T+1, C) with only the
        # first order+1 rows populated (`helpers/ar_estimation.py:166-171`)
        close(coeff, coeff_ref[:7], 1e-3, "burg_coeff")
        close(err, err_ref, 1e-3, "burg_err")


class TestFrequency:
    def test_weighting(self, ref, close):
        from dsptoolbox.helpers.frequency_conversion import (
            _frequency_weightning,
        )

        f = np.linspace(20, 20000, 400)
        for m in ("a", "c"):
            close(
                H.frequency_weighting(f, m, True),
                _frequency_weightning(f, m, True),
                1e-6,
                m,
            )

    def test_mel(self, ref):
        from dsptoolbox.helpers.frequency_conversion import _hz2mel, _mel2hz

        f = np.linspace(20, 20000, 50)
        np.testing.assert_allclose(H.hz2mel(f), _hz2mel(f))
        np.testing.assert_allclose(H.mel2hz(_hz2mel(f)), _mel2hz(_hz2mel(f)))


class TestPolyphase:
    def test_roundtrip(self, ref, close):
        from dsptoolbox.helpers.polyphase import (
            _polyphase_decomposition,
            _polyphase_reconstruction,
        )

        x = rng.standard_normal((1001, 2))
        ref_poly, ref_pad = _polyphase_decomposition(x, 4)
        poly, pad = H.polyphase_decomposition(jnp.asarray(x, jnp.float32), 4)
        assert pad == ref_pad
        close(poly, ref_poly, 1e-6, "poly")
        close(
            H.polyphase_reconstruction(poly),
            _polyphase_reconstruction(ref_poly),
            1e-6,
            "recon",
        )


class TestHelpersReviewRegressions:
    def test_fractional_latency_channel_order_matches_reference(self, ref):
        """The reference's 2-D correlate reverses the channel order for
        3+ channels (parity quirk, reproduced)."""
        from dsptoolbox.helpers.latency import _fractional_latency

        from dsptoolbox_jax.helpers.latency import fractional_latency

        rng = np.random.default_rng(51)
        T = 2048
        base = rng.standard_normal(T)
        td = np.zeros((T, 3))
        td[:, 0] = base
        td[3:, 1] = base[:-3]
        td[7:, 2] = base[:-7]
        np.testing.assert_allclose(
            fractional_latency(td, None, 1),
            _fractional_latency(td, None, 1),
            atol=1e-3,
        )

    def test_power_scaled_spectra_not_smoothed(self, ref):
        """Reference parity: its power-smoothing branch is dead code."""
        from dsptoolbox.helpers.spectrum_utilities import (
            _get_normalized_spectrum,
        )

        from dsptoolbox_jax.helpers.spectrum_utilities import (
            get_normalized_spectrum,
        )
        from dsptoolbox_jax.standard.enums import MagnitudeNormalization

        rng = np.random.default_rng(52)
        f = np.linspace(10.0, 24000.0, 512)
        sp = np.abs(rng.standard_normal((512, 2))) + 0.1
        f_m, mag_m = get_normalized_spectrum(
            f, sp, False, None,
            MagnitudeNormalization.NoNormalization, 3, False, False,
        )
        f_r, mag_r = _get_normalized_spectrum(
            f, sp, False, None,
            ref.MagnitudeNormalization.NoNormalization, 3, False, False,
        )
        np.testing.assert_allclose(np.asarray(mag_m), mag_r, atol=1e-6)
