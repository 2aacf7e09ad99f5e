"""Standard-module tests: semantic invariants mirroring the reference's
`tests/test_standard.py`."""

import numpy as np
import pytest

import dsptoolbox_jax as dsp

FS = 44100


@pytest.fixture(scope="module")
def audio_multi():
    return dsp.generators.noise(
        2, FS, number_of_channels=3, seed=7
    )


def _multiband(audio_multi):
    fb = dsp.filterbanks.linkwitz_riley_crossovers([1e3], [4], FS)
    return fb.filter_signal(audio_multi, dsp.FilterBankMode.Parallel)


class TestLatency:
    def test_integer_latency(self, audio_multi):
        td = audio_multi.time_data
        delay_samples = int(30e-3 * FS)
        td_del = np.zeros((td.shape[0] + delay_samples, 3))
        td_del[-td.shape[0]:] = td
        s = dsp.Signal(None, td_del, FS)
        vector, corr = dsp.latency(audio_multi, s)
        assert np.allclose(corr, 1.0)
        assert np.all(vector == -delay_samples)
        vector, corr = dsp.latency(s, audio_multi)
        assert np.all(vector == delay_samples)
        with pytest.raises(AssertionError):
            dsp.latency(s.get_channels(0), audio_multi)

    def test_fractional_latency(self):
        delay = 0.003301
        noi = dsp.generators.noise(
            length_seconds=1, sampling_rate_hz=10_000, seed=3
        )
        noi_del = dsp.fractional_delay(noi, delay)
        lat, corr = dsp.latency(noi_del, noi, 2)
        assert np.allclose(corr, 1.0, atol=1e-2)
        assert np.abs(lat[0] - delay * noi.sampling_rate_hz) < 0.9


class TestPadTrim:
    def test_trim_and_pad_both_ends(self, audio_multi):
        td = audio_multi.time_data[:40_000]
        out = dsp.pad_trim(audio_multi, 40_000)
        np.testing.assert_array_equal(out.time_data, td)

        padded = dsp.pad_trim(out, 50_000)
        np.testing.assert_array_equal(padded.time_data[40_000:], 0.0)

        td = audio_multi.time_data[-30_000:]
        out = dsp.pad_trim(audio_multi, 30_000, in_the_end=False)
        np.testing.assert_array_equal(out.time_data, td)

        padded = dsp.pad_trim(out, 40_000, in_the_end=False)
        np.testing.assert_array_equal(padded.time_data[:10_000], 0.0)

    def test_multiband(self, audio_multi):
        mb = dsp.MultiBandSignal(
            [audio_multi.get_channels(0), audio_multi.get_channels(1)]
        )
        out = dsp.pad_trim(mb, 40_000)
        assert len(out.bands[0]) == 40_000


class TestNormalize:
    def test_peak(self, audio_multi):
        n = dsp.normalize(audio_multi, norm_dbfs=-20)
        assert np.isclose(
            np.max(np.abs(n.time_data)), 10 ** (-20 / 20), atol=1e-5
        )

    def test_rms(self, audio_multi):
        ch = audio_multi.get_channels(0)
        rms_prev = dsp.rms(ch)[0]
        n = dsp.normalize(
            ch, norm_dbfs=rms_prev - 10, peak_normalization=False
        )
        assert np.isclose(rms_prev - 10, dsp.rms(n)[0], atol=1e-4)


class TestFade:
    def test_linear_fades(self, audio_multi):
        f_st = dsp.fade(
            audio_multi, fade_type=dsp.FadeType.Linear,
            at_start=True, at_end=False,
        )
        f_end = dsp.fade(
            audio_multi, fade_type=dsp.FadeType.Linear,
            at_start=False, at_end=True,
        )
        td = audio_multi.time_data.copy()
        fade_le = int(td.shape[0] * 2.5 / 100)
        exp = td.copy()
        exp[:fade_le] *= np.linspace(0, 1, fade_le)[..., None]
        np.testing.assert_allclose(
            f_st.time_data, exp, atol=1e-6
        )
        exp = td.copy()
        exp[-fade_le:] *= np.linspace(1, 0, fade_le)[..., None]
        np.testing.assert_allclose(
            f_end.time_data, exp, atol=1e-6
        )
        with pytest.raises(AssertionError):
            dsp.fade(
                audio_multi, fade_type=dsp.FadeType.Linear,
                at_start=False, at_end=False,
            )


class TestDelays:
    def test_fractional_delay_all_and_single(self, audio_multi):
        delay_s = 150 / FS
        s = dsp.fractional_delay(audio_multi, delay_s)
        lat = dsp.latency(s, audio_multi)[0]
        assert np.all(np.isclose(np.abs(lat), 150))
        s = dsp.fractional_delay(audio_multi, delay_s, channels=0)
        lat = dsp.latency(s, audio_multi)[0]
        assert np.all(np.isclose(np.abs(lat), [150, 0, 0]))

    def test_integer_delay(self, audio_multi):
        s = dsp.delay(audio_multi, 150)
        lat = dsp.latency(s, audio_multi)[0]
        assert np.all(np.isclose(np.abs(lat), 150))
        s = dsp.delay(audio_multi, 150, channels=0)
        lat = dsp.latency(s, audio_multi)[0]
        assert np.all(np.isclose(np.abs(lat), [150, 0, 0]))


class TestLevelMeasures:
    def test_rms(self, audio_multi):
        td = audio_multi.time_data[:, 0]
        rms_vals = dsp.rms(audio_multi, in_dbfs=False)
        assert np.isclose(
            np.sqrt(np.mean(td**2)), rms_vals[0], atol=1e-6
        )

    def test_lufs_sine(self):
        n = dsp.generators.oscillator(
            997, 48000, length_seconds=2.0, peak_level_dbfs=0.0,
            number_of_channels=1,
        )
        np.testing.assert_allclose(
            dsp.lufs_integrated(n), -3.01, atol=0.07
        )

    def test_true_peak_level(self, audio_multi):
        tp, _ = dsp.true_peak_level(audio_multi)
        assert np.asarray(tp).shape[-1] == 3

    def test_crest_factor(self, audio_multi):
        cf = dsp.crest_factor(audio_multi, True)
        assert np.all(np.asarray(cf) > 0.0)


class TestApplyGain:
    def test_signal(self, audio_multi):
        out = dsp.apply_gain(audio_multi, 5)
        np.testing.assert_allclose(
            out.time_data,
            audio_multi.time_data * dsp.tools.from_db(5, True),
            atol=1e-6,
        )
        gains = np.linspace(1, 5, 3)
        out = dsp.apply_gain(audio_multi, gains)
        np.testing.assert_allclose(
            out.time_data,
            audio_multi.time_data * dsp.tools.from_db(gains, True),
            atol=1e-6,
        )

    def test_filter(self, audio_multi):
        iir = dsp.Filter.biquad(
            dsp.BiquadEqType.Peaking, 500.0, 0.0, 0.7, FS
        )
        lvl1 = dsp.rms(iir.filter_signal(audio_multi))
        lvl2 = dsp.rms(
            dsp.apply_gain(iir, -5.0).filter_signal(audio_multi)
        )
        np.testing.assert_allclose(lvl1 - 5.0, lvl2, atol=1e-3)


class TestDetrend:
    def test_removes_offset(self):
        s = dsp.generators.oscillator(
            100, sampling_rate_hz=700, peak_level_dbfs=-20
        )
        s.time_data = s.time_data + 0.2
        out = dsp.detrend(s, polynomial_order=0)
        assert abs(np.mean(out.time_data)) < 1e-4
        with pytest.raises(AssertionError):
            dsp.detrend(s, polynomial_order=-10)


class TestModifySignalLength:
    def test_add_and_remove(self, audio_multi):
        new = dsp.modify_signal_length(audio_multi, 1.0, 1.0)
        assert np.isclose(
            new.length_seconds, audio_multi.length_seconds + 2.0
        )
        new = dsp.modify_signal_length(audio_multi, 1.0, None)
        np.testing.assert_array_equal(
            new.time_data[: new.sampling_rate_hz], 0.0
        )
        new = dsp.modify_signal_length(audio_multi, -0.5, -0.5)
        np.testing.assert_allclose(
            new.time_data,
            audio_multi.time_data[
                new.sampling_rate_hz // 2: -new.sampling_rate_hz // 2
            ],
        )
        with pytest.raises(AssertionError):
            dsp.modify_signal_length(audio_multi, None, None)


class TestMergeFilters:
    def test_fir_merge_delay(self):
        f1 = dsp.Filter.fir_filter(
            50, 100.0,
            type_of_pass=dsp.FilterPassType.Lowpass,
            window=dsp.Window.Hamming,
            sampling_rate_hz=FS,
        )
        dirac = np.zeros(30)
        dirac[-1] = 1.0
        f2 = dsp.Filter.from_ba(dirac, [1.0], FS)
        f3 = dsp.merge_filters([f1, f2])
        np.testing.assert_allclose(
            np.asarray(f3.ba[0][29:]), np.asarray(f1.ba[0]), atol=1e-7
        )
        with pytest.raises(AssertionError):
            dsp.merge_filters([f1])

    def test_iir_merge_sos(self):
        f1 = dsp.Filter.biquad(
            eq_type=dsp.BiquadEqType.Allpass,
            frequency_hz=500.0, gain_db=5.0, q=0.7,
            sampling_rate_hz=FS,
        )
        f3 = dsp.merge_filters([f1, f1.copy()])
        assert f3.sos.shape[0] == 2


class TestTrimWithLevelThreshold:
    def test_single_channel(self):
        s = np.zeros(1000)
        ones_slice = slice(1000 // 3, 1000 // 2)
        threshold_db = -50.0
        fill = dsp.tools.from_db(threshold_db + 1, True)
        s[ones_slice] = fill
        out = dsp.trim_with_level_threshold(
            dsp.Signal.from_time_data(s, FS), threshold_db, True, True
        )[0]
        # fill is f64 host math (from_db) while the signal stores the
        # package float: compare at the storage-dtype level
        np.testing.assert_allclose(
            out.time_data.squeeze(), s[ones_slice], rtol=1e-6
        )
        out = dsp.trim_with_level_threshold(
            dsp.Signal.from_time_data(s, FS), threshold_db, False, True
        )[0]
        np.testing.assert_allclose(
            out.time_data.squeeze(), s[: ones_slice.stop], atol=1e-9
        )
        with pytest.raises(AssertionError):
            dsp.trim_with_level_threshold(
                dsp.Signal.from_time_data(s, FS), threshold_db,
                False, False,
            )


class TestTrimWithTimeSelection:
    def test_basic(self, audio_multi):
        s2 = dsp.trim_with_time_selection(audio_multi, 0.1, 0.3, True)
        assert abs(s2.length_seconds - 0.2) <= 1 / FS
        with pytest.raises(AssertionError):
            dsp.trim_with_time_selection(audio_multi, 0.3, 0.1, False)


class TestMisc:
    def test_resample(self, audio_multi):
        out = dsp.resample(audio_multi, 22050)
        assert out.sampling_rate_hz == 22050

    def test_activity_detector(self):
        s = dsp.generators.oscillator(1000.0, sampling_rate_hz=FS)
        s = dsp.pad_trim(s, s.time_data.shape[0] * 2)
        dsp.activity_detector(s)

    def test_envelope(self):
        s = dsp.generators.oscillator(
            frequency_hz=500,
            mode=dsp.generators.WaveForm.Triangle,
            sampling_rate_hz=5_000,
            number_of_channels=3,
            uncorrelated=True,
        )
        env = dsp.envelope(s, False, 512)
        assert env.shape == s.time_data.shape
        env = dsp.envelope(s, True, None)
        assert env.shape == s.time_data.shape

    def test_dither(self, audio_multi):
        out = dsp.dither(audio_multi)
        assert out.time_data.shape == audio_multi.time_data.shape

    def test_calibration(self, audio_multi):
        sine = dsp.generators.oscillator(
            frequency_hz=100.0, sampling_rate_hz=FS,
            peak_level_dbfs=-20,
        )
        calib = dsp.CalibrationData(sine)
        out = calib.calibrate_signal(audio_multi)
        assert out.time_data.shape == audio_multi.time_data.shape

    def test_load_pkl_object(self, tmp_path, audio_multi):
        f = dsp.Filter.fir_filter(
            order=216, frequency_hz=1000,
            type_of_pass=dsp.FilterPassType.Highpass,
            sampling_rate_hz=FS,
        )
        f.save_filter(str(tmp_path / "f"))
        dsp.load_pkl_object(str(tmp_path / "f.pkl"))

    def test_resample_filter(self):
        f = dsp.Filter.iir_filter(
            order=5, frequency_hz=500,
            type_of_pass=dsp.FilterPassType.Lowpass,
            filter_design_method=dsp.IirDesignMethod.Bessel,
            sampling_rate_hz=48000,
        )
        out = dsp.resample_filter(f, 24000)
        assert out.sampling_rate_hz == 24000

    def test_append_signals(self, audio_multi):
        out = dsp.append_signals(
            [audio_multi.get_channels(0), audio_multi.get_channels(1)]
        )
        assert out.number_of_channels == 2

    def test_spectral_difference_identity(self):
        filt = dsp.Filter.biquad(
            dsp.BiquadEqType.Peaking, 500.0, 10.0, 1.0, 48000
        )
        freqs = dsp.tools.log_frequency_vector([20, 20e3], 128)
        spec = dsp.Spectrum.from_filter(freqs, filt, False)
        flat = dsp.Spectrum.from_filter(
            freqs,
            dsp.Filter.biquad(
                dsp.BiquadEqType.Peaking, 500.0, 0.0, 1.0, 48000
            ),
            False,
        )
        sp_out = dsp.spectral_difference(
            spec, flat, energy_normalization=False
        )
        np.testing.assert_allclose(
            np.asarray(spec.spectral_data),
            np.asarray(sp_out.spectral_data),
            atol=1e-4,
        )
