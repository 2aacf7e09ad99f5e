"""Class-layer tests vs the reference oracle on example_data."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import signal as ss

import dsptoolbox_jax as dsp

EXAMPLE = "/root/reference/example_data"


class TestSignal:
    def test_load_wav_matches_reference(self, ref, close):
        mine = dsp.Signal(f"{EXAMPLE}/chirp.wav")
        theirs = ref.Signal(f"{EXAMPLE}/chirp.wav")
        assert mine.sampling_rate_hz == theirs.sampling_rate_hz
        close(mine.time_data, theirs.time_data, 1e-6, "wav load")

    def test_time_data_conventions(self):
        # 1D input becomes (T, 1); transposed input gets fixed
        s = dsp.Signal(None, np.zeros(100), 2000)
        assert s.time_data.shape == (100, 1)
        s = dsp.Signal(None, np.zeros((2, 100)), 2000)
        assert s.time_data.shape == (100, 2)

    def test_constrain_amplitude(self):
        with pytest.warns(UserWarning):
            s = dsp.Signal(
                None, np.ones(100) * 2.0, 1000, constrain_amplitude=True
            )
        assert np.max(np.abs(s.time_data)) <= 1.0
        assert np.isclose(s.amplitude_scale_factor, 0.5)

    def test_spectrum_fft_vs_reference(self, ref, close):
        mine = dsp.Signal(f"{EXAMPLE}/chirp.wav")
        theirs = ref.Signal(f"{EXAMPLE}/chirp.wav")
        mine.spectrum_method = dsp.SpectrumMethod.FFT
        theirs.spectrum_method = ref.SpectrumMethod.FFT
        f1, sp1 = mine.get_spectrum()
        f2, sp2 = theirs.get_spectrum()
        np.testing.assert_allclose(f1, f2)
        close(sp1, sp2, 2e-5, "fft spectrum")

    def test_spectrum_welch_vs_reference(self, ref, close):
        mine = dsp.Signal(f"{EXAMPLE}/speech.flac") if False else dsp.Signal(
            f"{EXAMPLE}/chirp_stereo.wav"
        )
        theirs = ref.Signal(f"{EXAMPLE}/chirp_stereo.wav")
        f1, sp1 = mine.get_spectrum()
        f2, sp2 = theirs.get_spectrum()
        close(sp1, sp2, 2e-5, "welch spectrum")

    def test_csm_vs_reference(self, ref, close):
        mine = dsp.Signal(f"{EXAMPLE}/chirp_stereo.wav")
        theirs = ref.Signal(f"{EXAMPLE}/chirp_stereo.wav")
        f1, csm1 = mine.get_csm()
        f2, csm2 = theirs.get_csm()
        close(np.abs(np.asarray(csm1)), np.abs(csm2), 5e-5, "csm")

    def test_spectrogram_vs_reference(self, ref, close):
        mine = dsp.Signal(f"{EXAMPLE}/chirp.wav")
        theirs = ref.Signal(f"{EXAMPLE}/chirp.wav")
        t1, f1, S1 = mine.get_spectrogram()
        t2, f2, S2 = theirs.get_spectrogram()
        assert S1.shape == S2.shape
        close(np.abs(np.asarray(S1)), np.abs(S2), 2e-5, "stft")

    def test_channel_ops(self):
        s = dsp.Signal(None, np.random.randn(100, 3), 8000)
        s2 = s.get_channels([0, 2])
        assert s2.number_of_channels == 2
        s3 = s.copy()
        s3.remove_channel(1)
        assert s3.number_of_channels == 2
        s4 = s.copy().swap_channels([2, 1, 0])
        np.testing.assert_allclose(
            s4.time_data[:, 0], s.time_data[:, 2]
        )
        s5 = s.sum_channels()
        np.testing.assert_allclose(
            s5.time_data[:, 0], s.time_data.sum(axis=1), rtol=1e-5
        )


class TestFilter:
    def test_iir_filter_signal_vs_reference(self, ref, close):
        noise = np.random.default_rng(1).standard_normal((4000, 2)) * 0.3
        mine_s = dsp.Signal(None, noise, 16000)
        ref_s = ref.Signal(None, noise.copy(), 16000)
        mine_f = dsp.Filter.iir_filter(
            6, 1000.0, dsp.FilterPassType.Lowpass, 16000
        )
        ref_f = ref.Filter.iir_filter(
            6,
            1000.0,
            ref.FilterPassType.Lowpass,
            16000,
        )
        out1 = mine_f.filter_signal(mine_s)
        out2 = ref_f.filter_signal(ref_s)
        close(out1.time_data, out2.time_data, 2e-5, "iir filter_signal")

    def test_fir_filter_signal_vs_reference(self, ref, close):
        noise = np.random.default_rng(2).standard_normal((4000, 2)) * 0.3
        mine_s = dsp.Signal(None, noise, 16000)
        ref_s = ref.Signal(None, noise.copy(), 16000)
        mine_f = dsp.Filter.fir_filter(
            64, 2000.0, dsp.FilterPassType.Highpass, 16000
        )
        ref_f = ref.Filter.fir_filter(
            64, 2000.0, ref.FilterPassType.Highpass, 16000
        )
        out1 = mine_f.filter_signal(mine_s)
        out2 = ref_f.filter_signal(ref_s)
        close(out1.time_data, out2.time_data, 2e-5, "fir filter_signal")

    def test_biquad_coefficients_match(self, ref):
        for eq, eq_r in [
            ("Peaking", "Peaking"),
            ("Lowpass", "Lowpass"),
            ("Highshelf", "Highshelf"),
            ("Notch", "Notch"),
        ]:
            mine = dsp.Filter.biquad(
                getattr(dsp.BiquadEqType, eq), 1000, 3.0, 0.7, 48000
            )
            theirs = ref.Filter.biquad(
                getattr(ref.BiquadEqType, eq_r), 1000, 3.0, 0.7, 48000
            )
            np.testing.assert_allclose(
                mine.ba[0], theirs.ba[0], rtol=1e-12, err_msg=eq
            )
            np.testing.assert_allclose(mine.ba[1], theirs.ba[1], rtol=1e-12)

    def test_zero_phase(self, ref, close):
        noise = np.random.default_rng(3).standard_normal((4000, 1)) * 0.3
        mine_s = dsp.Signal(None, noise, 16000)
        ref_s = ref.Signal(None, noise.copy(), 16000)
        mine_f = dsp.Filter.iir_filter(
            4, 2000.0, dsp.FilterPassType.Lowpass, 16000
        )
        ref_f = ref.Filter.iir_filter(
            4, 2000.0, ref.FilterPassType.Lowpass, 16000
        )
        out1 = mine_f.filter_signal(mine_s, zero_phase=True)
        out2 = ref_f.filter_signal(ref_s, zero_phase=True)
        close(out1.time_data, out2.time_data, 2e-5, "zero phase")

    def test_get_ir_and_tf(self, ref, close):
        mine_f = dsp.Filter.iir_filter(
            4, [500.0, 2000.0], dsp.FilterPassType.Bandpass, 16000
        )
        ref_f = ref.Filter.iir_filter(
            4, [500.0, 2000.0], ref.FilterPassType.Bandpass, 16000
        )
        close(
            mine_f.get_ir(512).time_data,
            ref_f.get_ir(512).time_data,
            2e-5,
            "filter ir",
        )
        fvec = np.linspace(10, 7999, 200)
        np.testing.assert_allclose(
            mine_f.get_transfer_function(fvec),
            ref_f.get_transfer_function(fvec),
            rtol=1e-8,
        )

    def test_filter_and_resample(self, ref, close):
        noise = np.random.default_rng(4).standard_normal((4000, 1)) * 0.3
        mine_s = dsp.Signal(None, noise, 16000)
        ref_s = ref.Signal(None, noise.copy(), 16000)
        mine_f = dsp.Filter.fir_filter(
            64, 3000.0, dsp.FilterPassType.Lowpass, 16000
        )
        ref_f = ref.Filter.fir_filter(
            64, 3000.0, ref.FilterPassType.Lowpass, 16000
        )
        out1 = mine_f.filter_and_resample_signal(mine_s, 8000)
        out2 = ref_f.filter_and_resample_signal(ref_s, 8000)
        assert out1.sampling_rate_hz == out2.sampling_rate_hz
        close(out1.time_data, out2.time_data, 2e-5, "decimate")


class TestSpectrumClass:
    def test_interpolation_matches_reference(self, ref, close):
        f = np.linspace(0, 8000, 257)
        data = np.abs(np.random.default_rng(5).standard_normal((257, 2))) + 0.1
        mine = dsp.Spectrum(f, data)
        theirs = ref.Spectrum(f, data.copy())
        fq = np.linspace(100, 7500, 300)
        m = mine.get_interpolated_spectrum(fq, dsp.SpectrumType.Magnitude)
        t = theirs.get_interpolated_spectrum(fq, ref.SpectrumType.Magnitude)
        close(m, t, 5e-5, "interp magnitude")

    def test_to_signal_roundtrip(self, close):
        td = np.random.default_rng(6).standard_normal(512) * 0.2
        sp = np.fft.rfft(td)
        spec = dsp.Spectrum(np.fft.rfftfreq(512, 1 / 8000), sp)
        sig = spec.to_signal(8000)
        close(sig.time_data[:, 0], td, 1e-5, "irfft roundtrip")

    def test_energy(self, ref, close):
        f = np.linspace(0, 4000, 129)
        data = np.abs(np.random.default_rng(7).standard_normal((129, 1))) + 0.1
        mine = dsp.Spectrum(f, data)
        theirs = ref.Spectrum(f, data.copy())
        close(
            np.asarray(mine.get_energy()),
            theirs.get_energy(),
            1e-5,
            "energy",
        )


class TestMultiBandSignal:
    def test_collapse_and_bands(self):
        s1 = dsp.Signal(None, np.random.randn(500, 2) * 0.1, 8000)
        s2 = dsp.Signal(None, np.random.randn(500, 2) * 0.1, 8000)
        mb = dsp.MultiBandSignal([s1, s2])
        assert mb.number_of_bands == 2
        total = mb.collapse()
        np.testing.assert_allclose(
            total.time_data,
            s1.time_data + s2.time_data,
            atol=1e-6,
        )
        td, fs = mb.get_all_time_data()
        assert td.shape == (500, 2, 2)


class TestCalibration:
    def test_calibration_factor(self, ref, close):
        fs = 48000
        t = np.arange(fs) / fs
        tone = np.sin(2 * np.pi * 1000 * t) * 0.5
        mine = dsp.CalibrationData((tone, fs))
        theirs = ref.CalibrationData((tone.copy(), fs))
        noise = np.random.default_rng(8).standard_normal((fs, 1)) * 0.1
        m_sig = dsp.Signal(None, noise, fs)
        r_sig = ref.Signal(None, noise.copy(), fs)
        m_out = mine.calibrate_signal(m_sig)
        r_out = theirs.calibrate_signal(r_sig)
        close(m_out.time_data, r_out.time_data, 2e-5, "calibration")


class TestStreamingParity:
    """The reference's oracle pattern: partitioned streaming convolution vs
    scipy oaconvolve (`tests/test_classes.py:1538-1556`)."""

    @pytest.mark.parametrize("blocksize", [64, 128])
    def test_partitioned_fir_vs_oaconvolve(self, blocksize, close):
        rng = np.random.default_rng(9)
        fir = rng.standard_normal(300)
        x = rng.standard_normal(1024)
        from dsptoolbox_jax.realtime import FIRUniformPartitioned

        f = FIRUniformPartitioned(fir)
        f.prepare(blocksize, 1)
        out = np.zeros(1024)
        for n in range(1024 // blocksize):
            out[n * blocksize : (n + 1) * blocksize] = f.process_block(
                x[n * blocksize : (n + 1) * blocksize], 0
            )
        expected = ss.oaconvolve(x, fir)[:1024]
        close(out, expected, 1e-4, "partitioned streaming")

    def test_overlap_save_vs_oaconvolve(self, close):
        rng = np.random.default_rng(10)
        fir = rng.standard_normal(150)
        x = rng.standard_normal(1024)
        from dsptoolbox_jax.realtime import FIRFilterOverlapSave

        f = FIRFilterOverlapSave(fir)
        f.prepare(128, 1)
        out = np.zeros(1024)
        for n in range(8):
            out[n * 128 : (n + 1) * 128] = f.process_block(
                x[n * 128 : (n + 1) * 128], 0
            )
        expected = ss.oaconvolve(x, fir)[:1024]
        close(out, expected, 1e-4, "overlap save")

    def test_iir_realtime_matches_offline(self, close):
        rng = np.random.default_rng(11)
        b, a = ss.butter(3, 0.2)
        x = rng.standard_normal(256)
        from dsptoolbox_jax.realtime import IIRFilter

        f = IIRFilter(b.copy(), a.copy())
        out = np.array([f.process_sample(xi, 0) for xi in x])
        expected = ss.lfilter(b, a, x)
        close(out, expected, 1e-6, "iir per-sample")

    def test_svf_filter_signal(self):
        from dsptoolbox_jax.realtime import StateVariableFilter

        svf = StateVariableFilter(1000.0, 1.0, 16000)
        s = dsp.Signal(None, np.random.randn(512, 2) * 0.2, 16000)
        mb = svf.filter_signal(s)
        assert mb.number_of_bands == 4
        # per-sample matches vectorized path
        svf2 = StateVariableFilter(1000.0, 1.0, 16000)
        svf2.set_n_channels(1)
        outs = np.array(
            [svf2.process_sample(x, 0) for x in s.time_data[:64, 0]]
        )
        np.testing.assert_allclose(
            outs[:, 0],
            mb.bands[0].time_data[:64, 0],
            atol=1e-5,
        )


class TestSpectrumDeep:
    F = np.linspace(10, 4000, 400)

    def _pair(self, ref, complex_data=False):
        rng = np.random.default_rng(4)
        mag = 0.5 + np.abs(rng.standard_normal((400, 2)))
        if complex_data:
            mag = mag * np.exp(1j * rng.uniform(-np.pi, np.pi, (400, 2)))
        return (
            dsp.Spectrum(self.F, mag),
            ref.Spectrum(self.F.copy(), mag.copy()),
        )

    @pytest.mark.parametrize(
        "scheme", ["Linear", "Cubic", "Pchip"]
    )
    def test_interpolation_schemes(self, ref, scheme):
        m, r = self._pair(ref)
        fq = np.linspace(50, 3500, 173)
        m.set_interpolator_parameters(
            scheme=getattr(dsp.InterpolationScheme, scheme)
        )
        r.set_interpolator_parameters(
            scheme=getattr(ref.InterpolationScheme, scheme)
        )
        a = np.asarray(
            m.get_interpolated_spectrum(fq, dsp.SpectrumType.Magnitude)
        )
        b = np.asarray(
            r.get_interpolated_spectrum(fq, ref.SpectrumType.Magnitude)
        )
        np.testing.assert_allclose(a, b, rtol=2e-4, err_msg=scheme)

    def test_resample_trim_normalize(self, ref):
        m, r = self._pair(ref)
        fq = np.linspace(100, 3000, 97)
        m2 = m.resample(fq)
        r2 = r.resample(fq)
        np.testing.assert_allclose(
            np.asarray(m2.spectral_data), r2.spectral_data, rtol=2e-4
        )
        m3 = m.trim(200, 2500)
        r3 = r.trim(200, 2500)
        np.testing.assert_allclose(
            m3.frequency_vector_hz, r3.frequency_vector_hz
        )

    def test_energy_and_gain(self, ref):
        m, r = self._pair(ref)
        np.testing.assert_allclose(
            np.asarray(m.get_energy()), r.get_energy(), rtol=1e-4
        )
        m.apply_octave_smoothing(3.0)
        r.apply_octave_smoothing(3.0)
        np.testing.assert_allclose(
            np.asarray(m.spectral_data), r.spectral_data, rtol=5e-3
        )

    def test_to_signal_roundtrip(self, ref):
        # complex spectrum from an FFT of a short signal
        rng = np.random.default_rng(5)
        td = rng.standard_normal((256, 1)) * 0.2
        s_m = dsp.Signal(None, td, 8000)
        s_r = ref.Signal(None, td.copy(), 8000)
        freqs = np.fft.rfftfreq(256, 1 / 8000)
        data = np.fft.rfft(td, axis=0)
        sp_m = dsp.Spectrum(freqs, data)
        sp_r = ref.Spectrum(freqs.copy(), data.copy())
        back_m = sp_m.to_signal(s_m.sampling_rate_hz)
        back_r = sp_r.to_signal(s_r.sampling_rate_hz)
        np.testing.assert_allclose(
            back_m.time_data, back_r.time_data, atol=1e-5
        )


class TestMultiBandSignalDeep:
    def test_band_operations(self):
        rng = np.random.default_rng(6)
        bands = [
            dsp.Signal(None, rng.standard_normal((512, 2)) * 0.2, 8000)
            for _ in range(3)
        ]
        mb = dsp.MultiBandSignal(bands[:2])
        mb.add_band(bands[2])
        assert mb.number_of_bands == 3
        mb.swap_bands([2, 1, 0])
        np.testing.assert_allclose(
            mb.bands[0].time_data, bands[2].time_data
        )
        mb.remove_band(1)
        assert mb.number_of_bands == 2

    def test_collapse_sums_bands(self, ref):
        rng = np.random.default_rng(7)
        tds = [rng.standard_normal((512, 1)) * 0.2 for _ in range(3)]
        mb_m = dsp.MultiBandSignal(
            [dsp.Signal(None, td, 8000) for td in tds]
        )
        mb_r = ref.MultiBandSignal(
            [ref.Signal(None, td.copy(), 8000) for td in tds]
        )
        c_m = mb_m.collapse()
        c_r = mb_r.collapse()
        np.testing.assert_allclose(
            c_m.time_data, c_r.time_data, atol=1e-6
        )

    def test_get_all_time_data(self, ref):
        rng = np.random.default_rng(8)
        tds = [rng.standard_normal((256, 2)) * 0.2 for _ in range(2)]
        mb_m = dsp.MultiBandSignal(
            [dsp.Signal(None, td, 8000) for td in tds]
        )
        mb_r = ref.MultiBandSignal(
            [ref.Signal(None, td.copy(), 8000) for td in tds]
        )
        a = mb_m.get_all_time_data()
        b = mb_r.get_all_time_data()
        np.testing.assert_allclose(
            np.asarray(a[0]), np.asarray(b[0]), atol=1e-7
        )


class TestSignalCaching:
    def test_cache_returns_copies_and_invalidates(self):
        rng = np.random.default_rng(11)
        s = dsp.Signal(None, rng.standard_normal((4096, 1)) * 0.3, 8000)
        s.activate_cache = True
        f1, sp1 = s.get_spectrum()
        f2, sp2 = s.get_spectrum()
        np.testing.assert_array_equal(np.asarray(sp1), np.asarray(sp2))
        # mutating the returned copy must not poison the cache
        np.asarray(sp1)  # no-op; returned arrays are copies by contract

        # changing spectrum parameters invalidates the spectrum cache
        s.set_spectrum_parameters(window_length_samples=512)
        f3, sp3 = s.get_spectrum()
        assert np.asarray(sp3).shape != np.asarray(sp1).shape or not (
            np.array_equal(np.asarray(sp3), np.asarray(sp1))
        )

        # changing time data invalidates everything
        _, _, S1 = s.get_spectrogram()
        s.time_data = rng.standard_normal((4096, 1)) * 0.3
        f4, sp4 = s.get_spectrum()
        assert not np.array_equal(np.asarray(sp4), np.asarray(sp3))
        _, _, S2 = s.get_spectrogram()
        assert not np.array_equal(np.asarray(S1), np.asarray(S2))

    def test_cache_disabled(self):
        rng = np.random.default_rng(12)
        s = dsp.Signal(None, rng.standard_normal((2048, 1)) * 0.3, 8000)
        s.activate_cache = False
        s.get_spectrum()
        assert "spectrum" not in s._cache


class TestAppendSpectra:
    def test_append(self, ref):
        freqs = np.linspace(10, 4000, 128)
        rng = np.random.default_rng(13)
        a = rng.uniform(0.1, 1.0, (128, 1))
        b = rng.uniform(0.1, 1.0, (128, 1))
        sp_m = dsp.append_spectra(
            [dsp.Spectrum(freqs, a), dsp.Spectrum(freqs, b)]
        )
        sp_r = ref.append_spectra(
            [ref.Spectrum(freqs.copy(), a.copy()),
             ref.Spectrum(freqs.copy(), b.copy())]
        )
        np.testing.assert_allclose(
            np.asarray(sp_m.spectral_data), sp_r.spectral_data,
            atol=1e-6,
        )


class TestPersistence:
    def test_signal_pkl_roundtrip(self, tmp_path):
        rng = np.random.default_rng(14)
        s = dsp.Signal(None, rng.standard_normal((512, 2)) * 0.2, 8000)
        s.save_signal(str(tmp_path / "s"), mode="pkl")
        s2 = dsp.load_pkl_object(str(tmp_path / "s.pkl"))
        np.testing.assert_array_equal(s2.time_data, s.time_data)
        assert s2.sampling_rate_hz == s.sampling_rate_hz

    def test_filterbank_pkl_roundtrip(self, tmp_path):
        fb = dsp.filterbanks.linkwitz_riley_crossovers(
            [500], order=4, sampling_rate_hz=8000
        )
        fb.save_filterbank(str(tmp_path / "fb"))
        fb2 = dsp.load_pkl_object(str(tmp_path / "fb.pkl"))
        assert fb2.number_of_bands == fb.number_of_bands
        rng = np.random.default_rng(15)
        s = dsp.Signal(None, rng.standard_normal((512, 1)) * 0.2, 8000)
        out1 = fb.filter_signal(s, dsp.FilterBankMode.Summed)
        out2 = fb2.filter_signal(s, dsp.FilterBankMode.Summed)
        np.testing.assert_allclose(
            out1.time_data, out2.time_data, atol=1e-7
        )

    def test_spectrum_pkl_roundtrip(self, tmp_path):
        freqs = np.linspace(10, 4000, 64)
        rng = np.random.default_rng(16)
        sp = dsp.Spectrum(freqs, rng.uniform(0.1, 1.0, (64, 1)))
        sp.save_spectrum(str(tmp_path / "sp"))
        sp2 = dsp.load_pkl_object(str(tmp_path / "sp.pkl"))
        np.testing.assert_allclose(
            np.asarray(sp2.spectral_data), np.asarray(sp.spectral_data)
        )


class TestDeviceResidentPaths:
    """The device-resident fast paths must match their host equivalents."""

    def test_device_time_data_setter_matches_host(self):
        import jax.numpy as jnp

        from dsptoolbox_jax.classes import Signal
        from dsptoolbox_jax.classes.signal import DeviceTimeData

        rng = np.random.default_rng(3)
        td = rng.standard_normal((1024, 2)) * 2.0  # over 0 dBFS
        with pytest.warns(UserWarning, match="0 dBFS"):
            s_host = Signal.from_time_data(td, 48000, constrain_amplitude=True)
        with pytest.warns(UserWarning, match="0 dBFS"):
            s_dev = Signal.from_time_data(
                jnp.asarray(td), 48000, constrain_amplitude=True
            )
        np.testing.assert_allclose(
            s_dev.time_data, s_host.time_data, rtol=1e-6
        )
        assert np.isclose(
            s_dev.amplitude_scale_factor, s_host.amplitude_scale_factor
        )
        # pair with precomputed peak
        with pytest.warns(UserWarning, match="0 dBFS"):
            s_pair = Signal.from_time_data(
                DeviceTimeData(
                    jnp.asarray(td), jnp.asarray(td * 0.5),
                    peak=float(np.max(np.abs(td))),
                ),
                48000,
                constrain_amplitude=True,
            )
        np.testing.assert_allclose(
            s_pair.time_data, s_host.time_data, rtol=1e-6
        )
        np.testing.assert_allclose(
            s_pair.time_data_imaginary, s_host.time_data * 0.5, rtol=1e-6
        )

    def test_get_spectrum_device_matches_host(self):
        from dsptoolbox_jax.classes import Signal

        rng = np.random.default_rng(4)
        s = Signal.from_time_data(
            rng.standard_normal((4096, 2)) * 0.4, 48000
        )
        from dsptoolbox_jax.standard.enums import SpectrumMethod

        # Welch default: real spectrum, no imaginary part
        f_host, sp_host = s.get_spectrum()
        f_dev, re, im = s._get_spectrum_device()
        np.testing.assert_allclose(f_dev, f_host)
        assert im is None
        np.testing.assert_allclose(
            np.asarray(re), np.asarray(sp_host), rtol=2e-5, atol=1e-6
        )
        # FFT method: complex spectrum
        s.spectrum_method = SpectrumMethod.FFT
        f_host, sp_host = s.get_spectrum()
        f_dev, re, im = s._get_spectrum_device()
        np.testing.assert_allclose(f_dev, f_host)
        got = np.asarray(re) + 1j * np.asarray(im)
        np.testing.assert_allclose(got, np.asarray(sp_host), rtol=2e-5,
                                   atol=1e-6)

    def test_get_csm_device_matches_host(self):
        from dsptoolbox_jax.classes import Signal

        rng = np.random.default_rng(5)
        s = Signal.from_time_data(
            rng.standard_normal((8192, 3)) * 0.4, 48000
        )
        f_host, csm_host = s.get_csm()
        f_dev, re, im = s._get_csm_device()
        np.testing.assert_allclose(f_dev, f_host)
        got = np.asarray(re) + 1j * np.asarray(im)
        np.testing.assert_allclose(
            got, np.asarray(csm_host), rtol=2e-4, atol=1e-5
        )


class TestClassesReviewRegressions:
    """Regressions from the round-1 classes code review (oracle-checked)."""

    def test_complex_signal_fft_spectrum_uses_real_part(self, ref):
        """Reference rfft's time_data (real part only) for complex
        signals (`classes/signal.py:906-911`)."""
        rng = np.random.default_rng(21)
        td = rng.standard_normal((1024, 2)) * 0.3
        ti = rng.standard_normal((1024, 2)) * 0.3

        r = ref.Signal(None, td, 48000)
        r.time_data_imaginary = ti
        r.spectrum_method = ref.SpectrumMethod.FFT
        f_r, sp_r = r.get_spectrum()

        from dsptoolbox_jax.classes import Signal
        from dsptoolbox_jax.standard.enums import SpectrumMethod

        s = Signal(None, td, 48000)
        s.time_data_imaginary = ti
        s.spectrum_method = SpectrumMethod.FFT
        f_m, sp_m = s.get_spectrum()
        np.testing.assert_allclose(f_m, f_r)
        np.testing.assert_allclose(
            np.asarray(sp_m), sp_r, rtol=2e-5, atol=1e-6
        )

    def test_initialize_zi_steady_state(self, ref):
        from scipy.signal import sosfilt_zi

        import dsptoolbox_jax as dsp

        f = dsp.Filter.iir_filter(
            4, 1000.0, type_of_pass=dsp.FilterPassType.Lowpass,
            sampling_rate_hz=48000,
        )
        f.initialize_zi(2)
        np.testing.assert_allclose(f.zi[0], sosfilt_zi(np.asarray(f.sos)))
        # streamed output matches the reference's steady-state start
        rng = np.random.default_rng(22)
        td = rng.standard_normal((2048, 2))
        td = td / np.abs(td).max() * 0.5
        s_m = dsp.Signal.from_time_data(td, 48000)
        out_m = f.filter_signal(s_m, activate_zi=True)

        f_r = ref.Filter.iir_filter(
            4, 1000.0, type_of_pass=ref.FilterPassType.Lowpass,
            sampling_rate_hz=48000,
        )
        f_r.initialize_zi(2)
        s_r = ref.Signal(None, td, 48000)
        out_r = f_r.filter_signal(s_r, activate_zi=True)
        np.testing.assert_allclose(
            out_m.time_data, out_r.time_data, rtol=1e-4, atol=1e-5
        )

    def test_filter_and_resample_length_matches_reference(self, ref):
        import dsptoolbox_jax as dsp

        rng = np.random.default_rng(23)
        td = rng.standard_normal((4800, 1))
        td = td / np.abs(td).max() * 0.5
        # FIR with half_length % down != 0: len(b)=12 -> half=5, down=2
        b = rng.standard_normal(12) * 0.1
        f_m = dsp.Filter.from_ba(b, [1.0], 48000)
        f_r = ref.Filter.from_ba(b, [1.0], 48000)
        s_m = dsp.Signal.from_time_data(td, 48000)
        s_r = ref.Signal(None, td, 48000)
        out_m = f_m.filter_and_resample_signal(s_m, 24000)
        out_r = f_r.filter_and_resample_signal(s_r, 24000)
        assert out_m.time_data.shape == out_r.time_data.shape
        np.testing.assert_allclose(
            out_m.time_data, out_r.time_data, rtol=1e-4, atol=1e-6
        )

    def test_spectrum_trim_exclusive_matches_reference(self, ref):
        import dsptoolbox_jax as dsp

        f = np.linspace(0.0, 1000.0, 101)
        data = np.abs(np.random.default_rng(24).standard_normal((101, 2)))
        sp_m = dsp.Spectrum(f, data.copy())
        sp_r = ref.Spectrum(f, data.copy())
        sp_m.trim(100.0, 800.0, inclusive=False)
        sp_r.trim(100.0, 800.0, inclusive=False)
        np.testing.assert_allclose(
            sp_m.frequency_vector_hz, sp_r.frequency_vector_hz
        )
        np.testing.assert_allclose(
            np.asarray(sp_m.spectral_data), sp_r.spectral_data
        )

    def test_remove_channel_negative_index(self):
        import dsptoolbox_jax as dsp

        rng = np.random.default_rng(25)
        td = rng.standard_normal((256, 3))
        td = td / np.abs(td).max() * 0.5
        s = dsp.Signal.from_time_data(td, 48000)
        s.remove_channel(-2)
        want = np.delete(td, -2, axis=1)
        np.testing.assert_allclose(s.time_data, want, rtol=1e-6)

    def test_get_channels_out_of_range_raises_index_error(self):
        # jax gather clamps out-of-range indices silently; the reference
        # indexes numpy and raises IndexError
        # (reference tests/test_classes.py:155)
        import pytest

        import dsptoolbox_jax as dsp

        rng = np.random.default_rng(26)
        td = rng.standard_normal((128, 2))
        td = td / np.abs(td).max() * 0.5
        s = dsp.Signal.from_time_data(td, 48000)
        with pytest.raises(IndexError):
            s.get_channels(12)
        with pytest.raises(IndexError):
            s.get_channels([0, -3])
        # valid negative index still works (numpy semantics)
        np.testing.assert_allclose(
            s.get_channels(-1).time_data[:, 0], td[:, 1], rtol=1e-6
        )
