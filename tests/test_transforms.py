"""Transforms tests vs the reference oracle.

The reference's own suite (`tests/test_transforms.py`) uses speech.flac;
here deterministic WAV material (chirp/rir) feeds both frameworks so the
outputs can be compared numerically.
"""

import numpy as np
import pytest

import dsptoolbox_jax as dsp
from dsptoolbox_jax import transforms as tf

EXAMPLE = "/root/reference/example_data"
CHIRP = f"{EXAMPLE}/chirp_mono.wav"


@pytest.fixture
def chirp_pair(ref):
    s_m = dsp.Signal(CHIRP)
    s_r = ref.Signal(CHIRP)
    return dsp.pad_trim(s_m, 2**15), ref.pad_trim(s_r, 2**15)


class TestCepstrum:
    def test_roundtrip_and_oracle(self, ref, chirp_pair, close):
        s_m, s_r = chirp_pair
        cc_m = tf.cepstrum(s_m, True)
        cc_r = ref.transforms.cepstrum(s_r, True)
        close(np.asarray(cc_m), np.asarray(cc_r), 1e-3, "complex cepstrum")
        rec = tf.from_complex_cepstrum(cc_m, s_m.sampling_rate_hz)
        np.testing.assert_allclose(
            s_m.time_data, rec.time_data, atol=1e-4
        )

    def test_real_cepstrum_oracle(self, ref, chirp_pair, close):
        s_m, s_r = chirp_pair
        cc_m = tf.cepstrum(s_m, False)
        cc_r = ref.transforms.cepstrum(s_r, False)
        close(np.asarray(cc_m), np.asarray(cc_r), 1e-3, "real cepstrum")


class TestMel:
    def test_mel_filterbank_oracle(self, ref):
        f = np.linspace(0, 24000, 2048)
        for rng_hz, nb, norm in [
            (None, 30, False),
            ([1e3, 5e3], 10, False),
            (None, 30, True),
        ]:
            w_m, c_m = tf.mel_filterbank(f, rng_hz, n_bands=nb,
                                         normalize=norm)
            w_r, c_r = ref.transforms.mel_filterbank(
                f, rng_hz, n_bands=nb, normalize=norm
            )
            np.testing.assert_allclose(np.asarray(w_m), w_r, atol=1e-10)
            np.testing.assert_allclose(c_m, c_r, atol=1e-8)

    def test_log_mel_spectrogram_oracle(self, ref, chirp_pair, close):
        s_m, s_r = chirp_pair
        t_m, f_m, sp_m = tf.log_mel_spectrogram(
            s_m, range_hz=None, n_bands=40, generate_plot=False,
            stft_parameters=None,
        )
        t_r, f_r, sp_r = ref.transforms.log_mel_spectrogram(
            s_r, range_hz=None, n_bands=40, generate_plot=False,
            stft_parameters=None,
        )
        np.testing.assert_allclose(f_m, f_r, atol=1e-8)
        # log-domain comparison; mask bins whose power is below fp32 range
        # (the f64 oracle resolves denormals down to ~-3000 dB there)
        mask = sp_r > -300
        assert np.max(np.abs(np.asarray(sp_m)[mask] - sp_r[mask])) < 0.1

    def test_nyquist_assertion(self, chirp_pair):
        s_m, _ = chirp_pair
        with pytest.raises(AssertionError):
            tf.log_mel_spectrogram(
                s_m, range_hz=[20, 30e3], n_bands=10,
                generate_plot=False, stft_parameters=None,
            )

    def test_mfcc_oracle(self, ref, chirp_pair):
        s_m, s_r = chirp_pair
        t_m, mel_m, mf_m = tf.mfcc(s_m, generate_plot=False)
        t_r, mel_r, mf_r = ref.transforms.mfcc(s_r, generate_plot=False)
        # The DCT mixes all mel bands per frame, so frames containing
        # sub-fp32 power (silence) diverge from the f64 oracle in every
        # coefficient; compare only frames whose bands are representable.
        _, _, logmel_r = ref.transforms.log_mel_spectrogram(
            s_r, range_hz=None, n_bands=40, generate_plot=False,
            stft_parameters=None,
        )
        valid = np.all(logmel_r > -300, axis=0)[..., 0]
        mf_m = np.asarray(mf_m)[:, valid, :]
        mf_r = mf_r[:, valid, :]
        assert valid.sum() > 10
        scale = np.max(np.abs(mf_r))
        assert np.max(np.abs(mf_m - mf_r)) / scale < 1e-3


class TestISTFT:
    def test_reconstruction(self, chirp_pair):
        s_m, _ = chirp_pair
        t, f, sp = s_m.get_spectrogram()
        rec = tf.istft(sp, original_signal=s_m)
        np.testing.assert_allclose(
            s_m.time_data, rec.time_data, atol=1e-5
        )

    def test_reconstruction_from_parameters(self, chirp_pair):
        s_m, _ = chirp_pair
        t, f, sp = s_m.get_spectrogram()
        rec = tf.istft(
            sp,
            parameters=s_m._spectrogram_parameters,
            sampling_rate_hz=s_m.sampling_rate_hz,
        )
        np.testing.assert_allclose(
            s_m.time_data, rec.time_data[: len(s_m)], atol=1e-5
        )

    def test_reconstruction_zeropadded_fft(self, chirp_pair):
        s_m, _ = chirp_pair
        wl = 512
        s_m.set_spectrogram_parameters(
            window_length_samples=wl, fft_length_samples=wl * 2
        )
        t, f, sp = s_m.get_spectrogram()
        rec = tf.istft(sp, original_signal=s_m)
        np.testing.assert_allclose(
            s_m.time_data, rec.time_data, atol=1e-5
        )


class TestChroma:
    def test_oracle(self, ref, chirp_pair):
        s_m, s_r = chirp_pair
        t_m, c_m, _ = tf.chroma_stft(s_m)
        t_r, c_r, _ = ref.transforms.chroma_stft(s_r)
        scale = np.max(np.abs(c_r))
        assert np.max(np.abs(np.asarray(c_m) - c_r)) / scale < 1e-3


class TestCWT:
    def test_oracle(self, ref, chirp_pair, close):
        s_m, s_r = chirp_pair
        s_m = dsp.pad_trim(s_m, 8192)
        s_r = ref.pad_trim(s_r, 8192)
        query_f = np.linspace(100, 200, 10)
        mor_m = tf.MorletWavelet(b=None, h=3, step=1e-3)
        mor_r = ref.transforms.MorletWavelet(b=None, h=3, step=1e-3)
        out_m = tf.cwt(s_m, query_f, mor_m, None)
        out_r = ref.transforms.cwt(s_r, query_f, mor_r, None)
        close(np.abs(np.asarray(out_m)), np.abs(out_r), 2e-4, "cwt")


class TestDeviceResidentReturns:
    """`return_device=True` paths must match the host-matrix API exactly
    (VERDICT round-1 item 4: device-resident vqt/cwt/spectrogram)."""

    def test_cwt_device_matches_host(self, chirp_pair):
        s_m, _ = chirp_pair
        s_m = dsp.pad_trim(s_m, 4096)
        query_f = np.linspace(100, 200, 5)
        mor = tf.MorletWavelet(b=None, h=3, step=1e-3)
        host = tf.cwt(s_m, query_f, mor, None)
        dev = tf.cwt(s_m, query_f, mor, None, return_device=True)
        from dsptoolbox_jax.classes import DeviceSpectralData

        assert isinstance(dev, DeviceSpectralData)
        np.testing.assert_allclose(dev.to_numpy(), host, atol=1e-7)
        # numpy protocol
        np.testing.assert_allclose(np.asarray(dev), host, atol=1e-7)

    def test_cwt_synchrosqueezed_fused_matches_two_stage(self, chirp_pair):
        from dsptoolbox_jax.transforms._backend import squeeze_scalogram

        s_m, _ = chirp_pair
        s_m = dsp.pad_trim(s_m, 4096)
        query_f = np.linspace(100, 200, 5)
        mor = tf.MorletWavelet(b=None, h=3, step=1e-3)
        scal = tf.cwt(s_m, query_f, mor, None)
        two_stage = squeeze_scalogram(
            scal, query_f, s_m.sampling_rate_hz
        )
        fused = tf.cwt(s_m, query_f, mor, None, synchrosqueezed=True)
        np.testing.assert_allclose(fused, two_stage, atol=1e-6)

    def test_vqt_device_matches_host(self, chirp_pair):
        s_m, _ = chirp_pair
        f_h, host = tf.vqt(s_m, octaves=[2, 4])
        f_d, dev = tf.vqt(s_m, octaves=[2, 4], return_device=True)
        np.testing.assert_allclose(f_h, f_d)
        np.testing.assert_allclose(dev.to_numpy(), host, atol=1e-7)

    def test_spectrogram_device_matches_host(self, chirp_pair):
        s_m, _ = chirp_pair
        s_m.set_spectrogram_parameters(window_length_samples=512)
        t_h, f_h, S_h = s_m.get_spectrogram(force_computation=True)
        t_d, f_d, S_d = s_m.get_spectrogram(return_device=True)
        np.testing.assert_allclose(t_h, t_d, atol=1e-12)
        np.testing.assert_allclose(f_h, f_d, atol=1e-12)
        np.testing.assert_allclose(S_d.to_numpy(), np.asarray(S_h), atol=1e-7)


class TestHilbert:
    @pytest.mark.parametrize("trim", [0, 1])
    def test_vs_scipy(self, chirp_pair, trim):
        from scipy.signal import hilbert as sp_hilbert

        s_m, _ = chirp_pair
        if trim:
            s_m = dsp.pad_trim(s_m, len(s_m) - 1)
        out = tf.hilbert(s_m)
        got = out.time_data + 1j * out.time_data_imaginary
        want = sp_hilbert(s_m.time_data, axis=0)
        np.testing.assert_allclose(got, want, atol=1e-4)


class TestStereoMidSide:
    def test_roundtrip(self, chirp_pair):
        s_m, _ = chirp_pair
        sp = dsp.append_signals([s_m, s_m])
        mid_side = tf.stereo_mid_side(sp, True)
        back = tf.stereo_mid_side(mid_side, False)
        np.testing.assert_allclose(
            sp.time_data, back.time_data, atol=1e-6
        )


class TestLaguerre:
    def test_oracle(self, ref, chirp_pair, close):
        s_m, s_r = chirp_pair
        s_m = dsp.pad_trim(s_m, 128)
        s_r = ref.pad_trim(s_r, 128)
        out_m = tf.laguerre(s_m, -0.7)
        out_r = ref.transforms.laguerre(s_r, -0.7)
        close(out_m.time_data, out_r.time_data, 1e-4, "laguerre")


class TestWarp:
    @pytest.mark.parametrize("factor,compensate", [(-0.6, True), (0.6, False)])
    def test_numeric_oracle(self, ref, close, factor, compensate):
        s_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        s_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        out_m = tf.warp(s_m, factor, compensate, 2**8)
        out_r = ref.transforms.warp(s_r, factor, compensate, 2**8)
        close(out_m.time_data, out_r.time_data, 5e-4, "warp")

    @pytest.mark.parametrize("scale", ["bark", "bark-", "erb", "erb-"])
    def test_scales(self, ref, close, scale):
        s_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        s_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        out_m, lam_m = tf.warp(s_m, scale, False, 2**7)
        out_r, lam_r = ref.transforms.warp(s_r, scale, False, 2**7)
        np.testing.assert_allclose(lam_m, lam_r)
        close(out_m.time_data, out_r.time_data, 5e-4, f"warp {scale}")


class TestWarpFilter:
    @pytest.mark.parametrize("factor", [-0.6, 0.6])
    def test_oracle(self, ref, factor):
        f_m = dsp.Filter.iir_filter(
            3, 100.0,
            type_of_pass=dsp.FilterPassType.Highpass,
            filter_design_method=dsp.IirDesignMethod.Butterworth,
            sampling_rate_hz=24000,
        )
        f_r = ref.Filter.iir_filter(
            3, 100.0,
            type_of_pass=ref.FilterPassType.Highpass,
            filter_design_method=ref.IirDesignMethod.Butterworth,
            sampling_rate_hz=24000,
        )
        w_m = tf.warp_filter(f_m, factor)
        w_r = ref.transforms.warp_filter(f_r, factor)
        ir_m = w_m.get_ir(256).time_data
        ir_r = w_r.get_ir(256).time_data
        np.testing.assert_allclose(ir_m, ir_r, atol=1e-5)


class TestLPC:
    @pytest.mark.parametrize("overlap_mirror", [False, True])
    def test_oracle(self, ref, chirp_pair, overlap_mirror):
        s_m, s_r = chirp_pair
        s_m = dsp.resample(s_m, 8000)
        s_r = ref.resample(s_r, 8000)
        out_m = tf.lpc(s_m, 10, 1024, False, overlap_mirror, 512)
        out_r = ref.transforms.lpc(s_r, 10, 1024, False, overlap_mirror, 512)
        a_m, a_r = np.asarray(out_m[0]), np.asarray(out_r[0])
        # the reference's Burg estimator over-allocates its output to
        # (window_length+1, ...) and fills only the first order+1 rows;
        # we return the compact (order+1, ...) shape
        a_r = a_r[: a_m.shape[0]]
        scale = np.max(np.abs(a_r))
        assert np.max(np.abs(a_m - a_r)) / scale < 5e-3


class TestDFT:
    def test_matches_fft_bins(self, chirp_pair):
        s_m, _ = chirp_pair
        s_m = dsp.pad_trim(s_m, 20_000)
        s_m.spectrum_method = dsp.SpectrumMethod.FFT
        f, spectrum = s_m.get_spectrum()
        select = slice(20, 40)
        out = tf.dft(s_m, np.asarray(f[select]))
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(spectrum[select, ...]), atol=1e-3
        )


class TestSpectrumViaFilterbank:
    def test_oracle(self, ref, chirp_pair, close):
        s_m, s_r = chirp_pair
        s_m = dsp.pad_trim(s_m, 20_000)
        s_r = ref.pad_trim(s_r, 20_000)
        freqs = np.asarray([500, 550, 1000])
        spec_m = tf.spectrum_via_filterbank(s_m, freqs, None, 20.0, 8, False)
        spec_r = ref.transforms.spectrum_via_filterbank(
            s_r, freqs, None, 20.0, 8, False
        )
        np.testing.assert_allclose(
            spec_m.frequency_vector_hz, spec_r.frequency_vector_hz
        )
        close(
            np.asarray(spec_m.spectral_data),
            np.asarray(spec_r.spectral_data),
            1e-3,
            "spectrum via fb",
        )


class TestVQT:
    def test_oracle(self, ref, chirp_pair):
        s_m, s_r = chirp_pair
        s_m = dsp.pad_trim(s_m, 8192)
        s_r = ref.pad_trim(s_r, 8192)
        f_m, v_m = tf.vqt(s_m, octaves=[2, 4])
        f_r, v_r = ref.transforms.vqt(s_r, octaves=[2, 4])
        np.testing.assert_allclose(f_m, f_r)
        a_m, a_r = np.abs(np.asarray(v_m)), np.abs(np.asarray(v_r))
        scale = np.max(a_r)
        assert np.max(np.abs(a_m - a_r)) / scale < 2e-3


class TestTransformsReviewRegressions:
    def test_dft_precision_does_not_degrade_with_length(self):
        """The arbitrary-frequency DFT must hold fp32-level accuracy even
        when f*n/T reaches 1e5 cycles (phase computed mod 1)."""
        import jax.numpy as jnp

        from dsptoolbox_jax.transforms._backend import dft_core

        rng = np.random.default_rng(44)
        fs = 48000
        for T in (4800, 480000):
            x = rng.standard_normal((T, 1))
            f_hz = np.array([100.0, 999.5, 9999.25])
            f_norm = f_hz * T / fs
            got = np.asarray(dft_core(jnp.asarray(x, jnp.float32), f_norm))
            n = np.arange(T)
            want = np.stack(
                [np.sum(np.exp(-2j * np.pi * f * n / T) * x[:, 0])
                 for f in f_norm]
            )[:, None]
            rel = np.abs(got - want).max() / np.abs(want).max()
            assert rel < 2e-4, (T, rel)
