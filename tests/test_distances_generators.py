"""Distance measures and signal generators vs the reference oracle."""

import numpy as np
import pytest

import dsptoolbox_jax as dsp

EXAMPLE = "/root/reference/example_data"


@pytest.fixture
def stereo_pair(ref):
    s_m = dsp.Signal(f"{EXAMPLE}/chirp_stereo.wav")
    s_r = ref.Signal(f"{EXAMPLE}/chirp_stereo.wav")
    return s_m, s_r


class TestDistances:
    @pytest.mark.parametrize("method", ["standard", "welch"])
    def test_log_spectral_oracle(self, ref, stereo_pair, method):
        s_m, s_r = stereo_pair
        d_m = dsp.distances.log_spectral(
            s_m.get_channels(0), s_m.get_channels(1),
            method=method, f_range_hz=[200, 5000],
            energy_normalization=True, spectrum_parameters=None,
        )
        d_r = ref.distances.log_spectral(
            s_r.get_channels(0), s_r.get_channels(1),
            method=method, f_range_hz=[200, 5000],
            energy_normalization=True, spectrum_parameters=None,
        )
        np.testing.assert_allclose(d_m, d_r, rtol=1e-3)

    @pytest.mark.parametrize("method", ["standard", "welch"])
    def test_itakura_saito_oracle(self, ref, stereo_pair, method):
        s_m, s_r = stereo_pair
        d_m = dsp.distances.itakura_saito(
            s_m.get_channels(0), s_m.get_channels(1),
            method=method, f_range_hz=[200, 5000],
            energy_normalization=True, spectrum_parameters=None,
        )
        d_r = ref.distances.itakura_saito(
            s_r.get_channels(0), s_r.get_channels(1),
            method=method, f_range_hz=[200, 5000],
            energy_normalization=True, spectrum_parameters=None,
        )
        np.testing.assert_allclose(d_m, d_r, rtol=1e-3)

    def test_nyquist_assertion(self, stereo_pair):
        s_m, _ = stereo_pair
        with pytest.raises(AssertionError):
            dsp.distances.log_spectral(
                s_m.get_channels(0), s_m.get_channels(1),
                method="welch", f_range_hz=[20, 30e3],
                energy_normalization=True, spectrum_parameters=None,
            )

    def test_snr_oracle(self, ref, stereo_pair):
        s_m, s_r = stereo_pair
        v_m = dsp.distances.snr(
            s_m.get_channels(0), s_m.get_channels(1)
        )
        v_r = ref.distances.snr(
            s_r.get_channels(0), s_r.get_channels(1)
        )
        np.testing.assert_allclose(v_m, v_r, rtol=1e-4)

    def test_si_sdr_oracle(self, ref, stereo_pair):
        s_m, s_r = stereo_pair
        v_m = dsp.distances.si_sdr(
            s_m.get_channels(0), s_m.get_channels(1)
        )
        v_r = ref.distances.si_sdr(
            s_r.get_channels(0), s_r.get_channels(1)
        )
        np.testing.assert_allclose(v_m, v_r, rtol=1e-3)

    def test_fw_snr_seg_oracle(self, ref, stereo_pair):
        s_m, s_r = stereo_pair
        v_m = dsp.distances.fw_snr_seg(
            s_m.get_channels(0), s_m.get_channels(1),
            f_range_hz=[500, 4000], snr_range_db=[-10, 35], gamma=0.5,
        )
        v_r = ref.distances.fw_snr_seg(
            s_r.get_channels(0), s_r.get_channels(1),
            f_range_hz=[500, 4000], snr_range_db=[-10, 35], gamma=0.5,
        )
        np.testing.assert_allclose(v_m, v_r, rtol=5e-3)


class TestGenerators:
    FS = 10000

    def test_noise_types_functionality(self):
        for nt in [
            dsp.generators.NoiseType.White,
            dsp.generators.NoiseType.Pink,
            dsp.generators.NoiseType.Red,
            dsp.generators.NoiseType.Blue,
            dsp.generators.NoiseType.Violet,
            dsp.generators.NoiseType.Grey,
        ]:
            n = dsp.generators.noise(
                0.5, self.FS, nt, peak_level_dbfs=-20,
                number_of_channels=2,
            )
            td = n.time_data
            assert td.shape == (self.FS // 2, 2)
            assert np.all(np.isfinite(td))
            peak = np.max(np.abs(td))
            np.testing.assert_allclose(
                20 * np.log10(peak), -20, atol=0.5
            )

    def test_noise_seed_reproducible(self):
        a = dsp.generators.noise(0.2, self.FS, seed=10).time_data
        b = dsp.generators.noise(0.2, self.FS, seed=10).time_data
        np.testing.assert_array_equal(a, b)

    def test_noise_spectral_slope(self):
        # pink noise psd ~ 1/f: fit a line in log-log, slope ~ -1
        n = dsp.generators.noise(
            4.0, self.FS, dsp.generators.NoiseType.Pink, seed=2
        )
        f, psd = __import__("scipy.signal", fromlist=["welch"]).welch(
            n.time_data[:, 0], fs=self.FS, nperseg=2048
        )
        keep = (f > 50) & (f < 4000)
        slope = np.polyfit(np.log10(f[keep]), np.log10(psd[keep]), 1)[0]
        assert abs(slope + 1.0) < 0.2, slope

    @pytest.mark.parametrize(
        "ct",
        ["Logarithmic", "Linear"],
    )
    def test_chirp_vs_reference(self, ref, close, ct):
        c_m = dsp.generators.chirp(
            self.FS, getattr(dsp.generators.ChirpType, ct),
            range_hz=[100, 4000], length_seconds=1.0,
            peak_level_dbfs=-10, fade=dsp.FadeType.NoFade,
        )
        c_r = ref.generators.chirp(
            self.FS, getattr(ref.generators.ChirpType, ct),
            range_hz=[100, 4000], length_seconds=1.0,
            peak_level_dbfs=-10, fade=ref.FadeType.NoFade,
        )
        close(c_m.time_data, c_r.time_data, 1e-4, f"chirp {ct}")

    def test_sync_log_chirp(self, ref, close):
        out_m = dsp.generators.chirp(
            self.FS, dsp.generators.ChirpType.SyncLog,
            range_hz=[100, 4000], length_seconds=1.0,
            fade=dsp.FadeType.NoFade,
        )
        out_r = ref.generators.chirp(
            self.FS, ref.generators.ChirpType.SyncLog,
            range_hz=[100, 4000], length_seconds=1.0,
            fade=ref.FadeType.NoFade,
        )
        c_m, T_m = out_m
        c_r, T_r = out_r
        assert np.isclose(T_m, T_r)
        close(c_m.time_data, c_r.time_data, 1e-4, "sync log chirp")

    def test_dirac(self, ref):
        d_m = dsp.generators.dirac(
            1024, delay_samples=10, number_of_channels=2,
            sampling_rate_hz=self.FS,
        )
        d_r = ref.generators.dirac(
            1024, delay_samples=10, number_of_channels=2,
            sampling_rate_hz=self.FS,
        )
        np.testing.assert_array_equal(d_m.time_data, d_r.time_data)

    def test_oscillator_vs_reference(self, ref, close):
        for mode_m, mode_r in [
            (dsp.generators.WaveForm.Harmonic,
             ref.generators.WaveForm.Harmonic),
            (dsp.generators.WaveForm.Square, ref.generators.WaveForm.Square),
            (dsp.generators.WaveForm.Sawtooth, ref.generators.WaveForm.Sawtooth),
            (dsp.generators.WaveForm.Triangle, ref.generators.WaveForm.Triangle),
        ]:
            o_m = dsp.generators.oscillator(
                frequency_hz=440,
                sampling_rate_hz=self.FS,
                length_seconds=0.5,
                mode=mode_m,
            )
            o_r = ref.generators.oscillator(
                frequency_hz=440,
                sampling_rate_hz=self.FS,
                length_seconds=0.5,
                mode=mode_r,
            )
            close(
                o_m.time_data, o_r.time_data, 1e-4, f"oscillator {mode_m}"
            )
