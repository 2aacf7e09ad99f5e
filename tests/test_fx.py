"""Audio effects tests vs the reference oracle.

The reference's suite is functionality-only; here deterministic WAV
material feeds both frameworks so outputs are compared numerically where
the effect is deterministic.
"""

import numpy as np
import pytest

import dsptoolbox_jax as dsp

EXAMPLE = "/root/reference/example_data"


@pytest.fixture
def speech_pair(ref):
    s_m = dsp.resample(dsp.Signal(f"{EXAMPLE}/chirp_mono.wav"), 8000)
    s_r = ref.resample(ref.Signal(f"{EXAMPLE}/chirp_mono.wav"), 8000)
    s_m = dsp.pad_trim(s_m, 8000)
    s_r = ref.pad_trim(s_r, 8000)
    return s_m, s_r


class TestSpectralSubtractor:
    @pytest.mark.parametrize("adaptive", [True, False])
    def test_oracle(self, ref, speech_pair, close, adaptive):
        s_m, s_r = speech_pair
        kw = dict(
            adaptive_mode=adaptive,
            threshold_rms_dbfs=-30 if adaptive else -10,
            block_length_s=0.15 if adaptive else 0.05,
            spectrum_to_subtract=False,
        )
        adv = dict(
            overlap_percent=75 if adaptive else 50,
            window_type=dsp.Window.Hamming,
            noise_forgetting_factor=0.95 if adaptive else 0.9,
            subtraction_factor=3 if adaptive else 1,
            subtraction_exponent=3 if adaptive else 1,
            ad_attack_time_ms=1.5,
            ad_release_time_ms=30,
        )
        adv_r = dict(adv)
        adv_r["window_type"] = ref.Window.Hamming
        e_m = dsp.effects.SpectralSubtractor(**kw)
        e_m.set_advanced_parameters(**adv)
        e_r = ref.effects.SpectralSubtractor(**kw)
        e_r.set_advanced_parameters(**adv_r)
        out_m = e_m.apply(s_m)
        out_r = e_r.apply(s_r)
        close(out_m.time_data, out_r.time_data, 2e-3,
              f"spectral subtractor adaptive={adaptive}")

    def test_imported_spectrum(self, ref, speech_pair, close):
        s_m, s_r = speech_pair
        e_m = dsp.effects.SpectralSubtractor(
            adaptive_mode=False, threshold_rms_dbfs=-10,
            block_length_s=0.05, spectrum_to_subtract=False,
        )
        e_r = ref.effects.SpectralSubtractor(
            adaptive_mode=False, threshold_rms_dbfs=-10,
            block_length_s=0.05, spectrum_to_subtract=False,
        )
        # window_length is derived lazily on first apply (reference
        # behavior: effects.py:403-414)
        e_m.apply(s_m)
        e_r.apply(s_r)
        rng = np.random.default_rng(0)
        spec = rng.uniform(0, 1, e_m.window_length)
        e_m.set_parameters(spectrum_to_subtract=spec)
        e_r.set_parameters(spectrum_to_subtract=spec.copy())
        out_m = e_m.apply(s_m)
        out_r = e_r.apply(s_r)
        close(out_m.time_data, out_r.time_data, 2e-3, "imported spectrum")


class TestDistortion:
    def test_oracle_simple(self, ref, speech_pair, close):
        s_m, s_r = speech_pair
        d_m = dsp.effects.Distortion(
            distortion_level=25, post_gain_db=0,
            type_of_distortion=dsp.effects.DistortionType.Arctan,
        )
        d_r = ref.effects.Distortion(
            distortion_level=25, post_gain_db=0,
            type_of_distortion=ref.effects.DistortionType.Arctan,
        )
        out_m = d_m.apply(s_m)
        out_r = d_r.apply(s_r)
        close(out_m.time_data, out_r.time_data, 5e-4, "distortion arctan")

    def test_oracle_mixed(self, ref, speech_pair, close):
        s_m, s_r = speech_pair
        d_m = dsp.effects.Distortion(25, 0)
        d_r = ref.effects.Distortion(25, 0)
        d_m.set_advanced_parameters(
            type_of_distortion=[
                dsp.effects.DistortionType.Arctan,
                dsp.effects.DistortionType.SoftClip,
            ],
            distortion_levels_db=[20, 40],
            mix_percent=[60, 40],
            offset_db=[-3, -np.inf],
            post_gain_db=2,
        )
        d_r.set_advanced_parameters(
            type_of_distortion=[
                ref.effects.DistortionType.Arctan,
                ref.effects.DistortionType.SoftClip,
            ],
            distortion_levels_db=[20, 40],
            mix_percent=[60, 40],
            offset_db=[-3, -np.inf],
            post_gain_db=2,
        )
        out_m = d_m.apply(s_m)
        out_r = d_r.apply(s_r)
        close(out_m.time_data, out_r.time_data, 5e-4, "distortion mixed")


class TestCompressor:
    def test_oracle(self, ref, speech_pair, close):
        s_m, s_r = speech_pair
        kw = dict(
            threshold_dbfs=-10, attack_time_ms=2, release_time_ms=30,
            ratio=5, relative_to_peak_level=True,
        )
        adv = dict(
            knee_factor_db=5, pre_gain_db=1, post_gain_db=-2,
            mix_percent=99, automatic_make_up_gain=True,
            downward_compression=True,
        )
        c_m = dsp.effects.Compressor(**kw)
        c_m.set_advanced_parameters(**adv)
        c_r = ref.effects.Compressor(**kw)
        c_r.set_advanced_parameters(**adv)
        out_m = c_m.apply(s_m)
        out_r = c_r.apply(s_r)
        close(out_m.time_data, out_r.time_data, 2e-3, "compressor")


class TestLFO:
    def test_waveform_oracle(self, ref):
        l_m = dsp.effects.LFO(
            frequency_hz=100, waveform="triangle", random_phase=False,
            smooth=5,
        )
        l_r = ref.effects.LFO(
            frequency_hz=100, waveform="triangle", random_phase=False,
            smooth=5,
        )
        w_m = l_m.get_waveform(8000, 2000)
        w_r = l_r.get_waveform(8000, 2000)
        np.testing.assert_allclose(np.asarray(w_m), w_r, atol=1e-5)

    def test_musical_rhythm_frequency(self):
        l_m = dsp.effects.LFO(
            frequency_hz=("dotted quarter", 130), waveform="sawtooth",
            smooth=0,
        )
        w = l_m.get_waveform(8000, 2000)
        assert np.all(np.isfinite(np.asarray(w)))


class TestTremolo:
    def test_oracle(self, ref, speech_pair, close):
        s_m, s_r = speech_pair
        l_m = dsp.effects.LFO(
            frequency_hz=("dotted quarter", 130), waveform="sawtooth",
            smooth=0,
        )
        l_r = ref.effects.LFO(
            frequency_hz=("dotted quarter", 130), waveform="sawtooth",
            smooth=0,
        )
        t_m = dsp.effects.Tremolo(depth=0.8, modulator=l_m)
        t_r = ref.effects.Tremolo(depth=0.8, modulator=l_r)
        out_m = t_m.apply(s_m)
        out_r = t_r.apply(s_r)
        close(out_m.time_data, out_r.time_data, 1e-4, "tremolo")


class TestChorus:
    def test_oracle(self, ref, speech_pair, close):
        s_m, s_r = speech_pair
        l_m = dsp.effects.LFO(
            frequency_hz=("dotted quarter", 130), waveform="sawtooth",
            smooth=0,
        )
        l_r = ref.effects.LFO(
            frequency_hz=("dotted quarter", 130), waveform="sawtooth",
            smooth=0,
        )
        c_m = dsp.effects.Chorus(
            depths_ms=10, base_delays_ms=25, modulators=l_m,
            mix_percent=0.95,
        )
        c_r = ref.effects.Chorus(
            depths_ms=10, base_delays_ms=25, modulators=l_r,
            mix_percent=0.95,
        )
        out_m = c_m.apply(s_m)
        out_r = c_r.apply(s_r)
        close(out_m.time_data, out_r.time_data, 1e-3, "chorus")


class TestDigitalDelay:
    @pytest.mark.parametrize("saturation", [None, "arctan"])
    def test_oracle(self, ref, speech_pair, close, saturation):
        s_m, s_r = speech_pair
        d_m = dsp.effects.DigitalDelay(150, feedback=0.15)
        d_m.set_advanced_parameters(saturation)
        d_r = ref.effects.DigitalDelay(150, feedback=0.15)
        d_r.set_advanced_parameters(saturation)
        out_m = d_m.apply(s_m)
        out_r = d_r.apply(s_r)
        close(
            out_m.time_data, out_r.time_data, 5e-4,
            f"digital delay sat={saturation}",
        )


class TestOther:
    def test_musical_rhythm(self):
        fx = dsp.effects
        assert 1 == fx.get_frequency_from_musical_rhythm("quarter", 60)
        assert 2 == fx.get_frequency_from_musical_rhythm("eighth", 60)
        assert 3 == fx.get_frequency_from_musical_rhythm("eighth 3", 60)
        assert 2 / 3 == fx.get_frequency_from_musical_rhythm(
            "dotted quarter", 60
        )


class TestFxReviewRegressions:
    def test_chorus_1d_modulator_is_one_voice(self):
        rng = np.random.default_rng(41)
        s = dsp.Signal(None, rng.standard_normal((4800, 1)) * 0.3, 48000)
        mod = np.full(4800, 5.0)  # one voice's modulation in ms
        ch = dsp.effects.Chorus(
            depths_ms=5.0, base_delays_ms=10.0, modulators=mod
        )
        assert ch.number_of_voices == 1
        out = ch.apply(s)
        assert out.time_data.shape[0] == s.time_data.shape[0]
        assert np.isfinite(out.time_data).all()

    def test_digital_delay_zero_delay_raises(self):
        rng = np.random.default_rng(42)
        s = dsp.Signal(None, rng.standard_normal((2048, 1)) * 0.3, 8000)
        d = dsp.effects.DigitalDelay(delay_time_ms=0.05, feedback=0.2)
        with pytest.raises(AssertionError, match="zero samples"):
            d.apply(s)

    def test_digital_delay_custom_saturation(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(44)
        s = dsp.Signal(None, rng.standard_normal((4096, 1)) * 0.3, 8000)

        def my_sat(x):
            return jnp.tanh(x)

        d = dsp.effects.DigitalDelay(delay_time_ms=50.0, feedback=0.4)
        d.set_advanced_parameters(saturation=my_sat)
        out = d.apply(s)
        assert np.isfinite(out.time_data).all()
        d2 = dsp.effects.DigitalDelay(delay_time_ms=50.0, feedback=0.4)
        out_digital = d2.apply(s)
        # the saturator actually participates in the comb recursion
        assert not np.allclose(out.time_data, out_digital.time_data)
        # and a reused instance produces identical results (cached program)
        out_again = d.apply(s)
        np.testing.assert_array_equal(out.time_data, out_again.time_data)

    def test_digital_delay_untraceable_saturation_clear_error(self):
        rng = np.random.default_rng(43)
        s = dsp.Signal(None, rng.standard_normal((2048, 1)) * 0.3, 48000)
        d = dsp.effects.DigitalDelay(delay_time_ms=10.0, feedback=0.2)
        d.set_advanced_parameters(
            saturation=lambda x: float(np.tanh(float(x)))
        )
        with pytest.raises(ValueError, match="traceable"):
            d.apply(s)
