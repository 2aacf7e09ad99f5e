"""Filterbank tests vs the reference oracle.

Deterministic inputs (seeded numpy noise) are fed to both frameworks so
band outputs can be compared sample-exactly (up to fp32).
"""

import numpy as np
import pytest

import dsptoolbox_jax as dsp

FS = 5000


def _noise(ch=1, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, ch)) * 0.2


@pytest.fixture
def sig_pair(ref):
    td = _noise()
    return dsp.Signal(None, td, FS), ref.Signal(None, td.copy(), FS)


class TestLinkwitzRiley:
    def test_band_outputs_vs_reference(self, ref, sig_pair, close):
        s_m, s_r = sig_pair
        fb_m = dsp.filterbanks.linkwitz_riley_crossovers(
            [500, 1000], order=4, sampling_rate_hz=FS
        )
        fb_r = ref.filterbanks.linkwitz_riley_crossovers(
            [500, 1000], order=4, sampling_rate_hz=FS
        )
        mb_m = fb_m.filter_signal(s_m, dsp.FilterBankMode.Parallel)
        mb_r = fb_r.filter_signal(s_r, ref.FilterBankMode.Parallel)
        assert mb_m.number_of_bands == mb_r.number_of_bands
        for b in range(mb_m.number_of_bands):
            close(
                mb_m.bands[b].time_data,
                mb_r.bands[b].time_data,
                5e-5,
                f"LR band {b}",
            )

    def test_summed_vs_reference(self, ref, sig_pair, close):
        s_m, s_r = sig_pair
        fb_m = dsp.filterbanks.linkwitz_riley_crossovers(
            [500, 1000], order=4, sampling_rate_hz=FS
        )
        fb_r = ref.filterbanks.linkwitz_riley_crossovers(
            [500, 1000], order=4, sampling_rate_hz=FS
        )
        out_m = fb_m.filter_signal(s_m, dsp.FilterBankMode.Summed)
        out_r = fb_r.filter_signal(s_r, ref.FilterBankMode.Summed)
        close(out_m.time_data, out_r.time_data, 5e-5, "LR summed")

    def test_invalid_args(self):
        with pytest.raises(AssertionError):
            dsp.filterbanks.linkwitz_riley_crossovers(
                [500, 1000], order=[2, 4, 4], sampling_rate_hz=FS
            )
        with pytest.raises(AssertionError):
            dsp.filterbanks.linkwitz_riley_crossovers(
                [500, 5000], order=4, sampling_rate_hz=FS
            )


class TestReconstructingFOB:
    def test_vs_reference(self, ref, sig_pair, close):
        s_m, s_r = sig_pair
        kw = dict(
            octave_fraction=1,
            frequency_range_hz=[63, 1024],
            overlap=0.5,
            slope=1,
            n_samples=2**10,
            sampling_rate_hz=FS,
        )
        fb_m = dsp.filterbanks.reconstructing_fractional_octave_bands(**kw)
        fb_r = ref.filterbanks.reconstructing_fractional_octave_bands(**kw)
        mb_m = fb_m.filter_signal(s_m, dsp.FilterBankMode.Parallel)
        mb_r = fb_r.filter_signal(s_r, ref.FilterBankMode.Parallel)
        for b in range(mb_m.number_of_bands):
            close(
                mb_m.bands[b].time_data,
                mb_r.bands[b].time_data,
                5e-5,
                f"FOB band {b}",
            )

    def test_perfect_reconstruction(self, sig_pair):
        s_m, _ = sig_pair
        fb = dsp.filterbanks.reconstructing_fractional_octave_bands(
            sampling_rate_hz=FS
        )
        summed = fb.filter_signal(s_m, dsp.FilterBankMode.Summed)
        # summed output is the input delayed by half the FIR length
        delay = np.asarray(fb.filters[0].ba[0]).shape[0] // 2
        x = s_m.time_data[:-delay, 0]
        y = summed.time_data[delay:, 0]
        np.testing.assert_allclose(y, x, atol=2e-4)


class TestGammatone:
    def test_ir_vs_reference(self, ref, close):
        d = np.zeros((1024, 1))
        d[0] = 1.0
        fb_m = dsp.filterbanks.auditory_filters_gammatone(
            [500, 1000], sampling_rate_hz=FS
        )
        fb_r = ref.filterbanks.auditory_filters_gammatone(
            [500, 1000], sampling_rate_hz=FS
        )
        s_m = dsp.Signal(None, d, FS)
        s_r = ref.Signal(None, d.copy(), FS)
        mb_m = fb_m.filter_signal(s_m, dsp.FilterBankMode.Parallel)
        mb_r = fb_r.filter_signal(s_r, ref.FilterBankMode.Parallel)
        assert mb_m.number_of_bands == mb_r.number_of_bands
        for b in range(mb_m.number_of_bands):
            close(
                mb_m.bands[b].time_data,
                mb_r.bands[b].time_data,
                2e-4,
                f"gammatone band {b}",
            )

    def test_reconstruct_roundtrip(self, ref, close):
        td = _noise(n=2000, seed=3)
        fb_m = dsp.filterbanks.auditory_filters_gammatone(
            [500, 1000], sampling_rate_hz=FS
        )
        fb_r = ref.filterbanks.auditory_filters_gammatone(
            [500, 1000], sampling_rate_hz=FS
        )
        mb_m = fb_m.filter_signal(
            dsp.Signal(None, td, FS), dsp.FilterBankMode.Parallel
        )
        mb_r = fb_r.filter_signal(
            ref.Signal(None, td.copy(), FS), ref.FilterBankMode.Parallel
        )
        rec_m = fb_m.reconstruct(mb_m)
        rec_r = fb_r.reconstruct(mb_r)
        close(rec_m.time_data, rec_r.time_data, 2e-4, "gammatone rec")


class TestQMF:
    def test_roundtrip(self, sig_pair):
        s_m, _ = sig_pair
        lp = dsp.Filter.iir_filter(
            12, (FS / 2) * 0.5095, dsp.FilterPassType.Lowpass, FS
        )
        fb = dsp.filterbanks.qmf_crossover(lp)
        mb = fb.filter_signal(
            s_m,
            mode=dsp.FilterBankMode.Parallel,
            activate_zi=False,
            downsample=True,
        )
        rt = fb.reconstruct_signal(mb, upsample=True)
        spec = dsp.spectral_difference(
            s_m, rt, energy_normalization=False
        )
        sd = np.array(spec.spectral_data)
        sd[:2] = 1.0  # remove DC
        np.testing.assert_allclose(
            dsp.tools.to_db(sd, True), 0.0, atol=1
        )


class TestFractionalOctaveBands:
    def test_sos_vs_reference(self, ref):
        fb_m, fc_m, _ = dsp.filterbanks.fractional_octave_bands(
            [125, 2000], octave_fraction=1, sampling_rate_hz=FS
        )
        fb_r, fc_r, _ = ref.filterbanks.fractional_octave_bands(
            [125, 2000], octave_fraction=1, sampling_rate_hz=FS
        )
        np.testing.assert_allclose(fc_m, fc_r)
        assert fb_m.number_of_filters == fb_r.number_of_filters
        for f_m, f_r in zip(fb_m.filters, fb_r.filters):
            np.testing.assert_allclose(f_m.sos, f_r.sos, atol=1e-10)


class TestWeighting:
    @pytest.mark.parametrize("a_weighting", [True, False])
    def test_weighting_vs_reference(self, ref, close, a_weighting):
        f_m = dsp.filterbanks.weighting_filter(
            a_weighting, sampling_rate_hz=48000
        )
        f_r = ref.filterbanks.weighting_filter(
            a_weighting, sampling_rate_hz=48000
        )
        ir_m = f_m.get_ir(512).time_data
        ir_r = f_r.get_ir(512).time_data
        # fp32 IIR accumulation vs f64 oracle
        close(ir_m, ir_r, 1e-4, f"weighting a={a_weighting}")


class TestComplementaryFIR:
    def test_vs_reference(self, ref):
        f_m = dsp.Filter.fir_filter(
            64, 1000, dsp.FilterPassType.Lowpass, FS
        )
        f_r = ref.Filter.fir_filter(64, 1000, ref.FilterPassType.Lowpass, FS)
        c_m = dsp.filterbanks.complementary_fir_filter(f_m)
        c_r = ref.filterbanks.complementary_fir_filter(f_r)
        np.testing.assert_allclose(
            np.asarray(c_m.ba[0]), c_r.ba[0], atol=1e-7
        )


class TestPinking:
    def test_vs_reference(self, ref, close):
        f_m = dsp.filterbanks.pinking_filter(500, FS)
        f_r = ref.filterbanks.pinking_filter(500, FS)
        ir_m = f_m.get_ir(1024).time_data
        ir_r = f_r.get_ir(1024).time_data
        # fp32 IIR tail accumulates small error vs the f64 oracle
        close(ir_m, ir_r, 5e-4, "pinking ir")


class TestMatchedBiquad:
    @pytest.mark.parametrize(
        "t",
        [
            "Peaking",
            "Lowpass",
            "Highpass",
            "BandpassPeak",
            "Lowshelf",
            "Highshelf",
        ],
    )
    def test_vs_reference(self, ref, t):
        f_m = dsp.filterbanks.matched_biquad(
            getattr(dsp.BiquadEqType, t), 1000.0, 5.0, 0.9, FS
        )
        f_r = ref.filterbanks.matched_biquad(
            getattr(ref.BiquadEqType, t), 1000.0, 5.0, 0.9, FS
        )
        np.testing.assert_allclose(
            np.asarray(f_m.ba[0]), f_r.ba[0], rtol=1e-7, err_msg=t
        )
        np.testing.assert_allclose(
            np.asarray(f_m.ba[1]), f_r.ba[1], rtol=1e-7, err_msg=t
        )


class TestGaussianKernel:
    def test_vs_reference(self, ref):
        f_m = dsp.filterbanks.gaussian_kernel(0.01, sampling_rate_hz=FS)
        f_r = ref.filterbanks.gaussian_kernel(0.01, sampling_rate_hz=FS)
        np.testing.assert_allclose(
            np.asarray(f_m.sos), f_r.sos, atol=1e-12
        )


class TestFractionalDelay:
    def test_vs_reference(self, ref):
        f_m = dsp.filterbanks.fractional_delay(0.4, 30, sampling_rate_hz=FS)
        f_r = ref.filterbanks.fractional_delay(0.4, 30, sampling_rate_hz=FS)
        np.testing.assert_allclose(
            np.asarray(f_m.ba[0]), f_r.ba[0], atol=1e-10
        )


class TestArma:
    def test_vs_reference(self, ref, close):
        rir_m = dsp.ImpulseResponse("/root/reference/example_data/rir.wav")
        rir_r = ref.ImpulseResponse("/root/reference/example_data/rir.wav")
        rir_m = dsp.pad_trim(rir_m, 512)
        rir_r = ref.pad_trim(rir_r, 512)
        f_m = dsp.filterbanks.arma(rir_m, 10, 11)
        f_r = ref.filterbanks.arma(rir_r, 10, 11)
        close(np.asarray(f_m.ba[0]), f_r.ba[0], 1e-3, "arma b")
        close(np.asarray(f_m.ba[1]), f_r.ba[1], 1e-3, "arma a")
