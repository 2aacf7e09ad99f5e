"""Smoke tests: every public plot method must run under Agg."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest

import dsptoolbox_jax as dsp

EXAMPLE = "/root/reference/example_data"


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def sig():
    return dsp.pad_trim(dsp.Signal(f"{EXAMPLE}/chirp_stereo.wav"), 2**14)


@pytest.fixture(scope="module")
def rir():
    return dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")


class TestSignalPlots:
    def test_all_signal_plots(self, sig):
        sig.plot_time()
        sig.plot_magnitude()
        sig.plot_spl()
        sig.plot_spectrogram()
        sig.plot_csm()
        # phase/group delay require a complex (FFT) spectrum
        sig.spectrum_method = dsp.SpectrumMethod.FFT
        sig.plot_phase()
        sig.plot_group_delay()

    def test_ir_plots(self, rir):
        rir.plot_time()
        rir.plot_magnitude()
        rir.plot_bode()


class TestFilterPlots:
    def test_filter_plots(self):
        f = dsp.Filter.iir_filter(
            4, 1000.0, dsp.FilterPassType.Lowpass, 48000
        )
        f.plot_magnitude()
        f.plot_group_delay()
        f.plot_phase()
        f.plot_zp()
        fir = dsp.Filter.fir_filter(
            32, 1000.0, dsp.FilterPassType.Lowpass, 48000
        )
        fir.plot_taps()

    def test_filterbank_plots(self):
        fb = dsp.filterbanks.linkwitz_riley_crossovers(
            [500, 1000], order=4, sampling_rate_hz=8000
        )
        fb.plot_magnitude(length_samples=512)
        fb.plot_phase(length_samples=512)
        fb.plot_group_delay(length_samples=512)


class TestOtherPlots:
    def test_spectrum_plot(self, sig):
        freqs = dsp.tools.log_frequency_vector([50, 3000], 48)
        filt = dsp.Filter.biquad(
            dsp.BiquadEqType.Peaking, 500.0, 5.0, 1.0, 48000
        )
        sp = dsp.Spectrum.from_filter(freqs, filt, False)
        sp.plot_magnitude()

    def test_waterfall(self, sig):
        dsp.transforms.plot_waterfall(sig.get_channels(0))

    def test_compressor_show(self):
        comp = dsp.effects.Compressor(threshold_dbfs=-10)
        comp.show_compression()

    def test_lfo_waveform(self):
        lfo = dsp.effects.LFO(frequency_hz=5, waveform="triangle")
        lfo.plot_waveform()

    def test_grid_plots(self):
        x = np.arange(0, 1.1, 0.5)
        g = dsp.beamforming.Regular3DGrid(x, x, x)
        g.plot_points(projection=None)
        g.plot_points(projection="2d")
        g.plot_points(projection="3d")

    def test_room_plot(self):
        room = dsp.room_acoustics.ShoeboxRoom(
            [4.0, 3.0, 2.5], t60_s=0.4
        )
        if hasattr(room, "plot"):
            room.plot()
