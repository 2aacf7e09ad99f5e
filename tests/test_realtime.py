"""Realtime/streaming filter tests.

Each streaming class is validated against its offline equivalent (scipy /
the offline device kernels): block or sample streaming must produce the
same output as one-shot filtering.
"""

import numpy as np
import pytest
import scipy.signal as sig

import dsptoolbox_jax as dsp
from dsptoolbox_jax import realtime as rt

FS = 4000


@pytest.fixture
def noise():
    rng = np.random.default_rng(0)
    return (rng.standard_normal(1024) * 0.3).astype(np.float64)


class TestIIRFilter:
    def test_matches_scipy_lfilter(self, noise):
        b, a = sig.butter(4, 0.3)
        f = rt.IIRFilter(b, a)
        f.set_n_channels(1)
        out = np.array([f.process_sample(x, 0) for x in noise])
        want = sig.lfilter(b, a, noise)
        np.testing.assert_allclose(out, want, atol=1e-10)

    def test_block_streaming(self, noise):
        b, a = sig.butter(4, 0.3)
        f = rt.IIRFilter(b, a)
        f.set_n_channels(1)
        blocks = [
            np.asarray(f.process_block(blk, 0))
            for blk in noise.reshape(8, 128)
        ]
        out = np.concatenate(blocks)
        want = sig.lfilter(b, a, noise)
        np.testing.assert_allclose(out, want, atol=1e-5)

    def test_reset_state(self, noise):
        b, a = sig.butter(2, 0.2)
        f = rt.IIRFilter(b, a)
        f.set_n_channels(1)
        first = np.array([f.process_sample(x, 0) for x in noise[:64]])
        f.reset_state()
        second = np.array([f.process_sample(x, 0) for x in noise[:64]])
        np.testing.assert_array_equal(first, second)


class TestFIRFilters:
    def test_fir_sample_streaming(self, noise):
        b = sig.firwin(31, 0.3)
        f = rt.FIRFilter(b)
        f.set_n_channels(1)
        out = np.array([f.process_sample(x, 0) for x in noise])
        want = sig.lfilter(b, [1.0], noise)
        np.testing.assert_allclose(out, want, atol=1e-10)

    def test_overlap_save_blocks(self, noise):
        b = sig.firwin(63, 0.25)
        f = rt.FIRFilterOverlapSave(b)
        f.prepare(128, 1)
        blocks = [
            np.asarray(f.process_block(blk, 0))
            for blk in noise.reshape(8, 128)
        ]
        out = np.concatenate(blocks)
        want = sig.lfilter(b, [1.0], noise)
        np.testing.assert_allclose(out, want, atol=1e-5)

    def test_uniform_partitioned(self, noise):
        b = sig.firwin(400, 0.25)
        f = rt.FIRUniformPartitioned(b)
        f.prepare(128, 1)
        blocks = [
            np.asarray(f.process_block(blk, 0))
            for blk in noise.reshape(8, 128)
        ]
        out = np.concatenate(blocks)
        want = sig.lfilter(b, [1.0], noise)
        np.testing.assert_allclose(out, want, atol=1e-5)

    def test_uniform_partitioned_multichannel(self, noise):
        x = np.stack([noise, noise * 0.5], axis=-1)  # (T, 2)
        firs = np.stack(
            [sig.firwin(300, 0.25), sig.firwin(300, 0.5)], axis=-1
        )  # (K, 2)
        f = rt.FIRUniformPartitionedMultichannel(firs)
        f.prepare(128)
        blocks = [
            np.asarray(f.process_block(x[i * 128:(i + 1) * 128]))
            for i in range(8)
        ]
        out = np.concatenate(blocks, axis=0)
        for ch in range(2):
            want = sig.lfilter(firs[:, ch], [1.0], x[:, ch])
            np.testing.assert_allclose(out[:, ch], want, atol=1e-5)


class TestLatticeLadder:
    b = np.array([1, 3, 3, 1.0])
    a = np.array([1, -0.9, 0.64, -0.576])

    def test_coefficients_oppenheim(self):
        from dsptoolbox_jax.realtime.misc import (
            lattice_ladder_coefficients_iir,
        )

        k, c = lattice_ladder_coefficients_iir(self.b, self.a)
        np.testing.assert_allclose(
            k, [0.6728, -0.182, 0.576], atol=2e-3
        )
        np.testing.assert_allclose(
            c, [4.5404, 5.4612, 3.9, 1], atol=2e-3
        )

    def test_filtering_matches_lfilter(self, noise):
        from dsptoolbox_jax.realtime.misc import (
            lattice_ladder_coefficients_iir,
        )

        k, c = lattice_ladder_coefficients_iir(self.b / 10, self.a)
        f = rt.LatticeLadderFilter(k, c, sampling_rate_hz=FS)
        s = dsp.Signal(None, noise[:, None], FS)
        out = f.filter_signal(s).time_data.squeeze()
        want = sig.lfilter(self.b / 10, self.a, noise)
        np.testing.assert_allclose(out, want, atol=1e-6)

    def test_from_filter_sos(self, noise):
        f_iir = dsp.Filter.iir_filter(
            filter_design_method=dsp.IirDesignMethod.Bessel,
            order=9,
            type_of_pass=dsp.FilterPassType.Lowpass,
            frequency_hz=1000,
            sampling_rate_hz=44100,
        )
        lat = rt.LatticeLadderFilter.from_filter(f_iir)
        s = dsp.Signal(None, noise[:, None], 44100)
        n1 = f_iir.filter_signal(s).time_data.squeeze()
        n2 = lat.filter_signal(s).time_data.squeeze()
        np.testing.assert_allclose(n1, n2, atol=1e-4)


class TestStateVariableFilter:
    def test_bands_sum_and_shapes(self, noise):
        f = rt.StateVariableFilter(1000.0, 0.7071, FS)
        s = dsp.Signal(None, noise[:, None], FS)
        mb = f.filter_signal(s)
        assert mb.number_of_bands == 4
        # LP + HP + BP*(1/Q) reconstructs an allpass-magnitude signal
        lp = mb.bands[0].time_data.squeeze()
        assert np.std(lp) > 0

    def test_sample_vs_block_consistency(self, noise):
        f = rt.StateVariableFilter(500.0, 1.0, FS)
        f.set_n_channels(1)
        sample_out = np.array(
            [f.process_sample(x, 0)[0] for x in noise[:256]]
        )
        f.reset_state()
        s = dsp.Signal(None, noise[:256, None], FS)
        mb = f.filter_signal(s)
        np.testing.assert_allclose(
            sample_out, mb.bands[0].time_data.squeeze(), atol=1e-5
        )


    def test_get_ir_and_plots(self):
        """Oracle: reference SVF IR (`sv_filter.py:147-164`)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        f = rt.StateVariableFilter(1000.0, 0.5, FS)
        mb = f.get_ir(512)
        assert mb.number_of_bands == 4
        assert mb.bands[0].time_data.shape[0] == 512
        # LP band IR of a dirac: first sample equals the LP path gain
        # g^2 * intermediate_value (two integrators, zero state)
        expected0 = f.g**2 * f.intermediate_value
        np.testing.assert_allclose(
            mb.bands[0].time_data[0, 0], expected0, rtol=1e-6
        )
        for fig, _ in (
            f.plot_magnitude(256),
            f.plot_group_delay(256),
            f.plot_phase(256, unwrap=True),
        ):
            plt.close(fig)


class TestStateSpaceFilter:
    def test_matches_lfilter(self, noise):
        b, a = sig.butter(2, 0.25)
        A, B, C, D = sig.tf2ss(b, a)
        f = rt.StateSpaceFilter(A, B, C, D)
        f.set_n_channels(1)
        out = np.array([f.process_sample(x, 0) for x in noise[:512]])
        want = sig.lfilter(b, a, noise[:512])
        np.testing.assert_allclose(out, want, atol=1e-8)


class TestWarpedFilters:
    def test_warped_fir_zero_warping_is_fir(self, noise):
        b = sig.firwin(16, 0.3)
        f = rt.WarpedFIR(b, 0.0, sampling_rate_hz=FS)
        s = dsp.Signal(None, noise[:256, None], FS)
        out = f.filter_signal(s).time_data.squeeze()
        want = sig.lfilter(b, [1.0], noise[:256])
        np.testing.assert_allclose(out, want, atol=1e-6)

    def test_warped_iir_runs(self, noise):
        b, a = sig.butter(2, 0.3)
        f = rt.WarpedIIR(b, a, 0.4, sampling_rate_hz=FS)
        s = dsp.Signal(None, noise[:256, None], FS)
        out = f.filter_signal(s).time_data.squeeze()
        assert np.all(np.isfinite(out))
        assert np.std(out) > 0


class TestKautz:
    def test_fit_reconstructs_ir(self):
        # simple decaying IR from a biquad
        b, a = sig.butter(2, 0.2)
        ir_td = sig.lfilter(b, a, np.eye(1, 256).squeeze())
        ir = dsp.ImpulseResponse(None, ir_td[:, None], FS)
        poles = np.array([0.6 + 0.4j, 0.3 + 0.1j])
        f = rt.KautzFilter(poles, FS)
        f.fit_coefficients_to_ir(ir)
        d = dsp.ImpulseResponse(
            None, np.eye(1, 256).squeeze()[:, None], FS
        )
        rec = f.filter_signal(d).time_data.squeeze()
        # the 2-pole Kautz basis approximates this 1-biquad IR well
        err = np.linalg.norm(rec - ir_td) / np.linalg.norm(ir_td)
        assert err < 0.6, err


class TestParallelFilter:
    def test_fit_approximates_ir(self):
        b, a = sig.butter(2, [0.1, 0.3], btype="bandpass")
        ir_td = sig.lfilter(b, a, np.eye(1, 512).squeeze())
        ir = dsp.ImpulseResponse(None, ir_td[:, None], FS)
        # pole basis near the target band (normalized freq 0.1-0.3)
        r = np.roots(a)
        poles = np.array([p for p in r if p.imag >= 0])
        f = rt.ParallelFilter(poles, n_fir=16, sampling_rate_hz=FS)
        f.fit_to_ir(ir)
        d = dsp.ImpulseResponse(
            None, np.eye(1, 512).squeeze()[:, None], FS
        )
        rec = f.filter_signal(d).time_data.squeeze()
        err = np.linalg.norm(rec - ir_td) / np.linalg.norm(ir_td)
        assert err < 0.5, err

    def test_fit_uses_host_f64_spectrum(self):
        """The LS fit is ill-conditioned (SOS numerators reach ~1e4 with
        cancellation); it must consume a host f64 spectrum, not the
        backend's fp32 device rfft — otherwise the solution differs
        between the CPU and an accelerator."""
        b, a = sig.butter(2, 0.2)
        ir_td = sig.lfilter(b, a, np.eye(1, 256).squeeze())
        ir = dsp.ImpulseResponse(None, ir_td[:, None], FS)
        # default FFT-spectrum configuration -> host path (never touches
        # the device getter)
        ir.get_spectrum = None  # would raise if the fit called it
        freqs, sp = rt.ParallelFilter._host_f64_spectrum(ir)
        assert sp.dtype == np.complex128
        from scipy.fft import next_fast_len

        n = next_fast_len(256, True)
        stored = np.asarray(ir.time_data, np.float64)[:, 0]
        np.testing.assert_allclose(
            sp[:, 0], np.fft.rfft(stored, n=n), rtol=0, atol=0
        )
        poles = np.array([0.6 + 0.4j, 0.3 + 0.1j])
        f = rt.ParallelFilter(poles, n_fir=16, sampling_rate_hz=FS)
        f.fit_to_ir(ir)
        assert f._sos.dtype == np.float64


class TestExponentialAverage:
    def test_smooths(self, noise):
        f = rt.ExponentialAverageFilter(0.01, 0.05, FS)
        f.set_n_channels(1)
        out = np.array([f.process_sample(abs(x), 0) for x in noise])
        assert np.std(np.diff(out)) < np.std(np.diff(np.abs(noise)))


class TestFilterChain:
    def test_chain_equals_cascade(self, noise):
        b1, a1 = sig.butter(2, 0.4)
        b2, a2 = sig.butter(2, 0.3, btype="highpass")
        chain = rt.FilterChain(
            [rt.IIRFilter(b1, a1), rt.IIRFilter(b2, a2)]
        )
        chain.set_n_channels(1)
        out = np.array([chain.process_sample(x, 0) for x in noise[:512]])
        want = sig.lfilter(b2, a2, sig.lfilter(b1, a1, noise[:512]))
        np.testing.assert_allclose(out, want, atol=1e-9)


class TestDesigners:
    FS_HZ = 48000

    def _collapsed_ir(self, length):
        fb = dsp.filterbanks.linkwitz_riley_crossovers(
            [570, 2000], order=[2, 2], sampling_rate_hz=self.FS_HZ
        )
        return fb.get_ir(length_samples=length).collapse()

    def test_phase_linearizer(self):
        from dsptoolbox_jax.realtime.designers import PhaseLinearizer

        ir = self._collapsed_ir(2**12)
        ir.spectrum_method = dsp.SpectrumMethod.FFT
        _, sp = ir.get_spectrum()
        pl = PhaseLinearizer(
            np.angle(np.asarray(sp)[:, 0]), len(ir), self.FS_HZ
        )
        out_ir = pl.get_filter_as_ir()
        assert np.all(np.isfinite(out_ir.time_data))
        filt = pl.get_filter()
        assert filt.sampling_rate_hz == self.FS_HZ

    def test_group_delay_designer(self):
        from dsptoolbox_jax.realtime.designers import GroupDelayDesigner

        ir = self._collapsed_ir(2**12)
        _, gd = dsp.transfer_functions.group_delay(ir)
        gd = np.max(gd) * 2 - gd
        pl = GroupDelayDesigner(
            np.asarray(gd).squeeze(), len(ir), self.FS_HZ
        )
        pl.set_parameters(1.0)
        min_len_filter = pl.get_filter()
        longer = (
            GroupDelayDesigner(
                np.asarray(gd).squeeze(), len(ir), self.FS_HZ
            )
            .set_parameters(1.0, 10)
            .get_filter()
        )
        assert len(longer) - 10 == len(min_len_filter)


class TestKautzOracle:
    def test_fit_matches_reference(self, ref, close):
        import scipy.signal as sig

        b, a = sig.butter(2, 0.2)
        ir_td = sig.lfilter(b, a, np.eye(1, 256).squeeze())
        poles = np.array([0.6 + 0.4j, 0.3 + 0.1j])
        k_m = rt.KautzFilter(poles, FS)
        k_r = ref.filterbanks.KautzFilter(poles.copy(), FS)
        ir_m = dsp.ImpulseResponse(None, ir_td[:, None].copy(), FS)
        ir_r = ref.ImpulseResponse(None, ir_td[:, None].copy(), FS)
        k_m.fit_coefficients_to_ir(ir_m)
        k_r.fit_coefficients_to_ir(ir_r)
        d_m = dsp.ImpulseResponse(
            None, np.eye(1, 256).squeeze()[:, None], FS
        )
        d_r = ref.ImpulseResponse(
            None, np.eye(1, 256).squeeze()[:, None], FS
        )
        out_m = k_m.filter_signal(d_m).time_data
        out_r = k_r.filter_signal(d_r).time_data
        close(out_m, out_r, 1e-4, "kautz fit+filter")


class TestParallelFilterOracle:
    def test_fit_matches_reference(self, ref, close):
        import scipy.signal as sig

        b, a = sig.butter(2, [0.1, 0.3], btype="bandpass")
        ir_td = sig.lfilter(b, a, np.eye(1, 512).squeeze())
        r = np.roots(a)
        poles = np.array([p for p in r if p.imag >= 0])
        f_m = rt.ParallelFilter(poles, n_fir=16, sampling_rate_hz=FS)
        f_r = ref.filterbanks.ParallelFilter(
            poles.copy(), 16, sampling_rate_hz=FS
        )
        ir_m = dsp.ImpulseResponse(None, ir_td[:, None].copy(), FS)
        ir_r = ref.ImpulseResponse(None, ir_td[:, None].copy(), FS)
        f_m.fit_to_ir(ir_m)
        f_r.fit_to_ir(ir_r)
        d_m = dsp.ImpulseResponse(
            None, np.eye(1, 512).squeeze()[:, None], FS
        )
        d_r = ref.ImpulseResponse(
            None, np.eye(1, 512).squeeze()[:, None], FS
        )
        out_m = f_m.filter_signal(d_m).time_data
        out_r = f_r.filter_signal(d_r).time_data
        close(out_m, out_r, 1e-3, "parallel filter fit+filter")
