"""Room acoustics tests vs the reference oracle."""

import numpy as np
import pytest

import dsptoolbox_jax as dsp
from dsptoolbox_jax import room_acoustics as ra

EXAMPLE = "/root/reference/example_data"


class TestReverbTime:
    @pytest.mark.parametrize("mode", ["T20", "T30", "EDT", "Adaptive"])
    def test_rt_modes_vs_reference(self, ref, mode):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rt_m, corr_m = ra.reverb_time(rir_m, getattr(ra.ReverbTime, mode))
        rt_r, corr_r = ref.room_acoustics.reverb_time(
            rir_r, getattr(ref.room_acoustics.ReverbTime, mode)
        )
        np.testing.assert_allclose(rt_m, rt_r, rtol=1e-2, err_msg=mode)
        np.testing.assert_allclose(corr_m, corr_r, atol=1e-2)

    def test_multiband_rt(self, ref):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        fb = dsp.filterbanks.fractional_octave_bands(
            [250, 2000], sampling_rate_hz=rir_m.sampling_rate_hz
        )[0]
        mb = fb.filter_signal(
            rir_m, dsp.FilterBankMode.Parallel, zero_phase=True
        )
        rt, corr = ra.reverb_time(mb, ra.ReverbTime.T20)
        assert rt.shape == (fb.number_of_filters, 1)
        assert np.all(rt > 0)


class TestDescriptors:
    @pytest.mark.parametrize(
        "desc", ["D50", "C80", "CenterTime", "BassRatio"]
    )
    def test_descriptors_vs_reference(self, ref, desc):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        d_m = ra.descriptors(
            rir_m, getattr(ra.RoomAcousticsDescriptor, desc)
        )
        d_r = ref.room_acoustics.descriptors(
            rir_r, getattr(ref.room_acoustics.RoomAcousticsDescriptor, desc)
        )
        np.testing.assert_allclose(d_m, d_r, rtol=5e-2, err_msg=desc)


class TestIRStart:
    def test_find_ir_start(self, ref):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        np.testing.assert_array_equal(
            ra.find_ir_start(rir_m),
            ref.room_acoustics.find_ir_start(rir_r),
        )


class TestModes:
    def test_find_modes_close_to_reference(self, ref):
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        m = ra.find_modes(rir_m, [60, 180])
        r = ref.room_acoustics.find_modes(rir_r, [60, 180])
        assert len(m) == len(r)
        np.testing.assert_allclose(m, r, atol=2.0)


class TestSyntheticRIR:
    def test_ism_rir_vs_reference(self, ref, close):
        room_m = ra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
        room_r = ref.room_acoustics.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
        rir_m = ra.generate_synthetic_rir(
            room_m, [1.0, 1.0, 1.0], [2.5, 2.0, 1.2], 16000,
            max_order=12,
        )
        rir_r = ref.room_acoustics.generate_synthetic_rir(
            room_r, [1.0, 1.0, 1.0], [2.5, 2.0, 1.2], 16000,
            max_order=12,
        )
        close(rir_m.time_data, rir_r.time_data, 5e-4, "ISM rir")

    def test_ism_device_path_matches_host_oracle(self):
        """The fp32 device lattice with double-single index arithmetic
        must place every image in the SAME sample bin as the f64 host
        oracle (zero support differences), with fp32-level values."""
        from dsptoolbox_jax.room_acoustics import _backend as bk

        room = ra.ShoeboxRoom([6.07, 5.13, 3.01], t60_s=0.5)
        for mo in (8, 14):
            bk.set_ism_device(False)
            host = ra.generate_synthetic_rir(
                room, [1.23, 2.17, 1.31], [4.29, 1.17, 1.63], 44100,
                max_order=mo,
            )
            bk.set_ism_device(True)
            dev = ra.generate_synthetic_rir(
                room, [1.23, 2.17, 1.31], [4.29, 1.17, 1.63], 44100,
                max_order=mo,
            )
            bk.set_ism_device(None)
            a = np.asarray(host.time_data)[:, 0]
            b = np.asarray(dev.time_data)[:, 0]
            np.testing.assert_array_equal(
                np.nonzero(a)[0], np.nonzero(b)[0]
            )
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-7 * np.max(np.abs(a)))

    def test_batched_ism_matches_single(self):
        from dsptoolbox_jax.room_acoustics import batch_synthetic_rirs
        from dsptoolbox_jax.room_acoustics import _backend as bk

        room = ra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
        rng = np.random.default_rng(3)
        B = 4
        s = rng.uniform([0.3] * 3, [3.7, 2.7, 2.2], (B, 3))
        r = rng.uniform([0.3] * 3, [3.7, 2.7, 2.2], (B, 3))
        rirs = np.asarray(
            batch_synthetic_rirs(room, s, r, 16000, max_order=10)
        )
        assert rirs.shape == (B, 8000)
        for b in range(B):
            bk.set_ism_device(False)
            single = np.asarray(
                ra.generate_synthetic_rir(
                    room, s[b], r[b], 16000, max_order=10
                ).time_data
            )[:, 0]
            bk.set_ism_device(None)
            nz_b, nz_s = np.nonzero(rirs[b])[0], np.nonzero(single)[0]
            np.testing.assert_array_equal(nz_b, nz_s)
            # single-RIR path constrains amplitude; compare up to scale
            scale = single[nz_s[0]] / rirs[b][nz_b[0]]
            np.testing.assert_allclose(
                rirs[b] * scale, single,
                rtol=0, atol=1e-5 * np.max(np.abs(single)),
            )

    def test_room_properties(self, ref):
        room_m = ra.ShoeboxRoom([5.0, 4.0, 3.0], t60_s=0.6)
        room_r = ref.room_acoustics.ShoeboxRoom([5.0, 4.0, 3.0], t60_s=0.6)
        assert np.isclose(room_m.volume, room_r.volume)
        assert np.isclose(
            room_m.absorption_coefficient, room_r.absorption_coefficient
        )
        assert np.isclose(
            room_m.schroeders_frequency, room_r.schroeders_frequency
        )
        modes_m = room_m.get_room_modes(4)
        modes_r = room_r.get_room_modes(4)
        np.testing.assert_allclose(modes_m, modes_r, rtol=1e-9)

    def test_mixing_time(self, ref):
        room_m = ra.ShoeboxRoom([5.0, 4.0, 3.0], t60_s=0.6)
        room_r = ref.room_acoustics.ShoeboxRoom([5.0, 4.0, 3.0], t60_s=0.6)
        assert np.isclose(
            room_m.get_mixing_time("perceptual"),
            room_r.get_mixing_time("perceptual"),
        )
        assert np.isclose(
            room_m.get_mixing_time("physical", 400),
            room_r.get_mixing_time("physical", 400),
        )

    def test_analytical_transfer_function(self, ref, close):
        room_m = ra.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
        room_r = ref.room_acoustics.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
        freqs = np.linspace(20, 300, 100)
        p_m, modes_m, _ = room_m.get_analytical_transfer_function(
            [1.0, 1.0, 1.0], [2.5, 2.0, 1.2], freqs,
            max_mode_order=6, generate_plot=False,
        )
        p_r, modes_r, _ = room_r.get_analytical_transfer_function(
            [1.0, 1.0, 1.0], [2.5, 2.0, 1.2], freqs,
            max_mode_order=6, generate_plot=False,
        )
        close(np.abs(p_m), np.abs(p_r), 1e-4, "analytical tf")


class TestConvolveRIR:
    def test_convolve_vs_reference(self, ref, close):
        rng = np.random.default_rng(0)
        noise = rng.standard_normal((8000, 2)) * 0.3
        rir_m = dsp.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        rir_r = ref.ImpulseResponse(f"{EXAMPLE}/rir.wav")
        s_m = dsp.Signal(None, noise, 48000)
        s_r = ref.Signal(None, noise.copy(), 48000)
        out_m = ra.convolve_rir_on_signal(s_m, rir_m)
        out_r = ref.room_acoustics.convolve_rir_on_signal(s_r, rir_r)
        close(out_m.time_data, out_r.time_data, 5e-5, "convolve rir")


class TestBatchedDescriptors:
    """Batched device descriptor battery (BASELINE config 4)."""

    def _fleet(self, n=8):
        import scipy.signal as sig

        rng = np.random.default_rng(0)
        fs = 16000
        T = 8000
        rirs = np.zeros((n, T))
        for i in range(n):
            t60 = 0.2 + 0.05 * i
            tail = rng.standard_normal(T) * np.exp(
                -np.arange(T) / fs * (6.9 / t60)
            )
            b, a = sig.butter(2, 0.4)
            rirs[i] = sig.lfilter(b, a, tail)
            rirs[i, : i * 7] = 0.0  # varying direct-sound delay
            rirs[i, i * 7] = np.max(np.abs(rirs[i])) * 3  # direct peak
        return rirs, fs

    def test_matches_per_rir_reference_path(self, ref):
        rirs, fs = self._fleet()
        out = ra.batch_descriptors(rirs, fs)
        rts = ra.batch_reverb_times(rirs, fs, "T20")
        for i in range(rirs.shape[0]):
            r = ref.ImpulseResponse(None, rirs[i][:, None].copy(), fs)
            d50_ref = ref.room_acoustics.descriptors(
                r, ref.room_acoustics.RoomAcousticsDescriptor.D50
            )[0]
            c80_ref = ref.room_acoustics.descriptors(
                r, ref.room_acoustics.RoomAcousticsDescriptor.C80
            )[0]
            np.testing.assert_allclose(
                float(out["d50"][i]), d50_ref, atol=0.08,
                err_msg=f"d50 row {i}",
            )
            np.testing.assert_allclose(
                float(out["c80"][i]), c80_ref, atol=1.5,
                err_msg=f"c80 row {i}",
            )
            rt_ref, _ = ref.room_acoustics.reverb_time(
                r, ref.room_acoustics.ReverbTime.T20
            )
            np.testing.assert_allclose(
                float(rts[i]), rt_ref[0], rtol=0.15,
                err_msg=f"t20 row {i}",
            )

    def test_jit_batch_shapes(self):
        import jax

        rirs, fs = self._fleet(16)
        fn = jax.jit(lambda r: ra.batch_descriptors(r, fs))
        out = fn(rirs.astype(np.float32))
        assert out["d50"].shape == (16,)
        edc = ra.batch_energy_decay(rirs.astype(np.float32))
        assert edc.shape == rirs.shape
        assert np.all(np.asarray(edc)[:, 0] <= 0.0 + 1e-5)


class TestBatchReverbReviewRegressions:
    def test_edt_ignores_leading_silence_and_matches_convention(self):
        import jax.numpy as jnp

        from dsptoolbox_jax.room_acoustics.batch import batch_reverb_times

        fs = 16000
        T = fs
        t = np.arange(T) / fs
        t60 = 0.5
        decay = np.exp(-3.0 * np.log(10) / t60 * t) * np.sin(
            2 * np.pi * 1000 * t
        )
        delayed = np.zeros(T)
        shift = fs // 4
        delayed[shift:] = decay[: T - shift]
        rirs = np.stack([decay, delayed]).astype(np.float32)

        edt = np.asarray(batch_reverb_times(jnp.asarray(rirs), fs, "EDT"))
        t20 = np.asarray(batch_reverb_times(jnp.asarray(rirs), fs, "T20"))
        # EDT = 0 -> -10 dB time (reference convention): t60/6
        np.testing.assert_allclose(edt, t60 / 6, rtol=0.1)
        np.testing.assert_allclose(t20, t60, rtol=0.05)
        # leading silence must not inflate the estimates
        np.testing.assert_allclose(edt[1], edt[0], rtol=0.05)
