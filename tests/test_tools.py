"""Tools-module tests mirroring the reference's `tests/test_tools.py`."""

import numpy as np
import pytest

import dsptoolbox_jax as dsp


class TestToolsFunctionality:
    def test_basic_functions(self):
        x = np.linspace(100, 150, 30)
        fv = dsp.tools.log_frequency_vector([20, 200], 50)
        assert np.all(np.diff(fv) > 0)
        dsp.tools.frequency_crossover([100, 200], True)(x)
        dsp.tools.log_mean(x)
        dsp.tools.to_db(x, True, None, None)
        dsp.tools.from_db(x, True)
        dsp.tools.time_smoothing(x, 200, 0.1, None)
        dsp.tools.time_smoothing(x, 200, 0.1, 0.2)
        dsp.tools.fractional_octave_frequencies()
        dsp.tools.erb_frequencies()

    def test_db_roundtrip(self):
        x = np.abs(np.random.default_rng(0).standard_normal(64)) + 0.1
        np.testing.assert_allclose(
            dsp.tools.from_db(dsp.tools.to_db(x, True), True), x,
            rtol=1e-5,
        )


class TestFramedSignal:
    def test_roundtrip(self):
        # non-overlapping frames: plain OLA is an exact inverse (with 50%
        # overlap and no window, OLA doubles the interior by design)
        rng = np.random.default_rng(1)
        for ch in (1, 2):
            n = rng.normal(0, 0.1, (100, ch))
            frames = dsp.tools.framed_signal(n, 20, 20, False)
            rec = dsp.tools.reconstruct_from_framed_signal(
                frames, 20, None, len(n)
            )
            # the frame-count convention (`helpers/other.py:212`,
            # ceil((L-W)/step)) drops the final full frame when L is an
            # exact multiple of the step — only 80 of 100 samples covered
            assert frames.shape[1] == 4
            np.testing.assert_allclose(
                np.asarray(rec)[:80], n[:80], atol=1e-5
            )

    def test_frame_content_vs_reference(self, ref):
        rng = np.random.default_rng(2)
        n = rng.normal(0, 0.1, (100, 2))
        f_m = np.asarray(dsp.tools.framed_signal(n, 20, 10, True))
        f_r = ref.tools.framed_signal(n, 20, 10, True)
        np.testing.assert_allclose(f_m, f_r, atol=1e-6)
        f_m = np.asarray(dsp.tools.framed_signal(n, 20, 10, False))
        f_r = ref.tools.framed_signal(n, 20, 10, False)
        np.testing.assert_allclose(f_m, f_r, atol=1e-6)


class TestSampleConversion:
    def test_f64_to_int_formats(self):
        v = np.array([0.0, 1.0, -1.0, 0.5])
        np.testing.assert_equal(
            v,
            dsp.tools.convert_sample_representation(
                v, "f64", "f32", True
            )[0],
        )
        with pytest.raises(AssertionError):
            dsp.tools.convert_sample_representation(v, "f64", "f64", True)
        for t in ["u8", "u16", "u32", "i8", "i16", "i32"]:
            out, eq, max_val = dsp.tools.convert_sample_representation(
                v, "f64", t, True
            )
            np.testing.assert_equal(
                out,
                np.array(
                    [eq, eq + max_val, eq - max_val, eq + max_val // 2]
                ),
            )
        for t in ["i24", "u24"]:
            out, eq, max_val = dsp.tools.convert_sample_representation(
                v, "f64", t, False
            )
            np.testing.assert_equal(
                out,
                np.array(
                    [eq, eq + max_val, eq - max_val, eq + max_val // 2]
                ),
            )

    def test_int_formats_to_f64(self):
        for f in ["i8", "u8", "i16", "u16", "i24", "u24", "i32", "u32"]:
            bits = int(f[1:])
            signed = f[0] == "i"
            val = 2 ** (bits - 1) - 1
            eq = 0 if signed else val
            v = np.array([eq, eq + val, eq - val])
            np.testing.assert_equal(
                np.array([0, 1.0, -1.0]),
                dsp.tools.convert_sample_representation(
                    v, f, "f64", False
                )[0],
            )

    def test_bytes_roundtrip(self):
        inp = np.array([0.0, 1.0, -1.0, 0.5])
        for t in ["i24", "u24", "i32", "f32"]:
            b = dsp.tools.convert_sample_representation(
                inp, "f64", t, True, True
            )[0]
            outp = dsp.tools.convert_sample_representation(
                b, t, "f64", True, True
            )[0]
            np.testing.assert_allclose(inp, outp, atol=1e-4)


class TestFractionalOctaveSmoothing:
    def test_lin_log_consistency(self):
        fs_hz = 48000
        lin_freqs = np.fft.rfftfreq(10000, 1 / fs_hz)[:-1]
        filt = dsp.Filter.biquad(
            dsp.BiquadEqType.Peaking, 200.0, 1.0, 0.8, fs_hz
        )
        transfer_lin = np.abs(filt.get_transfer_function(lin_freqs))
        smoothed_lin = dsp.tools.fractional_octave_smoothing(
            transfer_lin, None, 8.0
        )
        log_freqs = dsp.tools.log_frequency_vector([10, 10e3], 128)
        transfer_log = np.abs(filt.get_transfer_function(log_freqs))
        smoothed_log = dsp.tools.fractional_octave_smoothing(
            transfer_log, None, 8.0
        )
        smoothed_lin_log = dsp.tools.interpolate_fr(
            lin_freqs, smoothed_lin, log_freqs, mode="amplitude2power"
        )
        np.testing.assert_allclose(
            dsp.tools.to_db(np.asarray(smoothed_lin_log), True),
            dsp.tools.to_db(np.asarray(smoothed_log), True),
            atol=0.02,
        )
