"""IO tests: WAV round-trips and the native FLAC decoder."""

import numpy as np
import pytest

import dsptoolbox_jax as dsp
from dsptoolbox_jax.io import read_audio, write_audio
from dsptoolbox_jax.io.flac import read_flac

EXAMPLE = "/root/reference/example_data"


class TestWav:
    @pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "FLOAT"])
    def test_roundtrip(self, tmp_path, subtype):
        rng = np.random.default_rng(0)
        data = np.clip(rng.standard_normal((1000, 2)) * 0.3, -1, 0.999)
        path = str(tmp_path / "x.wav")
        write_audio(path, data, 48000, subtype)
        back, fs = read_audio(path)
        assert fs == 48000
        tol = {"PCM_16": 2**-15, "PCM_24": 2**-23, "FLOAT": 1e-7}[subtype]
        np.testing.assert_allclose(back, data, atol=tol)

    def test_example_data_wavs(self):
        for name in ["chirp.wav", "rir.wav", "fuer_elise.wav"]:
            data, fs = read_audio(f"{EXAMPLE}/{name}")
            assert fs > 0 and len(data) > 0

    def test_rf64(self, tmp_path):
        # Synthesize an RF64 file (EBU 3306): 0xFFFFFFFF placeholder sizes,
        # real 64-bit sizes in the mandatory ds64 chunk.
        import struct

        rng = np.random.default_rng(1)
        data = np.clip(rng.standard_normal((500, 2)) * 0.3, -1, 0.999)
        ints = np.clip(np.round(data * 2.0**15), -(2**15), 2**15 - 1)
        payload = ints.astype("<i2").tobytes()
        fmt = struct.pack("<HHIIHH", 1, 2, 48000, 48000 * 4, 4, 16)
        ds64 = struct.pack("<QQQI", 0, len(payload), data.shape[0], 0)
        path = tmp_path / "x_rf64.wav"
        with open(path, "wb") as fh:
            fh.write(struct.pack("<4sI4s", b"RF64", 0xFFFFFFFF, b"WAVE"))
            fh.write(struct.pack("<4sI", b"ds64", len(ds64)) + ds64)
            fh.write(struct.pack("<4sI", b"fmt ", len(fmt)) + fmt)
            fh.write(struct.pack("<4sI", b"data", 0xFFFFFFFF) + payload)
        back, fs = read_audio(str(path))
        assert fs == 48000
        np.testing.assert_allclose(back, data, atol=2**-15)

    def test_riff_streaming_placeholder_size_reads_to_eof(self, tmp_path):
        # plain RIFF with 0xFFFFFFFF data size (interrupted/streaming
        # writers): data runs to end of file — must NOT be treated as RF64
        import struct

        rng = np.random.default_rng(2)
        data = np.clip(rng.standard_normal((300, 1)) * 0.3, -1, 0.999)
        ints = np.clip(np.round(data * 2.0**15), -(2**15), 2**15 - 1)
        payload = ints.astype("<i2").tobytes()
        fmt = struct.pack("<HHIIHH", 1, 1, 48000, 96000, 2, 16)
        path = tmp_path / "stream.wav"
        with open(path, "wb") as fh:
            fh.write(struct.pack("<4sI4s", b"RIFF", 0xFFFFFFFF, b"WAVE"))
            fh.write(struct.pack("<4sI", b"fmt ", len(fmt)) + fmt)
            fh.write(struct.pack("<4sI", b"data", 0xFFFFFFFF) + payload)
        back, fs = read_audio(str(path))
        assert fs == 48000
        np.testing.assert_allclose(back[:, None], data, atol=2**-15)

    def test_rf64_without_ds64_rejected(self, tmp_path):
        import struct

        path = tmp_path / "bad_rf64.wav"
        with open(path, "wb") as fh:
            fh.write(struct.pack("<4sI4s", b"RF64", 0xFFFFFFFF, b"WAVE"))
            fmt = struct.pack("<HHIIHH", 1, 1, 48000, 96000, 2, 16)
            fh.write(struct.pack("<4sI", b"fmt ", len(fmt)) + fmt)
            fh.write(struct.pack("<4sI", b"data", 0xFFFFFFFF) + b"\x00\x00")
        with pytest.raises(ValueError, match="ds64"):
            read_audio(str(path))


class TestFlac:
    def test_decode_speech(self):
        data, fs = read_flac(f"{EXAMPLE}/speech.flac")
        # STREAMINFO of the file: mono, 48 kHz, 16 bit, 189056 samples
        assert fs == 48000
        assert data.shape == (189056,)
        assert np.max(np.abs(data)) <= 1.0
        # 16-bit PCM: scaled samples must be exact integers
        scaled = data * 32768.0
        np.testing.assert_array_equal(scaled, np.round(scaled))

    def test_no_frame_boundary_discontinuities(self):
        # a mis-decoded predictor/residual would break sample continuity
        # at the 4096-sample frame boundaries
        data, _ = read_flac(f"{EXAMPLE}/speech.flac")
        d = np.abs(np.diff(data))
        bidx = np.arange(4095, len(d), 4096)
        mask = np.zeros(len(d), bool)
        mask[bidx] = True
        assert d[mask].mean() < 5 * d[~mask].mean()

    def test_signal_loads_flac(self):
        s = dsp.Signal(f"{EXAMPLE}/speech.flac")
        assert s.sampling_rate_hz == 48000
        assert s.number_of_channels == 1
        assert len(s) == 189056


class TestFlacWrite:
    @pytest.mark.parametrize("bits", [16, 24])
    def test_roundtrip(self, tmp_path, bits):
        rng = np.random.default_rng(1)
        data = np.clip(rng.standard_normal((10000, 2)) * 0.3, -1, 0.999)
        path = str(tmp_path / "x.flac")
        from dsptoolbox_jax.io.flac import write_flac

        write_flac(path, data, 44100, bits)
        back, fs = read_audio(path)
        assert fs == 44100
        np.testing.assert_allclose(back, data, atol=2 ** -(bits - 1))

    def test_signal_save_flac(self, tmp_path):
        s = dsp.Signal(f"{EXAMPLE}/chirp_mono.wav")
        path = str(tmp_path / "s.flac")
        s.save_signal(path, mode="flac", bit_depth=24)
        s2 = dsp.Signal(path)
        assert s2.sampling_rate_hz == s.sampling_rate_hz
        np.testing.assert_allclose(
            s2.time_data, s.time_data, atol=2**-22
        )


class TestSafeSerialization:
    """npz+JSON persistence (`io/serialization.py`), the safe replacement
    for the reference's pickle saves (`classes/signal.py:1604-1606`)."""

    def test_signal_roundtrip(self, tmp_path):
        rng = np.random.default_rng(3)
        s = dsp.Signal(None, rng.standard_normal((500, 2)) * 0.4, 44100)
        path = dsp.io.save_object(s, str(tmp_path / "sig"))
        s2 = dsp.io.load_object(path)
        assert type(s2).__name__ == "Signal"
        assert s2.sampling_rate_hz == 44100
        np.testing.assert_allclose(s2.time_data, s.time_data)

    def test_impulse_response_with_window_roundtrip(self, tmp_path):
        rng = np.random.default_rng(4)
        td = rng.standard_normal(256) * np.exp(-np.arange(256) / 30.0)
        ir = dsp.ImpulseResponse.from_time_data(td, 48000)
        ir.window = np.hanning(256)
        path = dsp.io.save_object(ir, str(tmp_path / "ir.npz"))
        ir2 = dsp.io.load_object(path)
        assert type(ir2).__name__ == "ImpulseResponse"
        np.testing.assert_allclose(ir2.time_data, ir.time_data)
        np.testing.assert_allclose(ir2.window, ir.window)

    def test_filter_roundtrips_all_representations(self, tmp_path):
        from dsptoolbox_jax.standard.enums import FilterCoefficientsType as FT

        filts = {
            "sos": dsp.Filter.iir_filter(
                4, 1000.0, dsp.standard.enums.FilterPassType.Lowpass,
                sampling_rate_hz=48000,
            ),
            "ba": dsp.Filter.fir_filter(
                32, 2000.0, dsp.standard.enums.FilterPassType.Lowpass,
                sampling_rate_hz=48000,
            ),
        }
        for name, f in filts.items():
            path = dsp.io.save_object(f, str(tmp_path / name))
            f2 = dsp.io.load_object(path)
            assert f2.sampling_rate_hz == f.sampling_rate_hz
            c1 = f.get_coefficients(FT.Ba)
            c2 = f2.get_coefficients(FT.Ba)
            np.testing.assert_allclose(c2[0], c1[0], rtol=1e-12)
            np.testing.assert_allclose(c2[1], c1[1], rtol=1e-12)

    def test_filterbank_roundtrip(self, tmp_path):
        fb, _, _ = dsp.filterbanks.fractional_octave_bands(
            frequency_range_hz=[250, 2000], sampling_rate_hz=24000
        )
        path = dsp.io.save_object(fb, str(tmp_path / "fb"))
        fb2 = dsp.io.load_object(path)
        assert fb2.number_of_filters == fb.number_of_filters
        np.testing.assert_allclose(
            fb2.filters[0].sos, fb.filters[0].sos, rtol=1e-12
        )

    def test_multiband_roundtrip(self, tmp_path):
        rng = np.random.default_rng(5)
        bands = [
            dsp.Signal(None, rng.standard_normal((300, 1)) * 0.2, 16000)
            for _ in range(3)
        ]
        mb = dsp.MultiBandSignal(bands)
        path = dsp.io.save_object(mb, str(tmp_path / "mb"))
        mb2 = dsp.io.load_object(path)
        assert mb2.number_of_bands == 3
        for b1, b2 in zip(mb.bands, mb2.bands):
            np.testing.assert_allclose(b2.time_data, b1.time_data)

    def test_spectrum_roundtrip(self, tmp_path):
        f = np.linspace(10, 1000, 128)
        sp = dsp.Spectrum(f, np.abs(np.sin(f / 50.0)) + 0.1)
        path = dsp.io.save_object(sp, str(tmp_path / "spec"))
        sp2 = dsp.io.load_object(path)
        np.testing.assert_allclose(
            sp2.frequency_vector_hz, sp.frequency_vector_hz
        )
        np.testing.assert_allclose(sp2.spectral_data, sp.spectral_data)

    def test_rejects_unknown_type(self, tmp_path):
        with pytest.raises(TypeError):
            dsp.io.save_object(object(), str(tmp_path / "bad"))


class TestIoReviewRegressions:
    def test_wide_buffer_preserved(self, tmp_path):
        """(frames, channels) is preserved as-is like soundfile — no
        orientation guessing for wide buffers."""
        from dsptoolbox_jax.io import read_audio, write_audio

        rng = np.random.default_rng(61)
        data = rng.standard_normal((3, 8)) * 0.4  # 3 frames, 8 channels
        p = str(tmp_path / "wide.wav")
        write_audio(p, data, 8000, "FLOAT")
        back, fs = read_audio(p)
        assert back.shape == (3, 8)
        np.testing.assert_allclose(back, data, atol=1e-6)

    def test_riff_size_includes_pad_byte(self, tmp_path):
        import os
        import struct

        from dsptoolbox_jax.io import write_audio

        rng = np.random.default_rng(62)
        data = rng.standard_normal((5, 1)) * 0.4  # 5*3 bytes: odd payload
        p = str(tmp_path / "odd.wav")
        write_audio(p, data, 8000, "PCM_24")
        with open(p, "rb") as fh:
            _, riff_size, _ = struct.unpack("<4sI4s", fh.read(12))
        assert riff_size + 8 == os.path.getsize(p)

    def test_flac_bad_subtype_raises(self, tmp_path):
        from dsptoolbox_jax.io import write_audio

        with pytest.raises(ValueError, match="not supported for FLAC"):
            write_audio(
                str(tmp_path / "x.flac"), np.zeros((16, 1)), 8000, "FLOAT"
            )


class TestAppendSpectraReference:
    def test_interpolates_to_first_frequency_vector(self, ref):
        import dsptoolbox_jax as dsp

        rng = np.random.default_rng(63)
        f1 = np.linspace(10.0, 1000.0, 128)
        f2 = np.linspace(10.0, 1000.0, 200)
        d1 = np.abs(rng.standard_normal((128, 1))) + 0.1
        d2 = np.abs(rng.standard_normal((200, 2))) + 0.1
        got = dsp.append_spectra(
            [dsp.Spectrum(f1, d1.copy()), dsp.Spectrum(f2, d2.copy())]
        )
        want = ref.append_spectra(
            [ref.Spectrum(f1, d1.copy()), ref.Spectrum(f2, d2.copy())]
        )
        np.testing.assert_allclose(
            got.frequency_vector_hz, want.frequency_vector_hz
        )
        np.testing.assert_allclose(
            np.asarray(got.spectral_data), want.spectral_data, rtol=1e-5,
            atol=1e-8,
        )
