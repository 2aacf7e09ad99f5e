"""Parity tests: ops.spectral vs the reference's private backends."""

import numpy as np
import pytest

from dsptoolbox_jax.ops import spectral as sp
from dsptoolbox_jax.standard.enums import SpectrumScaling, Window

from conftest import assert_close

RNG = np.random.default_rng(42)
FS = 48_000
X2 = RNG.standard_normal((FS, 2)) * 0.3  # (T, C) reference convention
X1 = X2[:, 0]
Y2 = RNG.standard_normal((FS, 2)) * 0.3


def _ref_welch(ref, x, y, **kw):
    from dsptoolbox.standard._spectral_methods import _welch

    return _welch(x, y, FS, **kw)


@pytest.mark.parametrize("average", ["mean", "median"])
@pytest.mark.parametrize(
    "scaling",
    [
        SpectrumScaling.PowerSpectralDensity,
        SpectrumScaling.AmplitudeSpectrum,
        SpectrumScaling.FFTBackward,
        SpectrumScaling.FFTOrthogonal,
    ],
)
def test_welch_auto(ref, average, scaling):
    ref_scaling = ref.SpectrumScaling[scaling.name]
    want = _ref_welch(
        ref,
        X2,
        None,
        window_type=ref.Window.Hann,
        window_length_samples=1024,
        overlap_percent=50,
        detrend=True,
        average=average,
        scaling=ref_scaling,
    )
    got = sp.welch(
        X2.T,
        None,
        sampling_rate_hz=FS,
        window_length_samples=1024,
        window_type=Window.Hann,
        overlap_percent=50,
        detrend=True,
        average=average,
        scaling=scaling,
    )
    assert_close(np.asarray(got).T, want, tol=5e-5, name=f"welch-{average}-{scaling}")


@pytest.mark.parametrize("average", ["mean", "median"])
def test_welch_cross(ref, average):
    want = _ref_welch(
        ref,
        X2,
        Y2,
        window_type=ref.Window.Hann,
        window_length_samples=512,
        overlap_percent=75,
        detrend=False,
        average=average,
        scaling=ref.SpectrumScaling.PowerSpectralDensity,
    )
    got = sp.welch(
        X2.T,
        Y2.T,
        sampling_rate_hz=FS,
        window_length_samples=512,
        window_type=Window.Hann,
        overlap_percent=75,
        detrend=False,
        average=average,
        scaling=SpectrumScaling.PowerSpectralDensity,
    )
    assert_close(np.asarray(got).T, want, tol=5e-5, name=f"welch-cross-{average}")


@pytest.mark.parametrize("window_type", [Window.Hann, Window.Flattop])
@pytest.mark.parametrize(
    "scaling",
    [
        SpectrumScaling.FFTBackward,
        SpectrumScaling.AmplitudeSpectrum,
        SpectrumScaling.PowerSpectralDensity,
    ],
)
def test_stft(ref, window_type, scaling):
    from dsptoolbox.standard._spectral_methods import _stft

    import warnings

    kw = dict(
        window_length_samples=512,
        overlap_percent=50,
        fft_length_samples=1024,
        detrend=False,
        padding=True,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t_ref, f_ref, S_ref = _stft(
            X2,
            FS,
            window_type=ref.Window[window_type.name],
            scaling=ref.SpectrumScaling[scaling.name],
            **kw,
        )
        t, f, S = sp.stft(
            X2.T,
            sampling_rate_hz=FS,
            window_type=window_type,
            scaling=scaling,
            **kw,
        )
    np.testing.assert_allclose(t, t_ref, rtol=1e-12)
    np.testing.assert_allclose(f, f_ref, rtol=1e-12)
    # ours: (C, n_frames, F) → reference (F, n_frames, C)
    got = np.transpose(np.asarray(S), (2, 1, 0))
    assert_close(got, S_ref, tol=5e-5, name=f"stft-{window_type}-{scaling}")


@pytest.mark.parametrize("average", ["mean", "median"])
@pytest.mark.parametrize(
    "scaling",
    [SpectrumScaling.PowerSpectralDensity, SpectrumScaling.AmplitudeSpectrum],
)
def test_csm_welch(ref, average, scaling):
    from dsptoolbox.standard._spectral_methods import _csm_welch

    x = RNG.standard_normal((16384, 3)) * 0.2
    f_ref, csm_ref = _csm_welch(
        x,
        FS,
        window_length_samples=512,
        window_type=ref.Window.Hann,
        overlap_percent=50,
        detrend=True,
        average=average,
        scaling=ref.SpectrumScaling[scaling.name],
    )
    f, csm = sp.csm_welch(
        x.T,
        sampling_rate_hz=FS,
        window_length_samples=512,
        window_type=Window.Hann,
        overlap_percent=50,
        detrend=True,
        average=average,
        scaling=scaling,
    )
    np.testing.assert_allclose(f, f_ref, rtol=1e-12)
    assert_close(np.asarray(csm), csm_ref, tol=5e-5, name=f"csm-{average}-{scaling}")


@pytest.mark.parametrize(
    "scaling",
    [
        SpectrumScaling.FFTBackward,
        SpectrumScaling.PowerSpectrum,
        SpectrumScaling.AmplitudeSpectralDensity,
    ],
)
def test_csm_from_spectrum(ref, scaling):
    from dsptoolbox.standard._spectral_methods import _csm_fft

    spec = np.fft.rfft(RNG.standard_normal((4096, 3)), axis=0)
    want = _csm_fft(spec, ref.SpectrumScaling[scaling.name], None, FS)
    got = sp.csm_from_spectrum(spec, scaling, None, FS)
    assert_close(np.asarray(got), want, tol=5e-5, name=f"csmfft-{scaling}")


def test_framing_roundtrip():
    import jax.numpy as jnp

    from dsptoolbox_jax.ops import frame_signal, reconstruct_framed_signal
    from dsptoolbox_jax.ops.windows import get_window

    x = RNG.standard_normal((2, 10_000)).astype(np.float32)
    w = get_window(Window.Hann, 512, symmetric=False)
    frames = frame_signal(jnp.asarray(x), 512, 256) * jnp.asarray(
        w, dtype=jnp.float32
    )
    rec = reconstruct_framed_signal(
        frames, 256, window=w, original_signal_length=10_000
    )
    # COLA window² reconstruction is exact away from the un-padded edges
    assert_close(
        np.asarray(rec)[:, 512:-1024], x[:, 512:-1024], tol=1e-5, name="ola"
    )


def test_wav_reader_against_scipy():
    import scipy.io.wavfile as wavfile

    from dsptoolbox_jax.io import read_wav

    for name in ["rir.wav", "chirp.wav", "fuer_elise.wav", "chirp_stereo.wav"]:
        path = f"/root/reference/example_data/{name}"
        fs_ref, data_ref = wavfile.read(path)
        if data_ref.dtype == np.int16:
            data_ref = data_ref / 2.0**15
        elif data_ref.dtype == np.int32:
            data_ref = data_ref / 2.0**31
        data, fs = read_wav(path)
        assert fs == fs_ref
        np.testing.assert_allclose(data, data_ref, atol=0)


def test_power_spectrogram_device_tf_parity():
    # _get_power_spectrogram_device hand-mirrors stft's t/f construction
    # (host-side, to avoid device-constant fetches); guard against the two
    # drifting apart, and check the power values themselves
    import dsptoolbox_jax as dsp

    rng = np.random.default_rng(12)
    s = dsp.Signal(None, rng.standard_normal((48000, 2)) * 0.3, 24000)
    t_ref, f_ref, S = s.get_spectrogram()
    t_dev, f_dev, P = s._get_power_spectrogram_device()
    np.testing.assert_allclose(t_dev, np.asarray(t_ref), rtol=1e-12)
    np.testing.assert_allclose(f_dev, np.asarray(f_ref), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(P),
        np.abs(np.asarray(S)) ** 2,
        rtol=1e-4,
        atol=1e-10,
    )


class TestWindowedFrames:
    @pytest.mark.parametrize("detrend", [True, False])
    def test_matches_numpy_stride_framing(self, detrend):
        """`_windowed_frames` (frame, window, per-frame demean) against
        numpy stride framing of the zero-padded signal."""
        import jax.numpy as jnp

        from dsptoolbox_jax.ops.spectral import _windowed_frames

        L, S, T, B = 512, 256, 4096, 8
        rng = np.random.default_rng(0)
        x = rng.standard_normal((B, T)).astype(np.float32)
        win = np.hanning(L).astype(np.float32)
        n_frames = -(-T // S)
        xp = np.pad(x, ((0, 0), (0, (n_frames - 1) * S + L - T)))
        want = np.lib.stride_tricks.sliding_window_view(xp, L, axis=-1)[
            :, ::S
        ] * win
        if detrend:
            want = want - want.mean(axis=-1, keepdims=True)
        got = np.asarray(_windowed_frames(jnp.asarray(x), win, S, detrend))
        assert got.shape == want.shape == (B, n_frames, L)
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestGeneralLengthFFT:
    """`jnp.fft` at lengths that are not powers of two (odd, 3·2^k,
    5-smooth, prime) must be an exact DFT: the library pads FFTs to such
    lengths (`ops.fft_conv.next_fast_len`)."""

    @pytest.mark.parametrize("n", [7, 96, 1000, 1013])
    def test_matches_numpy(self, n):
        import jax.numpy as jnp

        rng = np.random.default_rng(n)
        x = rng.standard_normal((3, n)).astype(np.float32)
        got = np.asarray(jnp.fft.rfft(jnp.asarray(x), axis=-1))
        want = np.fft.rfft(x.astype(np.float64), axis=-1)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5
        back = np.asarray(jnp.fft.irfft(jnp.asarray(got), n=n, axis=-1))
        assert np.max(np.abs(back - x)) < 1e-5
        z = (
            rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
        ).astype(np.complex64)
        Z = np.asarray(jnp.fft.fft(jnp.asarray(z), axis=-1))
        wantZ = np.fft.fft(z.astype(np.complex128), axis=-1)
        assert np.max(np.abs(Z - wantZ)) / np.max(np.abs(wantZ)) < 1e-5
        back2 = np.asarray(jnp.fft.ifft(jnp.asarray(Z), axis=-1))
        assert np.max(np.abs(back2 - z)) < 1e-4

    @pytest.mark.parametrize("n", [12, 13])
    def test_irfft_short_spectrum(self, n):
        """irfft with fewer than n//2+1 bins zero-pads the half spectrum
        before mirroring (numpy semantics)."""
        import jax.numpy as jnp

        rng2 = np.random.default_rng(1)
        spec = (
            rng2.standard_normal(3) + 1j * rng2.standard_normal(3)
        ).astype(np.complex64)
        got = np.asarray(jnp.fft.irfft(jnp.asarray(spec), n=n, axis=-1))
        want = np.fft.irfft(spec, n=n, axis=-1)
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestReviewRegressions:
    """Regressions from the round-1 ops code review."""

    def test_stft_zero_step_raises(self):
        import jax.numpy as jnp

        x = np.zeros((1, 256), np.float32)
        with pytest.raises(ValueError, match="hop size"):
            sp.stft(
                jnp.asarray(x),
                sampling_rate_hz=48000,
                window_length_samples=16,
                overlap_percent=97.0,
            )

    def test_csm_median_chunked_matches_reference(self, ref):
        """The chunked median path must still match the reference oracle."""
        from dsptoolbox.standard._spectral_methods import _csm_welch

        rng2 = np.random.default_rng(7)
        x = rng2.standard_normal((2048, 3))
        f_ref, csm_ref = _csm_welch(
            x,
            48000,
            window_length_samples=256,
            window_type=ref.Window.Hann,
            overlap_percent=50,
            detrend=True,
            average="median",
            scaling=ref.SpectrumScaling.FFTBackward,
        )
        f_got, csm_got = sp.csm_welch(
            x.T,
            sampling_rate_hz=48000,
            window_length_samples=256,
            window_type=Window.Hann,
            overlap_percent=50,
            detrend=True,
            average="median",
            scaling=SpectrumScaling.FFTBackward,
        )
        np.testing.assert_allclose(np.asarray(f_got), f_ref)
        assert_close(
            np.asarray(csm_got), csm_ref, tol=5e-5, name="csm-median-chunked"
        )

    def test_frame_signal_short_input_empty(self):
        import jax.numpy as jnp

        from dsptoolbox_jax.ops import frame_signal

        x = jnp.ones((2, 100), jnp.float32)
        frames = frame_signal(x, 512, 256, keep_last_frames=False)
        assert frames.shape == (2, 0, 512)
