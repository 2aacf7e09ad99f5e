"""Reference aliasing/mutation contracts on the device containers.

The reference hands out its internal numpy buffers
(`classes/signal.py:220`, `classes/spectrum.py:230`); user code mutates
them in place. These tests pin the device-backed emulation: the Signal
write-back host mirror (`classes/signal.py:_AliasedTimeData`) and the
host-authoritative Spectrum storage.
"""

import numpy as np
import pytest

import dsptoolbox_jax as dsp


@pytest.fixture
def noise():
    return dsp.generators.noise(0.25, 8000, seed=4, number_of_channels=2)


class TestSignalMirror:
    def test_setitem_writes_back(self, noise):
        td = noise.time_data
        td[100, 0] = 0.75
        assert noise.time_data[100, 0] == pytest.approx(0.75, abs=1e-6)
        # the device array sees it too
        assert float(noise.time_data_jax[100, 0]) == pytest.approx(
            0.75, abs=1e-6
        )

    def test_view_setitem_writes_back(self, noise):
        view = noise.time_data[:, :1]
        view[5, 0] = -0.5
        assert noise.time_data[5, 0] == pytest.approx(-0.5, abs=1e-6)

    def test_inplace_ufunc_writes_back(self, noise):
        before = noise.time_data.copy()
        td = noise.time_data
        td *= 0.5
        np.testing.assert_allclose(
            noise.time_data, before * 0.5, rtol=1e-6
        )

    def test_augmented_assignment_through_setter(self, noise):
        before = noise.time_data.copy()
        noise.time_data += 0.125
        np.testing.assert_allclose(
            noise.time_data, before + 0.125, rtol=0, atol=1e-6
        )

    def test_mutation_invalidates_spectrum_cache(self, noise):
        noise.activate_cache = True
        f1, sp1 = noise.get_spectrum()
        noise.time_data[: len(noise) // 2, :] = 0.0
        f2, sp2 = noise.get_spectrum()
        assert not np.allclose(np.asarray(sp1), np.asarray(sp2))

    def test_repeated_get_returns_same_mirror(self, noise):
        a = noise.time_data
        b = noise.time_data
        assert a is b

    def test_iter_yields_channel_arrays(self, noise):
        chans = list(noise)
        assert len(chans) == 2
        for c in chans:
            assert isinstance(c, np.ndarray)
            assert c.shape == (len(noise),)
        np.testing.assert_allclose(chans[1], noise.time_data[:, 1])


class TestSpectrumAliasing:
    def test_spectral_data_mutation_writes_through(self):
        freqs = np.array([100.0, 200.0, 300.0])
        spec = dsp.Spectrum(freqs, np.ones((3, 2)))
        spec.spectral_data[:2] = 5.0
        assert np.all(spec.spectral_data[:2] == 5.0)

    def test_channel_list_constructor(self):
        freqs = np.array([100.0, 200.0, 300.0])
        spec = dsp.Spectrum(freqs, [np.zeros(3) for _ in range(2)])
        assert spec.number_of_channels == 2
        assert len(spec) == 3

    def test_reference_dtypes(self):
        freqs = np.array([100.0, 200.0])
        assert dsp.Spectrum(freqs, np.ones((2, 1), np.float32)).\
            spectral_data.dtype == np.float64
        assert dsp.Spectrum(
            freqs, np.ones((2, 1), np.complex64)
        ).spectral_data.dtype == np.complex128


class TestDeviceReturns:
    def test_get_spectrum_return_device(self, noise):
        f, sp = noise.get_spectrum(return_device=True)
        import jax.numpy as jnp

        assert isinstance(sp, jnp.ndarray)  # Welch -> real device array
        f_host, sp_host = noise.get_spectrum(force_computation=True)
        # atol floor for the detrended ~1e-7-noise DC bin
        np.testing.assert_allclose(
            np.asarray(sp), np.asarray(sp_host), rtol=1e-5, atol=1e-6
        )

    def test_get_csm_return_device(self, noise):
        f, C = noise.get_csm(return_device=True)
        from dsptoolbox_jax.classes.signal import DeviceSpectralData

        assert isinstance(C, DeviceSpectralData)
        f2, C_host = noise.get_csm(force_computation=True)
        # atol floor: DC/Nyquist bins are detrended to ~1e-7-level noise
        np.testing.assert_allclose(
            C.to_numpy(), np.asarray(C_host), rtol=1e-4, atol=5e-7
        )

    def test_istft_accepts_device_spectrogram(self, noise):
        noise.set_spectrogram_parameters(window_length_samples=256)
        t, f, S = noise.get_spectrogram(
            force_computation=True, return_device=True
        )
        y = dsp.transforms.istft(S, original_signal=noise)
        np.testing.assert_allclose(
            y.time_data, noise.time_data, rtol=0, atol=5e-5
        )
