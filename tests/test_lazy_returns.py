"""Lazy host returns: default getters hand out device-backed arrays that
behave like the reference's numpy returns and fetch only on host access.

Covers the wrapper's numpy protocol surface, the getter wiring (fp32 lazy
vs f64 eager), zero-fetch consumption by library functions, and the
copy/pickle/mutation semantics the reference's eager returns imply.
"""

import copy
import pickle

import numpy as np
import pytest

import dsptoolbox_jax as dsp
from dsptoolbox_jax import _config
from dsptoolbox_jax.classes.lazy_array import (
    LazyHostArray,
    materialize_all,
)

EXAMPLE = "/root/reference/example_data"


@pytest.fixture
def speech():
    s = dsp.Signal(f"{EXAMPLE}/speech.flac")
    s.set_spectrogram_parameters(window_length_samples=1024)
    return s


@pytest.fixture
def stereo():
    return dsp.Signal(f"{EXAMPLE}/chirp_stereo.wav")


def _eager(call):
    _config.set_lazy_host_returns(False)
    try:
        return call()
    finally:
        _config.set_lazy_host_returns(None)


class TestGetterWiring:
    def test_spectrum_lazy_and_matching(self, speech):
        f, sp = speech.get_spectrum(force_computation=True)
        assert isinstance(sp, LazyHostArray)
        assert not sp.is_materialized
        f_e, sp_e = _eager(
            lambda: speech.get_spectrum(force_computation=True)
        )
        np.testing.assert_allclose(f, f_e)
        np.testing.assert_allclose(
            np.asarray(sp), np.asarray(sp_e), rtol=5e-4, atol=1e-5
        )

    def test_mono_welch_spectrum_is_1d(self, speech):
        _, sp = speech.get_spectrum(force_computation=True)
        assert sp.ndim == 1  # reference squeezes mono Welch spectra

    def test_csm_lazy_and_matching(self, stereo):
        f, C = stereo.get_csm(force_computation=True)
        assert isinstance(C, LazyHostArray)
        assert np.dtype(C.dtype).kind == "c"
        f_e, C_e = _eager(
            lambda: stereo.get_csm(force_computation=True)
        )
        np.testing.assert_allclose(
            np.asarray(C), np.asarray(C_e), rtol=5e-4, atol=1e-6
        )

    def test_spectrogram_lazy_and_matching(self, speech):
        t, f, S = speech.get_spectrogram(force_computation=True)
        assert isinstance(S, LazyHostArray)
        t_e, f_e, S_e = _eager(
            lambda: speech.get_spectrogram(force_computation=True)
        )
        np.testing.assert_allclose(t, np.asarray(t_e), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(f, np.asarray(f_e))
        np.testing.assert_allclose(
            np.asarray(S), np.asarray(S_e), rtol=5e-4, atol=1e-5
        )

    def test_f64_mode_returns_plain_numpy(self, speech):
        # the drop-in compat mode must stay eagerly materialized
        assert _config.lazy_host_returns()
        _config.set_default_float("float64")
        try:
            assert not _config.lazy_host_returns()
        finally:
            _config.set_default_float("float32")

    def test_istft_consumes_without_materializing(self, speech):
        _, _, S = speech.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=speech)
        assert not S.is_materialized
        np.testing.assert_allclose(
            np.asarray(y.time_data[:, 0]),
            np.asarray(speech.time_data[:, 0]),
            atol=5e-4,
        )

    def test_istft_uses_mutated_host_buffer(self, speech):
        _, _, S = speech.get_spectrogram(force_computation=True)
        S[...] = 0.0  # materializes and zeroes the host view
        y = dsp.transforms.istft(S, original_signal=speech)
        assert float(np.max(np.abs(y.time_data))) == 0.0


class TestWrapperProtocols:
    @pytest.fixture
    def pair(self, stereo):
        f, C = stereo.get_csm(force_computation=True)
        return C, np.asarray(C).copy()

    def test_metadata_without_fetch(self, stereo):
        _, C = stereo.get_csm(force_computation=True)
        _ = (C.shape, C.dtype, C.ndim, C.size, len(C))
        assert not C.is_materialized

    def test_ufuncs_and_operators(self, pair):
        C, ref = pair
        np.testing.assert_allclose(np.abs(C), np.abs(ref))
        np.testing.assert_allclose(C + 1, ref + 1)
        np.testing.assert_allclose(1 + C, 1 + ref)
        np.testing.assert_allclose(C * C, ref * ref)
        np.testing.assert_allclose(-C, -ref)
        np.testing.assert_allclose(C / 2.0, ref / 2.0)
        assert np.all((C == ref))

    def test_getattr_delegation(self, pair):
        C, ref = pair
        np.testing.assert_allclose(C.real, ref.real)
        np.testing.assert_allclose(C.conj(), ref.conj())
        np.testing.assert_allclose(C.sum(axis=0), ref.sum(axis=0))
        assert C.T.shape == ref.T.shape

    def test_indexing_and_iter(self, pair):
        C, ref = pair
        np.testing.assert_allclose(C[0], ref[0])
        np.testing.assert_allclose(C[:, 0, 1], ref[:, 0, 1])
        first = next(iter(C))
        np.testing.assert_allclose(first, ref[0])

    def test_numpy_functions_coerce(self, pair):
        C, ref = pair
        np.testing.assert_allclose(
            np.concatenate([C, ref]), np.concatenate([ref, ref])
        )
        np.testing.assert_allclose(np.mean(C, axis=0), np.mean(ref, axis=0))

    def test_mutation_persists(self, stereo):
        _, C = stereo.get_csm(force_computation=True)
        arr = np.asarray(C)
        arr[0, 0, 0] = 42.0
        assert complex(C[0, 0, 0]) == 42.0

    def test_copies_are_independent(self, stereo):
        _, C = stereo.get_csm(force_computation=True)
        C2 = C.copy()
        assert isinstance(C2, LazyHostArray)
        np.asarray(C)[0, 0, 0] = 7.0
        assert complex(C2[0, 0, 0]) != 7.0

    def test_two_getter_calls_are_independent(self, stereo):
        _, C1 = stereo.get_csm()
        _, C2 = stereo.get_csm()
        np.asarray(C1)[0, 0, 0] = 9.0
        assert complex(C2[0, 0, 0]) != 9.0

    def test_deepcopy_and_pickle(self, pair):
        C, ref = pair
        C2 = copy.deepcopy(C)
        assert isinstance(C2, LazyHostArray)
        np.testing.assert_allclose(np.asarray(C2), ref)
        loaded = pickle.loads(pickle.dumps(C))
        assert isinstance(loaded, np.ndarray)
        np.testing.assert_allclose(loaded, ref)

    def test_jnp_consumption_stays_on_device(self, stereo):
        import jax.numpy as jnp

        _, C = stereo.get_csm(force_computation=True)
        dev = C.__jax_array__()
        assert isinstance(dev, jnp.ndarray)
        assert not C.is_materialized

    def test_device_spectral_data_compose(self, stereo):
        import jax.numpy as jnp

        _, dsd = stereo.get_csm(force_computation=True, return_device=True)
        composed = dsd.complex_device()
        assert isinstance(composed, jnp.ndarray)
        np.testing.assert_allclose(
            np.asarray(composed.real) + 1j * np.asarray(composed.imag),
            dsd.to_numpy(),
            rtol=1e-6,
        )

    def test_materialize_all(self, stereo, speech):
        _, C = stereo.get_csm(force_computation=True)
        _, sp = speech.get_spectrum(force_computation=True)
        c_np, sp_np = materialize_all(C, sp)
        assert isinstance(c_np, np.ndarray)
        assert isinstance(sp_np, np.ndarray)
