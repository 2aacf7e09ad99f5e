"""Deferred (auto-fused) dispatch of the default lazy API.

The default drop-in call sequence must collapse to ONE composite device
program per flush while producing numbers identical to eager dispatch
(`dsptoolbox_jax._defer`). The reference executes every getter eagerly
on the host (`/root/reference/dsptoolbox/classes/signal.py:861-1007`);
these tests pin that our deferral is an invisible optimization: same
values, same shapes/dtypes, correct metadata, correct forcing at every
public boundary.
"""

import numpy as np
import pytest

import dsptoolbox_jax as dsp
from dsptoolbox_jax import _config, _defer
from dsptoolbox_jax._defer import DeferredArray
from dsptoolbox_jax.classes.lazy_array import LazyHostArray

EXAMPLE = "/root/reference/example_data"


@pytest.fixture
def speech():
    s = dsp.Signal(f"{EXAMPLE}/speech.flac")
    s.set_spectrogram_parameters(window_length_samples=1024)
    return s


def _chain(sig):
    t, f, S = sig.get_spectrogram(force_computation=True)
    y = dsp.transforms.istft(S, original_signal=sig)
    f2, sp = sig.get_spectrum(force_computation=True)
    two = dsp.append_signals([sig, y])
    f3, C = two.get_csm(force_computation=True)
    return y, sp, C


@pytest.fixture
def eager_chain_results(speech):
    _config.set_deferred_execution(False)
    try:
        y, sp, C = _chain(speech)
        return (
            np.asarray(y.time_data_jax),
            np.asarray(sp),
            np.asarray(C),
        )
    finally:
        _config.set_deferred_execution(None)


class TestDeferredChain:
    def test_enabled_by_default_in_fp32(self):
        assert _config.deferred_execution()

    def test_chain_is_deferred_then_flushes_to_one_program(self, speech):
        y, sp, C = _chain(speech)
        # all three results are pending: nothing has launched
        assert isinstance(sp, LazyHostArray)
        assert isinstance(sp.device_real, DeferredArray)
        assert not sp.device_real.is_computed
        assert isinstance(y.time_data_jax.shape, tuple)  # forces y only
        # forcing C flushes its whole ancestor DAG in one composite
        assert isinstance(C.device_real, DeferredArray)
        _ = np.asarray(C)
        assert C.device_real.is_computed

    def test_values_match_eager(self, speech, eager_chain_results):
        y0, sp0, C0 = eager_chain_results
        y, sp, C = _chain(speech)
        dsp.compute_all(y, sp, C)
        np.testing.assert_allclose(
            np.asarray(y.time_data_jax), y0, rtol=1e-6, atol=1e-7
        )
        np.testing.assert_allclose(
            np.asarray(sp), sp0, rtol=1e-6, atol=1e-9
        )
        np.testing.assert_allclose(np.asarray(C), C0, rtol=1e-6, atol=1e-9)

    def test_compute_all_forces_without_host_transfer(self, speech):
        y, sp, C = _chain(speech)
        dsp.compute_all(y, sp, C)
        assert sp.device_real.is_computed
        assert C.device_real.is_computed
        assert not sp.is_materialized  # still device-resident
        assert not C.is_materialized

    def test_metadata_without_execution(self, speech):
        t, f, S = speech.get_spectrogram(force_computation=True)
        assert isinstance(S.device_real, DeferredArray)
        assert S.shape == (513, S.shape[1], 1)
        assert S.dtype == np.complex64
        assert not S.device_real.is_computed

    def test_deferred_signal_metadata(self, speech):
        t, f, S = speech.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=speech)
        assert isinstance(y._time_data, DeferredArray)
        assert y.length_samples == speech.length_samples
        assert y.number_of_channels == 1
        assert y.sampling_rate_hz == speech.sampling_rate_hz

    def test_unaware_consumer_forces_correctly(self, speech):
        """A plain jitted consumer (any _dev_jit site) must silently
        force pending inputs, not crash or corrupt."""
        f2, sp = speech.get_spectrum(force_computation=True)
        from dsptoolbox_jax.classes.signal import _dev_jit

        import jax.numpy as jnp

        total = _dev_jit("test_defer_sum", lambda a: jnp.sum(a))(
            sp.device_real
        )
        assert np.isfinite(float(total))

    def test_mixed_eager_deferred_matches(self, speech):
        """Interleaving eager host reads mid-chain must not change
        downstream results."""
        t, f, S = speech.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=speech)
        peek = float(np.asarray(y.time_data_jax)[1000, 0])  # forces y
        two = dsp.append_signals([speech, y])
        f3, C = two.get_csm(force_computation=True)
        _config.set_deferred_execution(False)
        try:
            t0, f0, S0 = speech.get_spectrogram(force_computation=True)
            y0 = dsp.transforms.istft(S0, original_signal=speech)
            two0 = dsp.append_signals([speech, y0])
            _, C0 = two0.get_csm(force_computation=True)
        finally:
            _config.set_deferred_execution(None)
        assert peek == pytest.approx(
            float(np.asarray(y0.time_data_jax)[1000, 0])
        )
        np.testing.assert_allclose(
            np.asarray(C), np.asarray(C0), rtol=1e-6, atol=1e-9
        )

    def test_composite_program_cached_across_iterations(self, speech):
        n0 = len(_defer._COMPOSITE_CACHE)
        for _ in range(3):
            y, sp, C = _chain(speech)
            dsp.compute_all(y, sp, C)
        # steady-state loop adds at most one composite structure
        assert len(_defer._COMPOSITE_CACHE) <= n0 + 1

    def test_dag_size_cap_flushes_incrementally(self, speech):
        cap = _defer._MAX_DAG_NODES
        try:
            _defer._MAX_DAG_NODES = 3
            sig = speech
            for _ in range(4):
                t, f, S = sig.get_spectrogram(force_computation=True)
                sig = dsp.transforms.istft(S, original_signal=sig)
            # chain longer than the cap: intermediate flushes happened
            assert isinstance(sig._time_data, DeferredArray)
            val = np.asarray(sig.time_data_jax)
            assert np.isfinite(val).all()
        finally:
            _defer._MAX_DAG_NODES = cap

    def test_deferred_constrain_matches_eager_arithmetic(self):
        """In-program amplitude constraining of a deferred assignment
        must scale identically to the eager setter (warning and host
        scale metadata are documented trace-mode differences)."""
        rng = np.random.default_rng(0)
        loud = dsp.Signal.from_time_data(
            rng.standard_normal(2**14) * 3.0, 16000
        )
        loud.set_spectrogram_parameters(window_length_samples=512)
        t, f, S = loud.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=loud)
        _config.set_deferred_execution(False)
        try:
            t0, f0, S0 = loud.get_spectrogram(force_computation=True)
            y0 = dsp.transforms.istft(S0, original_signal=loud)
        finally:
            _config.set_deferred_execution(None)
        np.testing.assert_allclose(
            np.asarray(y.time_data_jax),
            np.asarray(y0.time_data_jax),
            rtol=1e-6,
            atol=1e-7,
        )

    def test_pipeline_trace_still_inlines(self, speech):
        """dsp.pipeline traces must not record deferred nodes."""
        run = dsp.pipeline(_chain)
        y, sp, C = run(speech)
        assert not isinstance(sp.device_real, DeferredArray)
        y0, sp0, C0 = _chain(speech)
        np.testing.assert_allclose(
            np.asarray(sp), np.asarray(sp0), rtol=2e-4, atol=1e-6
        )

    def test_pickle_of_deferred_signal(self, speech):
        """Pending program handles don't survive a process boundary:
        pickling forces and round-trips the concrete values."""
        import pickle

        t, f, S = speech.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=speech)
        assert isinstance(y._time_data, DeferredArray)
        y2 = pickle.loads(pickle.dumps(y))
        np.testing.assert_allclose(
            np.asarray(y2.time_data), np.asarray(y.time_data)
        )

    def test_disable_override_restores_eager(self, speech):
        _config.set_deferred_execution(False)
        try:
            f2, sp = speech.get_spectrum(force_computation=True)
            assert not isinstance(sp.device_real, DeferredArray)
        finally:
            _config.set_deferred_execution(None)
