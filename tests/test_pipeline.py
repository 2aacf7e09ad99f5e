"""`dsp.pipeline`: public-call chains fused into one jitted program.

Verifies fused results match the unfused public API bit-closely, the
supported return structures rebuild correctly, retracing is cached per
input signature, and in-trace amplitude constraining matches the eager
setter's arithmetic.
"""

import numpy as np
import pytest

import dsptoolbox_jax as dsp
from dsptoolbox_jax.classes.lazy_array import LazyHostArray

EXAMPLE = "/root/reference/example_data"


@pytest.fixture
def speech():
    s = dsp.Signal(f"{EXAMPLE}/speech.flac")
    s.set_spectrogram_parameters(window_length_samples=1024)
    return s


def _config2_chain(sig):
    t, f, S = sig.get_spectrogram(force_computation=True)
    y = dsp.transforms.istft(S, original_signal=sig)
    f2, sp = sig.get_spectrum(force_computation=True)
    two = dsp.append_signals([sig, y])
    f3, C = two.get_csm(force_computation=True)
    return y, sp, C


class TestPipeline:
    def test_config2_chain_matches_unfused(self, speech):
        run = dsp.pipeline(_config2_chain)
        y, sp, C = run(speech)
        y0, sp0, C0 = _config2_chain(speech)
        assert isinstance(y, dsp.Signal)
        assert isinstance(sp, LazyHostArray)
        assert isinstance(C, LazyHostArray)
        np.testing.assert_allclose(
            np.asarray(y.time_data_jax),
            np.asarray(y0.time_data_jax),
            rtol=2e-4,
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(sp), np.asarray(sp0), rtol=2e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(C), np.asarray(C0), rtol=2e-4, atol=1e-7
        )

    def test_signal_metadata_carried(self, speech):
        run = dsp.pipeline(_config2_chain)
        y, _, _ = run(speech)
        assert y.sampling_rate_hz == speech.sampling_rate_hz
        assert y.length_samples == speech.length_samples

    def test_deconvolution_chain_with_ir_output(self):
        chirp = dsp.Signal(f"{EXAMPLE}/chirp.wav")
        rec = dsp.Signal(f"{EXAMPLE}/chirp.wav")

        def chain(r, c):
            ir = dsp.transfer_functions.spectral_deconvolve(
                r, c, padding=False, keep_original_length=True
            )
            ir_w, _ = dsp.transfer_functions.window_ir(
                ir, 2**14, return_device=True
            )
            return ir_w

        run = dsp.pipeline(chain)
        ir_w = run(rec, chirp)
        ir_w0 = chain(rec, chirp)
        assert isinstance(ir_w, dsp.ImpulseResponse)
        np.testing.assert_allclose(
            np.asarray(ir_w.time_data_jax),
            np.asarray(ir_w0.time_data_jax),
            rtol=5e-4,
            atol=2e-5,
        )
        # the analysis window travels with the rebuilt IR
        assert getattr(ir_w, "window", None) is not None

    def test_structured_returns(self, speech):
        def chain(sig):
            f, sp = sig.get_spectrum(force_computation=True)
            return {"sp": sp, "pair": (sig.time_data_jax * 2, 3.5), "f": f}

        out = dsp.pipeline(chain)(speech)
        assert isinstance(out["sp"], LazyHostArray)
        assert out["pair"][1] == 3.5
        assert isinstance(out["f"], np.ndarray)
        np.testing.assert_allclose(
            np.asarray(out["pair"][0]),
            np.asarray(speech.time_data_jax) * 2,
            rtol=1e-6,
        )

    def test_trace_cache_per_signature(self, speech):
        calls = {"n": 0}

        def chain(sig):
            calls["n"] += 1
            _, sp = sig.get_spectrum(force_computation=True)
            return sp

        run = dsp.pipeline(chain)
        run(speech)
        run(speech)
        assert calls["n"] == 1  # second call reuses the compiled program
        short = dsp.Signal(
            None, np.asarray(speech.time_data)[: 2**15, 0],
            speech.sampling_rate_hz,
        )
        run(short)
        assert calls["n"] == 2  # new shape -> one retrace

    def test_cache_keys_on_sampling_rate(self):
        """Round-4 VERDICT confirmed bug: a 16 kHz signal run through a
        runner previously traced at 48 kHz (same shape) returned the
        48 kHz frequency vector. Each metadata signature must get its own
        trace with its own host constants."""
        rng = np.random.default_rng(7)
        td = rng.standard_normal(2**15).astype(np.float64)
        s48 = dsp.Signal.from_time_data(td, 48000)
        s16 = dsp.Signal.from_time_data(td, 16000)

        def chain(sig):
            f, sp = sig.get_spectrum(force_computation=True)
            return f, sp

        run = dsp.pipeline(chain)
        f48, sp48 = run(s48)
        f16, sp16 = run(s16)
        assert np.max(f48) == pytest.approx(24000.0)
        assert np.max(f16) == pytest.approx(8000.0)  # was 24000 pre-fix
        # and each fused result matches its own unfused result exactly
        for sig, f, sp in ((s48, f48, sp48), (s16, f16, sp16)):
            f0, sp0 = chain(sig)
            np.testing.assert_array_equal(np.asarray(f), np.asarray(f0))
            np.testing.assert_allclose(
                np.asarray(sp), np.asarray(sp0), rtol=1e-6, atol=1e-9
            )

    def test_cache_keys_on_spectrum_parameters(self):
        """Changing spectrum parameters between calls must retrace, not
        reuse the first call's window/segmentation constants."""
        rng = np.random.default_rng(11)
        td = rng.standard_normal(2**15).astype(np.float64)
        sig = dsp.Signal.from_time_data(td, 24000)

        def chain(s):
            f, sp = s.get_spectrum(force_computation=True)
            return f, sp

        run = dsp.pipeline(chain)
        f_a, sp_a = run(sig)
        sig.set_spectrum_parameters(window_length_samples=512)
        f_b, sp_b = run(sig)
        f0, sp0 = chain(sig)
        np.testing.assert_array_equal(np.asarray(f_b), np.asarray(f0))
        np.testing.assert_allclose(
            np.asarray(sp_b), np.asarray(sp0), rtol=1e-6, atol=1e-9
        )
        assert np.asarray(f_b).shape != np.asarray(f_a).shape

    def test_rebuilt_output_carries_calling_signals_rate(self):
        """Signal outputs are rebuilt from per-key templates: the 16 kHz
        call's outputs must carry 16 kHz metadata even after a 48 kHz
        call populated the cache."""
        rng = np.random.default_rng(3)
        td = rng.standard_normal(2**14).astype(np.float64)
        run = dsp.pipeline(lambda s: dsp.append_signals([s, s]))
        out48 = run(dsp.Signal.from_time_data(td, 48000))
        out16 = run(dsp.Signal.from_time_data(td, 16000))
        assert out48.sampling_rate_hz == 48000
        assert out16.sampling_rate_hz == 16000

    def test_templates_do_not_retain_traced_buffers(self):
        """The cached rebuild templates must hold only metadata after the
        first call — not the first call's full-size device buffers."""
        rng = np.random.default_rng(5)
        td = rng.standard_normal(2**15).astype(np.float64)
        sig = dsp.Signal.from_time_data(td, 48000)
        run = dsp.pipeline(lambda s: dsp.append_signals([s, s]))
        run(sig)
        def _cell(c):
            try:
                return c.cell_contents
            except ValueError:  # unbound cell (mesh-path locals)
                return None

        cache = run.__closure__ and next(
            v
            for v in (_cell(c) for c in run.__closure__)
            if isinstance(v, dict)
        )
        assert cache and len(cache) == 1
        (_, spec_box), = cache.values()
        spec = spec_box["spec"]
        assert spec[0] == "signal"
        template = spec[1]
        assert np.asarray(template._time_data).size <= 1

    def test_in_trace_amplitude_constraining(self):
        loud = dsp.Signal.from_time_data(
            np.sin(np.linspace(0, 50, 16000)) * 3.0, 16000
        )
        assert loud.constrain_amplitude

        def chain(sig):
            return dsp.append_signals([sig, sig])

        out = dsp.pipeline(chain)(loud)
        # eager append constrains identically
        out0 = chain(loud)
        np.testing.assert_allclose(
            np.asarray(out.time_data_jax),
            np.asarray(out0.time_data_jax),
            rtol=1e-6,
            atol=1e-7,
        )

    def test_filterbank_chain_with_multiband_output(self):
        from dsptoolbox_jax.standard.enums import FilterBankMode

        s = dsp.Signal(f"{EXAMPLE}/fuer_elise.wav")
        fs = s.sampling_rate_hz
        fb = dsp.filterbanks.linkwitz_riley_crossovers(
            [250.0, 1000.0], [4, 4], sampling_rate_hz=fs
        )

        def chain(sig):
            mb = fb.filter_signal(sig, FilterBankMode.Parallel)
            r = dsp.resample(sig, fs // 3)
            return mb, r

        run = dsp.pipeline(chain)
        mb, r = run(s)
        mb0, r0 = chain(s)
        assert isinstance(mb, dsp.MultiBandSignal)
        assert len(mb.bands) == len(mb0.bands)
        for b, b0 in zip(mb.bands, mb0.bands):
            np.testing.assert_allclose(
                np.asarray(b.time_data_jax),
                np.asarray(b0.time_data_jax),
                rtol=1e-4,
                atol=1e-5,
            )
        np.testing.assert_allclose(
            np.asarray(r.time_data_jax),
            np.asarray(r0.time_data_jax),
            rtol=1e-4,
            atol=1e-5,
        )

    def test_mesh_pipeline_matches_single_device(self):
        """Fuse + shard compose: the fused config-2-style chain compiled
        over an 8-device mesh (channel-sharded inputs, XLA-inserted
        collectives) must match the single-device fused result."""
        import jax
        from jax.sharding import Mesh

        rng = np.random.default_rng(9)
        td = rng.standard_normal((2**14, 8)).astype(np.float64) * 0.4
        sig = dsp.Signal.from_time_data(td, 16000)
        sig.set_spectrogram_parameters(window_length_samples=512)
        sig.set_spectrum_parameters(window_length_samples=512)

        def chain(s):
            t, f, S = s.get_spectrogram(force_computation=True)
            y = dsp.transforms.istft(S, original_signal=s)
            f2, sp = s.get_spectrum(force_computation=True)
            f3, C = s.get_csm(force_computation=True)
            return y, sp, C

        mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("d",))
        run_mesh = dsp.pipeline(chain, mesh=mesh)
        run_single = dsp.pipeline(chain)
        y_m, sp_m, C_m = run_mesh(sig)
        y_s, sp_s, C_s = run_single(sig)
        np.testing.assert_allclose(
            np.asarray(y_m.time_data_jax),
            np.asarray(y_s.time_data_jax),
            rtol=1e-5,
            atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(sp_m), np.asarray(sp_s), rtol=1e-5, atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(C_m), np.asarray(C_s), rtol=1e-5, atol=1e-8
        )

    def test_mesh_pipeline_uneven_channels_replicates(self):
        """A channel count that does not divide the mesh must still run
        (replicated inputs) and match."""
        import jax
        from jax.sharding import Mesh

        rng = np.random.default_rng(10)
        td = rng.standard_normal((2**13, 3)).astype(np.float64) * 0.4
        sig = dsp.Signal.from_time_data(td, 16000)
        sig.set_spectrum_parameters(window_length_samples=256)

        def chain(s):
            f, sp = s.get_spectrum(force_computation=True)
            return sp

        mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("d",))
        sp_m = dsp.pipeline(chain, mesh=mesh)(sig)
        sp_s = dsp.pipeline(chain)(sig)
        np.testing.assert_allclose(
            np.asarray(sp_m), np.asarray(sp_s), rtol=1e-5, atol=1e-8
        )

    def test_rejects_non_signal_args(self):
        run = dsp.pipeline(lambda s: s)
        with pytest.raises(AssertionError):
            run(np.zeros(16))
