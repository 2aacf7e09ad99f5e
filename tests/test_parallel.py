"""Multi-chip sharding tests on the 8-virtual-device CPU mesh.

conftest sets ``xla_force_host_platform_device_count=8``; every test here
validates that the sharded pipelines compile, execute, and match their
single-device counterparts.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dsptoolbox_jax import parallel as par
from dsptoolbox_jax.ops.iir import sosfilt
from dsptoolbox_jax.ops.spectral import csm_welch, welch
from dsptoolbox_jax.standard.enums import SpectrumScaling


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "expected 8 virtual CPU devices"
    return par.device_mesh(8)


class TestMesh:
    def test_device_mesh_shapes(self, mesh):
        assert mesh.devices.size == 8
        m2 = par.device_mesh(8, axis_names=("dp", "ch"), shape=(2, 4))
        assert m2.devices.shape == (2, 4)

    def test_shardings(self, mesh):
        s = par.shard_batch(mesh, ndim=3, axis=0)
        assert s.spec[0] == mesh.axis_names[0]
        r = par.replicate(mesh)
        assert all(ax is None for ax in r.spec)


class TestParallelWelch:
    def test_matches_single_device(self, mesh):
        rng = np.random.default_rng(0)
        x = jnp.asarray(
            rng.standard_normal((16, 8192)).astype(np.float32)
        )
        got = par.parallel_welch(
            x, mesh, sampling_rate_hz=48000,
            window_length_samples=1024,
        )
        want = welch(
            x, sampling_rate_hz=48000, window_length_samples=1024
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-9
        )
        # the output must actually be sharded across devices
        assert len(got.sharding.device_set) == 8


class TestParallelCSM:
    def test_matches_single_device(self, mesh):
        rng = np.random.default_rng(1)
        x = jnp.asarray(
            rng.standard_normal((8, 8192)).astype(np.float32)
        )
        f_p, csm_p = par.parallel_csm(
            x, mesh, sampling_rate_hz=48000,
            window_length_samples=1024,
            scaling=SpectrumScaling.PowerSpectralDensity,
        )
        f_s, csm_s = csm_welch(
            x, sampling_rate_hz=48000, window_length_samples=1024,
            scaling=SpectrumScaling.PowerSpectralDensity,
        )
        np.testing.assert_allclose(f_p, f_s)
        # the sharded path now finishes with the same exact-real diagonal
        # + reference-order Hermitian assembly as the single-device kernel,
        # so the matrices compare directly
        np.testing.assert_allclose(
            np.asarray(csm_p), np.asarray(csm_s), rtol=2e-3, atol=1e-8
        )


class TestParallelFilterbank:
    def test_matches_single_device(self, mesh):
        from scipy.signal import butter

        bank = np.stack(
            [
                butter(4, fc, btype="lowpass", fs=48000, output="sos")
                for fc in [250, 500, 1000, 2000, 4000, 8000, 12000, 16000]
            ]
        ).astype(np.float64)
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.standard_normal((4, 4096)).astype(np.float32))
        got = par.parallel_filterbank(bank, x, mesh)
        for b in range(bank.shape[0]):
            want, _ = sosfilt(bank[b], x)
            np.testing.assert_allclose(
                np.asarray(got[b]), np.asarray(want),
                rtol=1e-4, atol=1e-5,
            )


class TestShardedMapReduce:
    def test_energy_sum(self, mesh):
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.standard_normal((32, 512)).astype(np.float32))
        got = par.sharded_map_reduce(
            lambda row: jnp.sum(row**2), x, mesh, reduce="sum"
        )
        want = float(jnp.sum(x**2))
        assert np.isclose(float(got), want, rtol=1e-5)

    def test_keep_sharded(self, mesh):
        rng = np.random.default_rng(4)
        x = jnp.asarray(rng.standard_normal((16, 512)).astype(np.float32))
        got = par.sharded_map_reduce(
            lambda row: jnp.max(jnp.abs(row)), x, mesh
        )
        want = np.max(np.abs(np.asarray(x)), axis=1)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


class TestSequenceParallelFIR:
    def test_matches_lfilter(self, mesh):
        import scipy.signal as sig

        rng = np.random.default_rng(5)
        x = jnp.asarray(
            rng.standard_normal((3, 4096)).astype(np.float32)
        )
        h = sig.firwin(129, 0.3)
        got = par.parallel_fir_filter(h, x, mesh)
        want = sig.lfilter(h, [1.0], np.asarray(x), axis=-1)
        np.testing.assert_allclose(
            np.asarray(got), want, atol=1e-5
        )
        # time axis genuinely sharded across the mesh
        assert len(got.sharding.device_set) == 8


class TestSequenceParallelFramedSpectral:
    """Time-axis sharding for framed spectral ops (STFT/Welch): the
    `ppermute` halo carries the window overhang across shard boundaries
    (SURVEY §5's STFT-framing halo-exchange point)."""

    def test_parallel_stft_matches_single_device(self, mesh):
        from dsptoolbox_jax.ops.spectral import stft

        rng = np.random.default_rng(7)
        # T = 8 devices * 4096; window 512, 50% overlap -> step 256 | L
        x = jnp.asarray(
            rng.standard_normal((2, 8 * 4096)).astype(np.float32)
        )
        t_p, f_p, S_p = par.parallel_stft(
            x, mesh, sampling_rate_hz=48000,
            window_length_samples=512, overlap_percent=50.0,
        )
        t_s, f_s, S_s = stft(
            x, sampling_rate_hz=48000, window_length_samples=512,
            overlap_percent=50.0, padding=False,
        )
        np.testing.assert_allclose(f_p, f_s)
        assert S_p.shape == S_s.shape
        np.testing.assert_allclose(
            np.asarray(S_p), np.asarray(S_s), rtol=1e-4, atol=1e-5
        )
        # frames (= time) axis genuinely sharded
        assert len(S_p.sharding.device_set) == 8

    def test_parallel_stft_physical_scaling(self, mesh):
        from dsptoolbox_jax.ops.spectral import stft

        rng = np.random.default_rng(8)
        x = jnp.asarray(
            rng.standard_normal((8 * 2048,)).astype(np.float32)
        )
        _, _, S_p = par.parallel_stft(
            x, mesh, sampling_rate_hz=16000,
            window_length_samples=256,
            scaling=SpectrumScaling.PowerSpectralDensity,
        )
        _, _, S_s = stft(
            x, sampling_rate_hz=16000, window_length_samples=256,
            padding=False,
            scaling=SpectrumScaling.PowerSpectralDensity,
        )
        np.testing.assert_allclose(
            np.asarray(S_p), np.asarray(S_s), rtol=1e-4, atol=1e-8
        )

    def test_parallel_welch_time_matches_single_device(self, mesh):
        rng = np.random.default_rng(9)
        x = jnp.asarray(
            rng.standard_normal((3, 8 * 4096)).astype(np.float32)
        )
        got = par.parallel_welch_time(
            x, mesh, sampling_rate_hz=48000,
            window_length_samples=1024,
        )
        want = welch(
            x, sampling_rate_hz=48000, window_length_samples=1024
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-9
        )

    def test_parallel_stft_bad_shard_raises(self, mesh):
        x = jnp.zeros((8 * 1000,), jnp.float32)  # 1000 not multiple of 256
        with pytest.raises(AssertionError):
            par.parallel_stft(
                x, mesh, sampling_rate_hz=48000,
                window_length_samples=512,
            )


def test_parallel_das_map_matches_single_device(mesh):
    """Grid-parallel DAS equals the single-device einsum."""
    import jax.numpy as jnp

    from dsptoolbox_jax import parallel as par
    from dsptoolbox_jax.beamforming.beamforming import _das_map_core

    rng = np.random.default_rng(11)
    M, G, F = 8, 16, 5
    amp = rng.standard_normal((M, G)) ** 2 + 0.1
    diff = rng.standard_normal((M, G)) * 0.01
    k = np.linspace(30.0, 40.0, F)
    spectra = rng.standard_normal((F, M, 3)) + 1j * rng.standard_normal(
        (F, M, 3)
    )
    csm = np.einsum("fmk,fnk->fmn", spectra, np.conj(spectra))

    got = np.asarray(par.parallel_das_map(amp, diff, k, csm, mesh))
    want = np.asarray(
        _das_map_core(
            jnp.asarray(amp, jnp.float32),
            jnp.asarray(diff, jnp.float32),
            jnp.asarray(k, jnp.float32),
            jnp.asarray(csm.real, jnp.float32),
            jnp.asarray(csm.imag, jnp.float32),
        )
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_parallel_batch_descriptors_matches_single_device(mesh):
    from dsptoolbox_jax import parallel as par
    from dsptoolbox_jax.room_acoustics.batch import batch_descriptors

    rng = np.random.default_rng(12)
    fs = 8000
    T = fs // 4
    B = 16
    t = np.arange(T) / fs
    rirs = (
        rng.standard_normal((B, T))
        * np.exp(-rng.uniform(4, 10, B)[:, None] * t)
    ).astype(np.float32)
    rirs[:, 0] = 1.0

    got = par.parallel_batch_descriptors(rirs, fs, mesh)
    want = batch_descriptors(rirs, fs)
    for key in want:
        np.testing.assert_allclose(
            np.asarray(got[key]), np.asarray(want[key]), rtol=1e-5,
            atol=1e-6,
        )


class TestParallelReviewRegressions:
    def test_complex_bank_keeps_imaginary(self, mesh):
        """Complex cascades (gammatone) must not lose their imaginary
        parts in the sharded filter bank."""
        from dsptoolbox_jax.ops.iir_block import (
            sosfilt_bank_apply,
            sosfilt_bank_operators,
        )

        rng = np.random.default_rng(71)
        # 8 complex one-pole^2 cascades
        poles = 0.9 * np.exp(1j * np.linspace(0.2, 1.2, 8))
        bank = np.zeros((8, 2, 6), np.complex128)
        bank[:, :, 0] = 1.0
        bank[:, :, 3] = 1.0
        bank[:, :, 4] = -poles[:, None]
        x = rng.standard_normal((2, 256)).astype(np.float32)

        got = np.asarray(par.parallel_filterbank(bank, jnp.asarray(x), mesh))
        ops = sosfilt_bank_operators(bank, x.shape[-1])
        want = np.asarray(sosfilt_bank_apply(ops, jnp.asarray(x)))
        assert np.iscomplexobj(got) or np.abs(got.imag).sum() == 0
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)

    def test_fir_single_tap(self, mesh):
        rng = np.random.default_rng(72)
        x = rng.standard_normal((2, 64)).astype(np.float32)
        y = np.asarray(par.parallel_fir_filter(np.array([0.5]), x, mesh))
        np.testing.assert_allclose(y, 0.5 * x, rtol=1e-6)

    def test_multi_axis_mesh_uses_first_axis(self):
        mesh2 = par.device_mesh(8, axis_names=("dp", "ch"), shape=(2, 4))
        rng = np.random.default_rng(73)
        x = rng.standard_normal((2, 128)).astype(np.float32)
        from scipy.signal import firwin

        y = np.asarray(
            par.parallel_fir_filter(firwin(9, 0.3), x, mesh2)
        )
        from scipy.signal import lfilter

        want = lfilter(firwin(9, 0.3), [1.0], x, axis=-1)
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-6)

    def test_parallel_csm_amplitude_scaling(self, mesh):
        from dsptoolbox_jax.ops.spectral import csm_welch

        rng = np.random.default_rng(74)
        x = rng.standard_normal((8, 8192)).astype(np.float32) * 0.3
        scaling = SpectrumScaling.AmplitudeSpectralDensity
        f_p, csm_p = par.parallel_csm(
            jnp.asarray(x), mesh, sampling_rate_hz=48000,
            window_length_samples=512, scaling=scaling,
        )
        f_s, csm_s = csm_welch(
            x, sampling_rate_hz=48000, window_length_samples=512,
            scaling=scaling,
        )
        got = np.asarray(csm_p)
        want = np.asarray(csm_s)
        # compare magnitudes: the plain-Gram convention conjugates the
        # lower triangle BEFORE the amplitude sqrt, and conj does not
        # commute with sqrt on the branch cut (near-zero bins)
        C = got.shape[1]
        il = np.tril_indices(C, -1)
        np.testing.assert_allclose(
            np.abs(got[:, il[0], il[1]]), np.abs(want[:, il[0], il[1]]),
            rtol=5e-3, atol=1e-6,
        )
        # real diagonals match
        dg = np.arange(C)
        np.testing.assert_allclose(
            got[:, dg, dg].real, want[:, dg, dg].real, rtol=5e-3,
            atol=1e-6,
        )
