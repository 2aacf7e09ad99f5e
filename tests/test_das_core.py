"""Delay-and-sum map core (`beamforming._das_map_core`) and the public
`BeamformerDASFrequency.get_beamformer_map` against a plain float64
double loop over frequency bins and grid points (`_plain_reference`).

The shapes span the full 64-mic x 900-point grid of the chip smoke, odd
mic/grid counts and a single-tile grid; the wave numbers are either a
uniform ramp (rfft bins, the public call's case) or irregular."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _plain_reference import das_map, scale_relative_error
from dsptoolbox_jax.beamforming.beamforming import _das_map_core


@pytest.mark.parametrize(
    "M,G,F",
    [(64, 900, 37), (9, 20, 13), (25, 130, 5), (64, 128, 16)],
)
@pytest.mark.parametrize("uniform", [False, True])
def test_core_matches_f64_loop(M, G, F, uniform):
    rng = np.random.default_rng(0)
    amp = rng.uniform(0.5, 1.0, (M, G))
    diff = rng.standard_normal((M, G)) * 0.01
    if uniform:
        k = np.linspace(10.0, 400.0, F)
    else:
        k = np.sort(rng.uniform(10.0, 400.0, F))
    spectra = rng.standard_normal((F, M, 3)) + 1j * rng.standard_normal(
        (F, M, 3)
    )
    csm = np.einsum("fmk,fnk->fmn", spectra, np.conj(spectra))
    got = np.asarray(
        jax.jit(_das_map_core)(
            *(jnp.asarray(a, jnp.float32) for a in (amp, diff, k)),
            jnp.asarray(csm.real, jnp.float32),
            jnp.asarray(csm.imag, jnp.float32),
        )
    )
    want = das_map(csm, amp, diff, k)
    assert got.shape == want.shape == (G, F)
    # fp32 quadratic forms at HIGHEST precision over 2M terms
    assert scale_relative_error(got, want) < 5e-5


def test_public_das_map_matches_f64_loop():
    """The public map equals the plain loop over the analysis band's CSM
    (diagonal removed), negative powers clipped, Simpson-integrated over
    frequency."""
    import dsptoolbox_jax as dsp
    from dsptoolbox_jax import beamforming as bfm
    from dsptoolbox_jax.beamforming.beamforming import _simpson_uniform
    from dsptoolbox_jax.helpers.other import fractional_octave_bandwidth
    from dsptoolbox_jax.standard.enums import SpectrumScaling
    from _plain_reference import csm_welch

    fs = 16000
    _x = np.arange(0, 1.1, 0.5)
    xx, yy = np.meshgrid(_x, _x, indexing="ij")
    ma = bfm.MicArray(
        dict(x=xx.flatten(), y=yy.flatten(), z=np.zeros(xx.size))
    )
    src = bfm.MonopoleSource(
        dsp.generators.noise(0.2, fs, seed=0), [0, 0.4, 0.5]
    )
    sig = src.get_signals_on_array(ma)
    sig.set_spectrum_parameters(
        detrend=False, scaling=SpectrumScaling.PowerSpectralDensity
    )
    g = bfm.Regular2DGrid(
        np.arange(-0.2, 0.2, 0.2), np.arange(-0.4, 0.5, 0.2),
        ["x", "y"], value3=0.5,
    )
    st = bfm.SteeringVector(formulation=bfm.SteeringVectorType.TrueLocation)
    das = bfm.BeamformerDASFrequency(sig, ma, g, st)
    got = np.asarray(das.get_beamformer_map(2000, 3))

    wl = 1024
    M = ma.number_of_points
    td = np.asarray(sig.time_data).T.astype(np.float64)
    csm = csm_welch(td, fs, wl, wl // 2)
    f = np.fft.rfftfreq(wl, 1 / fs)
    lo, hi = fractional_octave_bandwidth(2000, 3)
    i1 = int(np.argmin(np.abs(f - lo)))
    i2 = int(np.argmin(np.abs(f - hi)))
    i2 += i1 == i2
    amp, diff = (np.asarray(a) for a in st.get_amp_diff(g, ma))
    band = csm[i1:i2] * (M / (M - 1)) * (1 - np.eye(M))
    mg = das_map(band, amp, diff, f[i1:i2] * 2 * np.pi / das.c)
    mg[mg < 0] = 0
    want = g.reconstruct_map_shape(_simpson_uniform(mg, dx=f[1] - f[0], axis=1))
    assert scale_relative_error(got, want) < 1e-4
