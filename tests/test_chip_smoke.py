"""The GPU smoke script (`chip_smoke.py`) as far as the CPU can check it:
it refuses to run without a GPU, its compile-cache rule, and each plain
float64 reference it compares the card against (`_plain_reference`),
checked here against the library at small sizes."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import _plain_reference as ref
import dsptoolbox_jax as dsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 48000


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    """No accelerator (or no repository beside the script): non-zero exit
    and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("env_dir", [None, "given"], ids=["unset", "set"])
def test_compile_cache_rule(monkeypatch, tmp_path, env_dir):
    """`JAX_COMPILATION_CACHE_DIR` stays in force when set (nothing else
    is configured); otherwise the cache goes to `<checkout>/.jax_cache`."""
    import jax

    import bench

    names = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    before = {n: getattr(jax.config, n) for n in names}
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        got = bench.enable_compile_cache()
        if env_dir is None:
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            assert got == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before[names[0]]
    finally:
        for n, v in before.items():
            jax.config.update(n, v)


def _noise(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


def _signal(x):
    from dsptoolbox_jax.standard.enums import SpectrumScaling

    s = dsp.Signal(None, x, FS)
    s.set_spectrum_parameters(
        window_length_samples=256, detrend=False,
        scaling=SpectrumScaling.PowerSpectralDensity,
    )
    s.set_spectrogram_parameters(window_length_samples=256)
    return s


def test_scale_relative_error():
    d = np.array([0.0, 2.0, -4.0])
    assert ref.scale_relative_error(d + [0.0, 0.0, 0.4], d) == pytest.approx(
        0.1
    )
    with pytest.raises(ValueError):
        ref.scale_relative_error(d[:2], d)


def test_welch_and_csm_references():
    x = _noise((12000, 3))
    s = _signal(x)
    _, sp = s.get_spectrum()
    _, csm = s.get_csm()
    xt = x.T.astype(np.float64)
    assert ref.scale_relative_error(
        np.asarray(sp), ref.welch_psd(xt, FS, 256, 128).T
    ) < 1e-5
    assert ref.scale_relative_error(
        np.asarray(csm), ref.csm_welch(xt, FS, 256, 128)
    ) < 1e-5


def test_stft_and_energy_references():
    import jax.numpy as jnp

    from dsptoolbox_jax.ops.spectral import stft

    x = _noise((12000, 2))
    _, _, S = _signal(x).get_spectrogram()
    assert ref.scale_relative_error(
        np.asarray(S), ref.stft(x.T, 256, 128)
    ) < 1e-5
    _, _, S2 = stft(
        jnp.asarray(x.T), sampling_rate_hz=FS, window_length_samples=256,
        overlap_percent=50.0,
    )
    energy = np.sum(np.abs(np.asarray(S2)) ** 2, axis=(-1, -2))
    assert ref.scale_relative_error(
        energy, ref.stft_energy(x.T, 256, 128)
    ) < 1e-5


@pytest.mark.parametrize("zero_phase", [False, True])
def test_linkwitz_riley_reference(zero_phase):
    x = _noise((6000, 2))
    lr = dsp.filterbanks.linkwitz_riley_crossovers([250, 1000, 4000], 4, FS)
    mb = lr.filter_signal(dsp.Signal(None, x, FS), zero_phase=zero_phase)
    want = ref.linkwitz_riley_bands(lr.sos, x.T, zero_phase=zero_phase)
    assert len(want) == mb.number_of_bands == 4
    for band, w in zip(mb.bands, want):
        assert ref.scale_relative_error(np.asarray(band.time_data).T, w) < 1e-4


def test_sosfilt_reference_complex():
    from dsptoolbox_jax.standard.enums import FilterCoefficientsType

    x = _noise((4000, 1))
    gt = dsp.filterbanks.auditory_filters_gammatone(
        [500, 2000], sampling_rate_hz=FS
    )
    from dsptoolbox_jax.standard.enums import FilterBankMode

    mb = gt.filter_signal(dsp.Signal(None, x, FS), FilterBankMode.Parallel)
    sos = gt.filters[0].get_coefficients(FilterCoefficientsType.Sos)
    band = mb.bands[0]
    got = np.asarray(band.time_data) + 1j * np.asarray(
        band.time_data_imaginary
    )
    assert np.iscomplexobj(sos)
    assert ref.scale_relative_error(got.T, ref.sosfilt(sos, x.T)) < 1e-4


def test_deconvolve_reference():
    fs = FS
    sweep = dsp.generators.chirp(
        fs, range_hz=[20, 20000], length_seconds=0.5,
        padding_end_seconds=0.1,
    )
    sw = np.asarray(sweep.time_data)[:, 0].astype(np.float64)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 2000)) * np.exp(-np.arange(2000) / 300.0)
    rec = np.stack(
        [np.convolve(sw, hh)[: len(sw)] for hh in h]
    ).astype(np.float32)
    ir = dsp.transfer_functions.spectral_deconvolve(
        dsp.Signal(None, rec.T, fs), dsp.Signal(None, sw[:, None], fs)
    )
    want = ref.deconvolve(rec.astype(np.float64), sw, fs)
    assert ref.scale_relative_error(np.asarray(ir.time_data).T, want) < 1e-4


def test_schroeder_t20_of_exponential_decay():
    """A noise burst decaying by 60 dB in T60 has a T20 of T60, both by
    the plain Schroeder integral and by the library."""
    t60 = 0.5
    n = int(1.2 * t60 * FS)
    rng = np.random.default_rng(2)
    h = rng.standard_normal(n) * 10 ** (-3 * np.arange(n) / FS / t60)
    h[0] = 5.0
    assert ref.schroeder_t20(h, FS) == pytest.approx(t60, rel=0.03)
    ir = dsp.ImpulseResponse(None, h[:, None].astype(np.float32), FS)
    t20, _ = dsp.room_acoustics.reverb_time(
        ir, dsp.room_acoustics.ReverbTime.T20
    )
    assert float(t20[0]) == pytest.approx(ref.schroeder_t20(h, FS), rel=0.03)


def test_complex_smoothing_reference():
    from scipy.signal.windows import hann

    from dsptoolbox_jax.transfer_functions import SmoothingDomain

    n = 2**12
    rng = np.random.default_rng(3)
    td = rng.standard_normal((n, 2)) * np.exp(-np.arange(n) / 500.0)[:, None]
    ir = dsp.ImpulseResponse(None, td.astype(np.float32), FS)
    got = dsp.transfer_functions.complex_smoothing(
        ir, 3, SmoothingDomain.RealImaginary
    ).spectral_data
    sp = np.fft.rfft(np.asarray(ir.time_data, np.float64), axis=0)
    want = ref.complex_smoothing(
        sp, np.fft.rfftfreq(n, 1 / FS), 3, hann(3000)
    )
    assert ref.scale_relative_error(np.asarray(got), want) < 1e-5
