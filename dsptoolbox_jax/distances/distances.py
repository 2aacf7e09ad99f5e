"""Distance and quality measures between signals.

Behavioral reference: `dsptoolbox/distances/`. Spectral estimation and
framing run on device; integrations/reductions vectorize over channels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..classes import Signal
from ..helpers.other import find_nearest_points_index_in_vector
from ..ops.framing import frame_signal
from ..standard.enums import FilterBankMode, SpectrumMethod


_SIMPSON_W_CACHE: dict = {}


def _simpson_weights(x: np.ndarray) -> np.ndarray:
    """Composite-Simpson quadrature weights for sample points ``x``
    (scipy-compatible, including its uneven-interval handling). Derived
    once per unique grid by integrating identity basis rows in chunks and
    cached — integration is linear in y, so ∫y = w·y exactly."""
    from scipy.integrate import simpson

    key = (x.shape[0], hash(x.tobytes()))
    w = _SIMPSON_W_CACHE.get(key)
    if w is None:
        n = len(x)
        w = np.empty(n)
        CH = 512
        for i0 in range(0, n, CH):
            m = min(CH, n - i0)
            basis = np.zeros((m, n))
            basis[np.arange(m), i0 + np.arange(m)] = 1.0
            w[i0 : i0 + m] = simpson(basis, x=x, axis=-1)
        if len(_SIMPSON_W_CACHE) > 16:
            _SIMPSON_W_CACHE.clear()
        _SIMPSON_W_CACHE[key] = w
    return w


def _simpson(y: jnp.ndarray, x: np.ndarray, axis: int = 0) -> jnp.ndarray:
    """scipy.integrate.simpson-compatible composite Simpson along ``axis``
    with static sample points (weights baked at trace time)."""
    w = _simpson_weights(np.asarray(x))
    y = jnp.moveaxis(y, axis, 0)
    out = jnp.tensordot(
        jnp.asarray(w, y.dtype),
        y,
        axes=(0, 0),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out


def _log_spectral_distance(x, y, f) -> jnp.ndarray:
    return jnp.sqrt(_simpson((10 * jnp.log10(x / y)) ** 2, f))


def _itakura_saito_measure(x, y, f) -> jnp.ndarray:
    return _simpson(x / y - jnp.log10(x / y) - 1, f)


def _prepare_psd(insig1, insig2, method, f_range_hz, spectrum_parameters):
    assert insig1.sampling_rate_hz == insig2.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    assert insig1.number_of_channels == insig2.number_of_channels, (
        "Signals have different channel numbers"
    )
    if spectrum_parameters is None:
        spectrum_parameters = {}
    fs_hz = insig1.sampling_rate_hz
    if f_range_hz is None:
        f_range_hz = [0, fs_hz // 2]
    else:
        assert len(f_range_hz) == 2, (
            "f_range_hz must only have a lower and an upper limit"
        )
        f_range_hz = np.sort(np.asarray(f_range_hz))
        assert f_range_hz[1] <= fs_hz // 2, (
            "Upper bound for frequency must be smaller than the nyquist "
            "frequency"
        )
        assert not any(f_range_hz < 0), (
            "Frequencies in range must be positive"
        )
    insig1.set_spectrum_parameters(method=method, **spectrum_parameters)
    insig2.set_spectrum_parameters(method=method, **spectrum_parameters)
    f, spec1 = insig1.get_spectrum()
    f, spec2 = insig2.get_spectrum()

    # abs() on host: spectra may be complex (FFT method)
    psd1 = jnp.asarray(np.abs(np.asarray(spec1)))
    psd2 = jnp.asarray(np.abs(np.asarray(spec2)))
    if insig1.spectrum_scaling.is_amplitude_scaling():
        psd1 = psd1**2
        psd2 = psd2**2
    ids = find_nearest_points_index_in_vector(f_range_hz, f)
    sl = slice(int(ids[0]), int(ids[1]))
    return f[sl], psd1[sl], psd2[sl]


def log_spectral(
    insig1: Signal,
    insig2: Signal,
    method: SpectrumMethod = SpectrumMethod.WelchPeriodogram,
    f_range_hz=[20, 20000],
    energy_normalization: bool = True,
    spectrum_parameters: dict | None = None,
) -> np.ndarray:
    """Log-spectral distance per channel (`distances.py:23-105`)."""
    f, psd1, psd2 = _prepare_psd(
        insig1, insig2, method, f_range_hz, spectrum_parameters
    )
    if energy_normalization:
        psd1 = psd1 / jnp.sum(psd1, axis=0)
        psd2 = psd2 / jnp.sum(psd2, axis=0)
    return np.asarray(_log_spectral_distance(psd1, psd2, f))


def itakura_saito(
    insig1: Signal,
    insig2: Signal,
    method: SpectrumMethod = SpectrumMethod.WelchPeriodogram,
    f_range_hz=[20, 20000],
    energy_normalization: bool = True,
    spectrum_parameters: dict | None = None,
) -> np.ndarray:
    """Itakura-Saito measure per channel (`distances.py:108-191`)."""
    f, psd1, psd2 = _prepare_psd(
        insig1, insig2, method, f_range_hz, spectrum_parameters
    )
    if energy_normalization:
        psd1 = psd1 / jnp.sum(psd1, axis=0)
        psd2 = psd2 / jnp.sum(psd2, axis=0)
    return np.asarray(_itakura_saito_measure(psd1, psd2, f))


def snr(signal: Signal, noise: Signal) -> np.ndarray:
    """SNR in dB per channel (`distances.py:194-222`)."""
    assert signal.sampling_rate_hz == noise.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    assert (
        noise.number_of_channels == 1
        or noise.number_of_channels == signal.number_of_channels
    ), "Number of channels does not match"
    rms_s = np.std(signal.time_data, axis=0)
    rms_n = np.std(noise.time_data, axis=0)
    return np.atleast_1d(20 * np.log10(rms_s / rms_n))


def si_sdr(target_signal: Signal, modified_signal: Signal) -> np.ndarray:
    """Scale-invariant SDR per channel (`distances.py:225-272`)."""
    assert (
        target_signal.sampling_rate_hz == modified_signal.sampling_rate_hz
    ), "Sampling rates do not match"
    assert (
        target_signal.time_data_jax.shape[0]
        == modified_signal.time_data_jax.shape[0]
    ), "Lengths do not match"
    multichannel = target_signal.number_of_channels == 1
    if not multichannel:
        assert (
            target_signal.number_of_channels
            == modified_signal.number_of_channels
        ), "Number of channels does not match"
    s = jnp.asarray(target_signal.time_data)
    shat = jnp.asarray(modified_signal.time_data)
    if multichannel and modified_signal.number_of_channels > 1:
        s = jnp.repeat(s, modified_signal.number_of_channels, axis=1)
    alpha = jnp.sum(s * shat, axis=0) / jnp.sum(s * s, axis=0)
    sisdr = 10 * jnp.log10(
        jnp.sum((alpha * s) ** 2, axis=0)
        / jnp.sum((alpha * s - shat) ** 2, axis=0)
    )
    return np.atleast_1d(np.asarray(sisdr))


def fw_snr_seg(
    x: Signal,
    xhat: Signal,
    f_range_hz=[20, 10e3],
    snr_range_db=[-10, 35],
    gamma: float = 0.2,
) -> np.ndarray:
    """Frequency-weighted segmental SNR (Hu & Loizou;
    `distances.py:275-369`). The band/frame double loop becomes one
    batched (band, frame, bin) computation on device."""
    from scipy.signal import windows

    from ..filterbanks import auditory_filters_gammatone

    assert x.sampling_rate_hz == xhat.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    fs_hz = x.sampling_rate_hz
    assert x.time_data_jax.shape[0] == xhat.time_data_jax.shape[0], (
        "Signal lengths do not match"
    )
    multichannel = False
    if x.number_of_channels != xhat.number_of_channels:
        assert x.number_of_channels == 1, (
            "Invalid number of channels for this measurement"
        )
        multichannel = True
    assert len(f_range_hz) == 2, (
        "Frequency range must have lower and upper bounds"
    )
    f_range = np.sort(np.asarray(f_range_hz))
    assert f_range[1] < fs_hz // 2, (
        f"Upper frequency range {f_range[1]} must be smaller than nyquist "
        f"frequency {fs_hz // 2}"
    )
    assert f_range[0] > 0, "Frequency range must be positive"
    assert len(snr_range_db) == 2, (
        "SNR range must have lower and upper bounds"
    )
    snr_range_db = np.sort(np.asarray(snr_range_db))
    length_samp = int(75e-3 * fs_hz)
    if length_samp % 2 == 1:
        length_samp += 1
    window = windows.hamming(length_samp, sym=False)
    step = len(window) // 2
    assert 0.1 <= gamma <= 2, (
        f"{gamma} is not in the valid range for gamma [0.1, 5]"
    )
    aud_fb = auditory_filters_gammatone(
        frequency_range_hz=f_range, resolution=1, sampling_rate_hz=fs_hz
    )
    x_bands = aud_fb.filter_signal(x, mode=FilterBankMode.Parallel)
    xhat_bands = aud_fb.filter_signal(xhat, mode=FilterBankMode.Parallel)

    n_channels = xhat.number_of_channels
    out = np.zeros(n_channels)
    eps = 1e-30
    lo, hi = float(snr_range_db[0]), float(snr_range_db[1])

    def _fwsnrseg_channel(xb, xhb, wj):
        # frames: (bands, K, L)
        Xf = frame_signal(xb, len(window), step, True) * wj
        Xhf = frame_signal(xhb, len(window), step, True) * wj
        X = jnp.abs(jnp.fft.rfft(Xf, axis=-1))  # (bands, K, F)
        Xh = jnp.abs(jnp.fft.rfft(Xhf, axis=-1))
        W = X**gamma
        Xn = X / jnp.sum(X, axis=-1, keepdims=True)
        Xhn = Xh / jnp.sum(Xh, axis=-1, keepdims=True)
        # log-domain form of the reference's log10(Xn^2/(Xn-Xhn+eps)^2)
        # (`distances/_distances.py:177`): squaring the near-cancelling
        # difference first underflows to exactly 0 in float32 (the
        # reference runs in float64), turning single bins into +inf and
        # clipping whole frames to the SNR ceiling
        snr_jm = jnp.sum(
            2.0
            * (jnp.log10(Xn + eps) - jnp.log10(jnp.abs(Xn - Xhn) + eps))
            * W,
            axis=0,
        )  # (K, F)
        weights = jnp.sum(W, axis=0)
        snr_frame = jnp.mean(10 * snr_jm / weights, axis=-1)  # (K,)
        snr_frame = jnp.clip(snr_frame, min=lo, max=hi)
        return jnp.mean(snr_frame)

    from .._config import run_maybe_jitted

    wj = jnp.asarray(window)
    for ch in range(n_channels):
        ch_x = 0 if multichannel else ch
        # stack bands on device instead of fetching every band's full
        # buffer to the host
        xb = jnp.stack(
            [b.time_data_jax[:, ch_x] for b in x_bands.bands], axis=0
        )  # (bands, T)
        xhb = jnp.stack(
            [b.time_data_jax[:, ch] for b in xhat_bands.bands], axis=0
        )
        out[ch] = float(run_maybe_jitted(_fwsnrseg_channel, xb, xhb, wj))
    return out
