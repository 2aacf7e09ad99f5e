"""Plain float64 references for the measurement chain.

Each function restates one library semantics in the most direct
numpy/scipy form, without importing the library. `chip_smoke.py` compares
the card's results against these at real sizes; `tests/test_chip_smoke.py`
checks each of them against the library at a small size on the CPU.

Conventions follow the library (and the dsptoolbox reference it mirrors):
signals are channels-first ``(C, T)`` here, frames are counted as
``ceil(T / step)`` with zero padding at the end, and windows are periodic.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as sps
from scipy.fft import next_fast_len


def scale_relative_error(actual, desired) -> float:
    """``max|a - d| / max|d|``: the error measure of every comparison
    (fp32 spectra carry noise near zero bins that an elementwise rtol
    would flag)."""
    actual = np.asarray(actual)
    desired = np.asarray(desired)
    if actual.shape != desired.shape:
        raise ValueError(f"shape {actual.shape} != {desired.shape}")
    scale = float(np.max(np.abs(desired))) or 1.0
    return float(np.max(np.abs(actual - desired)) / scale)


def pad_for_frames(x: np.ndarray, window_length: int, step: int):
    """Zero-pad the last axis so that ``ceil(T / step)`` whole frames fit,
    the library's framing convention. Returns ``(padded, n_frames)``."""
    T = x.shape[-1]
    n_frames = math.ceil(T / step)
    span = (n_frames - 1) * step + window_length
    pad = [(0, 0)] * (x.ndim - 1) + [(0, max(0, span - T))]
    return np.pad(x, pad)[..., :span], n_frames


def welch_psd(x: np.ndarray, fs: int, window_length: int, step: int):
    """One-sided Welch PSD ``(C, F)`` of ``x (C, T)``, Hann window, mean
    averaging, no detrending."""
    xp, _ = pad_for_frames(np.asarray(x, np.float64), window_length, step)
    _, p = sps.welch(
        xp, fs, window="hann", nperseg=window_length,
        noverlap=window_length - step, detrend=False, scaling="density",
        axis=-1,
    )
    return p


def csm_welch(x: np.ndarray, fs: int, window_length: int, step: int):
    """Cross-spectral matrix ``(F, C, C)`` with ``csm[:, i, j] =
    csd(x_j, x_i)`` (one-sided density, Hann, mean, no detrending)."""
    xp, _ = pad_for_frames(np.asarray(x, np.float64), window_length, step)
    C = xp.shape[0]
    rows = []
    for i in range(C):
        _, pij = sps.csd(
            xp, xp[i][None, :], fs, window="hann", nperseg=window_length,
            noverlap=window_length - step, detrend=False,
            scaling="density", axis=-1,
        )
        rows.append(pij)  # (C, F): csd(x_j, x_i) for every j
    return np.transpose(np.stack(rows), (2, 0, 1))


def stft(x: np.ndarray, window_length: int, step: int):
    """Unscaled STFT ``(F, n_frames, C)`` of ``x (C, T)`` with the library's
    padding: ``window_length - step`` zeros on both sides, then whole
    frames."""
    overlap = window_length - step
    x = np.pad(np.asarray(x, np.float64), ((0, 0), (overlap, overlap)))
    xp, _ = pad_for_frames(x, window_length, step)
    win = sps.get_window("hann", window_length)
    _, _, S = sps.stft(
        xp, window=win, nperseg=window_length, noverlap=overlap,
        boundary=None, padded=False, axis=-1,
    )
    # scipy scales by 1/sum(window); the library's FFTBackward does not
    return np.transpose(S * win.sum(), (1, 2, 0))


def stft_energy(x: np.ndarray, window_length: int, step: int):
    """``sum |S|^2`` over frames and bins per channel, ``(C,)``."""
    S = stft(x, window_length, step)
    return np.sum(np.abs(S) ** 2, axis=(0, 1))


def sosfilt(sos, x: np.ndarray) -> np.ndarray:
    """Zero-state SOS cascade over the last axis, in float64/complex128."""
    sos = np.asarray(sos)
    dtype = np.complex128 if np.iscomplexobj(sos) else np.float64
    return sps.sosfilt(sos.astype(dtype), np.asarray(x, dtype), axis=-1)


def linkwitz_riley_bands(sos_pairs, x: np.ndarray, zero_phase=False):
    """Band outputs of a Linkwitz-Riley crossover tree: band ``k`` is the
    low-pass of crossover ``k`` applied to the high-passed remainder,
    followed by the all-pass (LP + HP) of every later crossover; the last
    band is the remainder. ``zero_phase`` runs each split forward and
    backward (one half of each squared section, no all-passes)."""
    x = np.asarray(x, np.float64)
    bands = []
    if zero_phase:
        for lp, hp in sos_pairs:
            half = lp.shape[0] // 2 if lp.shape[0] > 1 else 1
            bands.append(sps.sosfiltfilt(lp[:half], x, axis=-1))
            x = sps.sosfiltfilt(hp[:half], x, axis=-1)
        bands.append(x)
        return bands
    for k, (lp, hp) in enumerate(sos_pairs):
        band = sps.sosfilt(lp, x, axis=-1)
        x = sps.sosfilt(hp, x, axis=-1)
        for lp2, hp2 in sos_pairs[k + 1:]:
            band = sps.sosfilt(lp2, band, axis=-1) + sps.sosfilt(
                hp2, band, axis=-1
            )
        bands.append(band)
    bands.append(x)
    return bands


def regularization_eps(denominator_spectrum, freqs, fs, threshold_db=-30.0):
    """Kirkeby regularization profile ``(F,)``: zero between the first and
    last bin within ``threshold_db`` of the excitation's peak, rising to
    +30 dB (linear 31.6) through half-Hann flanks that span half an
    octave on either side."""
    mag = np.abs(denominator_spectrum)
    db = 20 * np.log10(np.maximum(mag, np.finfo(np.float64).tiny))
    above = np.nonzero(db - db.max() > threshold_db)[0]
    f_lo, f_hi = freqs[above[0]], freqs[above[-1]]
    edges = [f_lo / np.sqrt(2), f_lo, f_hi, min(f_hi * np.sqrt(2), fs / 2)]
    i0, i1, i2, i3 = (int(np.argmin(np.abs(freqs - e))) for e in edges)
    F = len(freqs)
    w = np.zeros(F)
    n_low = i1 - i0
    if n_low > 0:
        k = np.arange(n_low)
        w[i0:i1] = 0.5 - 0.5 * np.cos(2 * np.pi * k / (2 * n_low))
    w[i1:i2] = 1.0
    n_high = i3 - i2
    if n_high > 1:
        k = np.arange(n_high, 2 * n_high)
        w[i2:i3] = 0.5 - 0.5 * np.cos(2 * np.pi * k / (2 * n_high))
    else:
        w[i2:i3] = 1.0
    return (1.0 - w) * 10 ** (30 / 20)


def deconvolve(recorded: np.ndarray, excitation: np.ndarray, fs: int):
    """Regularized spectral division of ``recorded (C, T)`` by the mono
    ``excitation (T,)``: ``Y conj(X) / (|X|^2 + eps)`` on a fast FFT
    length, inverse-transformed to ``T`` samples. Returns ``(C, T)``."""
    T = recorded.shape[-1]
    n = next_fast_len(T, True)
    Y = np.fft.rfft(np.asarray(recorded, np.float64), n=n, axis=-1)
    X = np.fft.rfft(np.asarray(excitation, np.float64), n=n)
    freqs = np.fft.rfftfreq(n, 1 / fs)
    eps = regularization_eps(X, freqs, fs)
    H = Y * np.conj(X) / (np.abs(X) ** 2 + eps)
    return np.fft.irfft(H, n=T, axis=-1)


def schroeder_t20(ir: np.ndarray, fs: int) -> float:
    """T20 from the Schroeder backward integral of ``ir`` from its peak:
    least-squares line through the -5..-25 dB part, extrapolated to 60 dB."""
    ir = np.asarray(ir, np.float64)
    e = ir[int(np.argmax(np.abs(ir))):] ** 2
    edc = np.cumsum(e[::-1])[::-1]
    db = 10 * np.log10(np.maximum(edc / edc[0], 1e-300))
    t = np.arange(len(e)) / fs
    sel = (db <= -5) & (db >= -25)
    slope = np.polyfit(t[sel], db[sel], 1)[0]
    return -60.0 / slope


def das_map(csm: np.ndarray, amp: np.ndarray, diff: np.ndarray, k):
    """Delay-and-sum power ``(G, F)``: ``Re(h^H C h)`` with steering
    ``h[m, g] = amp[m, g] exp(-1j k_f diff[m, g])``, one bin at a time."""
    out = np.empty((amp.shape[1], len(k)))
    for f, kf in enumerate(k):
        h = amp * np.exp(-1j * kf * diff)  # (M, G)
        out[:, f] = np.real(np.sum(np.conj(h) * (csm[f] @ h), axis=0))
    return out


def complex_smoothing(spectrum: np.ndarray, freqs, octave_fraction, window_y):
    """Fractional-octave smoothing ``(F, ...)`` of a linear-grid spectrum
    with the log-spaced per-bin window of dsptoolbox: bin ``i`` averages
    bins ``[i - a, i + b]`` (half-band widths rounded to bins), weighted by
    ``window_y`` sampled at ``logspace(log10 3, 0, width) - 2`` and
    normalized; rows narrower than three bins are left unchanged."""
    spectrum = np.asarray(spectrum)
    freqs = np.asarray(freqs, np.float64)
    F = len(freqs)
    df = freqs[1] - freqs[0]
    factor = 2.0 ** (1.0 / octave_fraction / 2.0)
    window_x = np.linspace(-1.0, 1.0, len(window_y))
    out = spectrum.astype(np.result_type(spectrum.dtype, np.float64)).copy()
    for i in range(F):
        f0 = freqs[i]
        lo = i - int((f0 - f0 / factor) / df + 0.5)
        hi = i + int((f0 * factor - f0) / df + 0.5) + 1
        lo_c, hi_c = max(lo, 0), min(hi, F)
        if lo_c + 2 >= hi_c:
            continue
        pos = np.logspace(np.log10(3.0), 0.0, hi - lo)[: hi_c - lo_c] - 2.0
        w = np.interp(pos, window_x, window_y)
        out[i] = np.tensordot(w / w.sum(), spectrum[lo_c:hi_c], axes=1)
    return out
