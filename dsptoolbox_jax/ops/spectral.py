"""Spectral estimation: Welch auto/cross spectra, STFT, cross-spectral matrix.

Device design notes
-------------------
- Inputs are channels-first ``(..., T)``; the FFT runs on the minor axis with
  (channels × frames) as a large batch — the layout XLA tiles best.
- The O(channels²) pairwise Python loop of the reference CSM
  (`standard/_spectral_methods.py:285-371`) collapses into one batched outer
  product over the framed spectra (one einsum).
- All scaling factors are trace-time scalars (see `standard/enums.py`), folded
  by XLA into the surrounding kernels.

Behavioral reference: `dsptoolbox/standard/_spectral_methods.py`. Quirks of
the reference are reproduced intentionally and marked with "parity:" comments.
"""

from __future__ import annotations

from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np

from .._config import default_float
from ..standard.enums import SpectrumScaling, Window
from .framing import frame_signal
from .windows import check_cola, get_window

_VALID_WELCH_SIZES = {2**k for k in range(3, 19)}
_VALID_STFT_SIZES = {2**k for k in range(4, 17)}


def _windowed_frames(
    x: jnp.ndarray,
    window: np.ndarray,
    step: int,
    detrend: bool,
    keep_last_frames: bool = True,
) -> jnp.ndarray:
    """Frame ``x (..., T)``, apply window, optionally remove per-frame mean.

    parity: the reference detrends *after* windowing
    (`_spectral_methods.py:137-148`).
    """
    frames = frame_signal(x, len(window), step, keep_last_frames=keep_last_frames)
    frames = frames.astype(default_float()) * jnp.asarray(
        window, dtype=default_float()
    )
    if detrend:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    return frames


def _median_bias_reference(n_frames: int) -> float:
    """parity: the reference (`_spectral_methods.py:154-162`) computes the
    FINDCHIRP median bias with a scalar instead of the harmonic-like series,
    yielding 1/n for odd n. Reproduced verbatim for output parity."""
    n = n_frames if n_frames % 2 == 1 else n_frames - 1
    return float(np.sum((-1.0) ** (n + 1) / n))


def _average_frames(sp_frames: jnp.ndarray, average: str) -> jnp.ndarray:
    """Average per-frame (cross-)spectra over the frame axis (-2)."""
    if average == "mean":
        return jnp.mean(sp_frames, axis=-2)
    if average == "median":
        med = jnp.median(sp_frames.real, axis=-2)
        if jnp.iscomplexobj(sp_frames):
            med = med + 1j * jnp.median(sp_frames.imag, axis=-2)
        return med / _median_bias_reference(sp_frames.shape[-2])
    raise ValueError(f"average must be 'mean' or 'median', got {average!r}")


@jax.named_scope("dsptb.welch")
def welch(
    x: jnp.ndarray,
    y: jnp.ndarray | None = None,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    detrend: bool = True,
    average: str = "mean",
    scaling: SpectrumScaling = SpectrumScaling.PowerSpectralDensity,
) -> jnp.ndarray:
    """Welch auto-/cross-spectral estimation.

    Parameters: ``x`` (and optional ``y``) channels-first ``(..., T)``.
    Returns ``(..., F)`` with ``F = window_length // 2 + 1`` — real for
    autospectra, complex for cross-spectra (before amplitude sqrt).

    Matches `dsptoolbox/standard/_spectral_methods.py:10-173` numerically.
    """
    if window_length_samples not in _VALID_WELCH_SIZES:
        raise ValueError(
            "Window length should be a power of 2 in [2**3, 2**18], got "
            f"{window_length_samples}"
        )
    if not (0 <= overlap_percent < 100):
        raise ValueError("overlap_percent must be in [0, 100)")

    window = get_window(window_type, window_length_samples, symmetric=False)
    overlap = int(overlap_percent / 100 * window_length_samples)
    step = window_length_samples - overlap
    if not check_cola(window, step):
        warn(
            "Selected window type and overlap do not meet the constant "
            "overlap and add constraint! Results might be distorted"
        )

    norm = scaling.fft_norm()
    x_frames = _windowed_frames(x, window, step, detrend)
    if y is None:
        sp_frames = jnp.abs(jnp.fft.rfft(x_frames, axis=-1, norm=norm)) ** 2.0
    else:
        if x.shape != y.shape:
            raise ValueError("Shapes of x and y do not match")
        y_frames = _windowed_frames(y, window, step, detrend)
        sp_frames = jnp.conjugate(
            jnp.fft.rfft(x_frames, axis=-1, norm=norm)
        ) * jnp.fft.rfft(y_frames, axis=-1, norm=norm)

    csd = _average_frames(sp_frames, average)

    if scaling.has_physical_units():
        # parity: the reference multiplies the *squared* data by the factor
        # returned for the scaling's own representation (linear for amplitude
        # scalings) and only then takes the sqrt (`_spectral_methods.py:164-173`)
        factor = scaling.get_scaling_factor(
            window_length_samples, sampling_rate_hz, window
        )
        csd = csd * factor
        # one-sided correction: halve DC and Nyquist
        edge = np.ones(csd.shape[-1])
        edge[0] = edge[-1] = 0.5
        csd = csd * jnp.asarray(edge, dtype=csd.real.dtype)
    # parity: sqrt applies for every amplitude scaling, incl. bare FFT norms
    if scaling.is_amplitude_scaling():
        csd = jnp.sqrt(csd)
    return csd


@jax.named_scope("dsptb.stft")
def stft(
    x: jnp.ndarray,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    fft_length_samples: int | None = None,
    detrend: bool = False,
    padding: bool = True,
    scaling: SpectrumScaling = SpectrumScaling.FFTBackward,
):
    """Short-time Fourier transform of ``x (..., T)``.

    Returns ``(time_s, freqs_hz, S)`` with ``S`` shaped ``(..., n_frames, F)``
    (channels-first; the class layer transposes to the reference's
    ``(F, n_frames, C)`` order).

    Matches `dsptoolbox/standard/_spectral_methods.py:176-282`.
    """
    if window_length_samples not in _VALID_STFT_SIZES:
        raise ValueError(
            "Window length should be a power of 2 in [2**4, 2**16], got "
            f"{window_length_samples}"
        )
    if not (0 <= overlap_percent < 100):
        raise ValueError("overlap_percent must be in [0, 100)")
    if fft_length_samples is None:
        fft_length_samples = window_length_samples

    window = get_window(window_type, window_length_samples, symmetric=False)
    # parity: STFT rounds the overlap, welch truncates (reference :246 vs :107)
    overlap = int(overlap_percent / 100 * window_length_samples + 0.5)
    step = window_length_samples - overlap
    if step <= 0:
        raise ValueError(
            f"overlap_percent={overlap_percent} rounds to a full window "
            f"({overlap}/{window_length_samples} samples): the hop size "
            "would be zero. Reduce the overlap."
        )
    if not check_cola(window, step):
        warn(
            "Selected window type and overlap do not meet the constant "
            "overlap and add constraint! Results might be distorted"
        )

    if padding:
        pad_widths = [(0, 0)] * (x.ndim - 1) + [(overlap, overlap)]
        x = jnp.pad(x, pad_widths)
    length_padded = x.shape[-1]

    frames = _windowed_frames(x, window, step, detrend)
    S = jnp.fft.rfft(
        frames, axis=-1, n=fft_length_samples, norm=scaling.fft_norm()
    )

    if scaling.has_physical_units():
        edge = np.ones(S.shape[-1])
        edge[0] = 1 / 2**0.5
        if fft_length_samples % 2 == 0:
            edge[-1] = 1 / 2**0.5
        S = S * jnp.asarray(edge)
        factor = scaling.get_scaling_factor(
            fft_length_samples, sampling_rate_hz, window
        )
        if not scaling.is_amplitude_scaling():
            S = jnp.abs(S) ** 2.0
        S = S * factor

    n_frames = S.shape[-2]
    time_s = np.linspace(0, length_padded / sampling_rate_hz, n_frames)
    # parity: frequency vector always from the *window* length (:281)
    freqs_hz = np.fft.rfftfreq(len(window), 1 / sampling_rate_hz)
    return time_s, freqs_hz, S


def _assemble_csm_reference_order(Q: jnp.ndarray) -> jnp.ndarray:
    """Build the Hermitian CSM exactly as the reference does
    (`_spectral_methods.py:351-370`): keep the lower triangle
    ``csm[:, i2, i1] = Q[:, i1, i2]`` (i2 ≥ i1) with halved diagonal, then add
    its conjugate transpose."""
    n_ch = Q.shape[-1]
    lower = jnp.swapaxes(Q, -1, -2)
    mask = np.tril(np.ones((n_ch, n_ch)))
    np.fill_diagonal(mask, 0.5)
    lower = lower * jnp.asarray(mask)
    return lower + jnp.conjugate(jnp.swapaxes(lower, -1, -2))


@jax.named_scope("dsptb.csm_welch")
def csm_welch(
    time_data: jnp.ndarray,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    detrend: bool = True,
    average: str = "mean",
    scaling: SpectrumScaling = SpectrumScaling.PowerSpectralDensity,
):
    """Cross-spectral matrix of ``time_data (C, T)`` via Welch.

    Returns ``(f, csm)`` with ``csm (F, C, C)``. One batched outer product
    replaces the reference's O(C²) per-pair `_welch` loop
    (`_spectral_methods.py:351-369`) — identical numerics, one contraction.
    """
    if window_length_samples not in _VALID_WELCH_SIZES:
        raise ValueError("Window length should be a power of 2 in [2**3, 2**18]")
    window = get_window(window_type, window_length_samples, symmetric=False)
    overlap = int(overlap_percent / 100 * window_length_samples)
    step = window_length_samples - overlap
    if not check_cola(window, step):
        warn(
            "Selected window type and overlap do not meet the constant "
            "overlap and add constraint! Results might be distorted"
        )

    norm = scaling.fft_norm()
    frames = _windowed_frames(time_data, window, step, detrend)  # (C, K, L)
    X = jnp.fft.rfft(frames, axis=-1, norm=norm)  # (C, K, F)

    if average == "mean":
        K = X.shape[-2]
        # Q[f, a, b] = mean_k conj(X[a,k,f]) X[b,k,f]; HIGHEST keeps the
        # contraction in full fp32 (the default may run TF32/bf16 — ~1e-3
        # relative error, far outside the 1e-5 parity budget)
        Q = (
            jnp.einsum(
                "akf,bkf->fab",
                jnp.conjugate(X),
                X,
                precision=jax.lax.Precision.HIGHEST,
            )
            / K
        )
        # exact-real diagonal like the reference's |X|² autospectrum branch
        diag_real = (
            jnp.einsum(
                "akf,akf->fa",
                jnp.conjugate(X),
                X,
                precision=jax.lax.Precision.HIGHEST,
            ).real
            / K
        )
        eye = jnp.eye(Q.shape[-1], dtype=Q.dtype)
        Q = Q * (1 - eye) + diag_real[..., None] * eye
    else:
        # median over frames needs the per-pair series; chunk over the first
        # channel axis so the peak buffer is (C, K, F), not (C, C, K, F)
        bias = _median_bias_reference(X.shape[-2])
        C = X.shape[0]
        rows = []
        for a in range(C):
            pair = jnp.conjugate(X[a])[None, ...] * X  # (C, K, F)
            rows.append(
                jnp.median(pair.real, axis=-2)
                + 1j * jnp.median(pair.imag, axis=-2)
            )  # (C, F)
        med = jnp.stack(rows, axis=0)  # (A, B, F)
        Q = jnp.transpose(med, (2, 0, 1)) / bias

    if scaling.has_physical_units():
        factor = scaling.get_scaling_factor(
            window_length_samples, sampling_rate_hz, window
        )
        Q = Q * factor
        edge = np.ones(Q.shape[0])
        edge[0] = edge[-1] = 0.5
        Q = Q * jnp.asarray(edge)[:, None, None]
    # parity: per-pair sqrt applies for every amplitude scaling (see welch)
    if scaling.is_amplitude_scaling():
        Q = jnp.sqrt(Q.astype(jnp.result_type(Q.dtype, jnp.complex64)))

    csm = _assemble_csm_reference_order(Q)
    f = np.fft.rfftfreq(window_length_samples, 1 / sampling_rate_hz)
    return f, csm


def csm_from_spectrum(
    spectrum: jnp.ndarray,
    scaling: SpectrumScaling,
    window: np.ndarray | None,
    sampling_rate_hz: int,
) -> jnp.ndarray:
    """CSM from a backward-normalized multichannel spectrum ``(F, C)``.

    Matches `dsptoolbox/standard/_spectral_methods.py:374-443` (`_csm_fft`),
    including its use of ``F // 2 + 1`` as the length parameter for the
    conversion factor (parity quirk).
    """
    Q = jnp.conjugate(spectrum)[:, :, None] * spectrum[:, None, :]  # (F, a, b)
    csm = _assemble_csm_reference_order(Q)
    if scaling == SpectrumScaling.FFTBackward:
        return csm
    edge = np.ones(csm.shape[0])
    edge[0] = edge[-1] = 0.5
    csm = csm * jnp.asarray(edge)[:, None, None]
    w = None if window is None else np.asarray(window, dtype=np.float64).reshape(-1)
    factor = SpectrumScaling.FFTBackward.conversion_factor(
        scaling, spectrum.shape[0] // 2 + 1, sampling_rate_hz, w
    )
    csm = csm * factor
    if scaling.is_amplitude_scaling():
        csm = jnp.sqrt(csm)
    return csm
