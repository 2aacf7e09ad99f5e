"""Spectrum scaling, normalization and frequency-response interpolation.

Behavioral reference: `dsptoolbox/helpers/spectrum_utilities.py`.

Device notes: frequency vectors are static, so interpolation onto new grids
is a *static linear operator* applied to traced data. For the linear scheme the
operator is two gathers + a lerp; for quadratic/cubic splines the full
(banded) operator matrix is built host-side once per grid pair (scipy
numerics → exact parity) and applied as a single matmul.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..standard.enums import MagnitudeNormalization, SpectrumScaling
from .other import find_nearest_points_index_in_vector  # noqa: F401  (re-export)
from .gain_and_level import from_db, to_db
from .smoothing import fractional_octave_smoothing


def wrap_phase(phase_vector: jnp.ndarray) -> jnp.ndarray:
    """Wrap phase into [-pi, pi) (`helpers/spectrum_utilities.py:11`)."""
    return (phase_vector + jnp.pi) % (2 * jnp.pi) - jnp.pi




def get_exact_gain_1khz(f: np.ndarray, sp_db: jnp.ndarray) -> jnp.ndarray:
    """Linear interpolation of the (possibly dB) spectrum at 1 kHz along the
    first axis (`helpers/spectrum_utilities.py:30-57`)."""
    assert np.min(f) < 1e3 and np.max(f) >= 1e3, (
        "No gain at 1 kHz can be obtained because it is outside the "
        "given frequency vector"
    )
    ind = int(find_nearest_points_index_in_vector(1e3, f).squeeze())
    if f[ind] > 1e3:
        ind -= 1
    w = (1e3 - f[ind]) / (f[ind + 1] - f[ind])
    return sp_db[ind] + (sp_db[ind + 1] - sp_db[ind]) * w


def correct_for_real_phase_spectrum(phase_spectrum: jnp.ndarray) -> jnp.ndarray:
    """Linear-phase offset so the phase at Nyquist is a multiple of pi
    (`helpers/spectrum_utilities.py:228-265`). First axis = frequency."""
    factor = phase_spectrum[-1] % np.pi
    ramp = jnp.linspace(0.0, 1.0, phase_spectrum.shape[0])
    if phase_spectrum.ndim == 1:
        return phase_spectrum - ramp * factor
    return phase_spectrum - ramp[:, None] * factor[None, ...]


def scale_spectrum(
    spectrum: jnp.ndarray,
    scaling: SpectrumScaling,
    time_length_samples: int,
    sampling_rate_hz: int,
    window: np.ndarray | None = None,
) -> jnp.ndarray:
    """Scale a backward-normalized rfft spectrum (frequency on first axis)
    into the given scaling (`helpers/spectrum_utilities.py:268-329`)."""
    assert time_length_samples in (
        (spectrum.shape[0] - 1) * 2,
        spectrum.shape[0] * 2 - 1,
    ), "Time length does not match"
    factor = scaling.get_scaling_factor(
        time_length_samples, sampling_rate_hz, window
    )
    edge = np.ones(spectrum.shape[0])
    edge[0] = 1 / 2**0.5
    if time_length_samples % 2 == 0:
        edge[-1] = 1 / 2**0.5
    spectrum = spectrum * jnp.asarray(edge).reshape(
        (-1,) + (1,) * (spectrum.ndim - 1)
    )
    if not scaling.is_amplitude_scaling():
        spectrum = jnp.abs(spectrum) ** 2
    return spectrum * factor


def get_normalized_spectrum(
    f: np.ndarray,
    spectra: jnp.ndarray,
    is_amplitude_scaling: bool,
    f_range_hz,
    normalize: MagnitudeNormalization,
    smoothing: int,
    phase: bool,
    calibrated_data: bool,
):
    """Magnitude (dB) spectrum with range selection, smoothing and
    normalization (`helpers/spectrum_utilities.py:60-226`).

    Presentation boundary: the result feeds matplotlib, so the math runs
    host-side in numpy after one (complex-safe) device→host materialization.
    Only the fractional-octave smoothing kernel stays on device (real data).
    Eager device math here would be one dispatch per op.
    """

    spectra = np.asarray(spectra)
    one_dimensional = spectra.ndim < 2
    if one_dimensional:
        spectra = spectra[..., None]
    if phase:
        assert np.iscomplexobj(spectra), (
            "Phase computation is not possible since the spectra are not "
            "complex"
        )
    if is_amplitude_scaling:
        scale_factor = (
            20e-6
            if calibrated_data
            and normalize == MagnitudeNormalization.NoNormalization
            else 1
        )
    else:
        scale_factor = (
            4e-10
            if calibrated_data
            and normalize == MagnitudeNormalization.NoNormalization
            else 1
        )

    if f_range_hz is not None:
        assert len(f_range_hz) == 2, (
            "Frequency range must have only a lower and an upper bound"
        )
        f_range_hz = np.sort(np.asarray(f_range_hz))
        ids = find_nearest_points_index_in_vector(f_range_hz, f)
        id1, id2 = int(ids[0]), int(ids[1]) + 1
    else:
        id1, id2 = 0, len(f)

    spectra = spectra[id1:id2]
    mag = np.abs(spectra)
    f = f[id1:id2]

    # parity: the reference's nested `if is_amplitude_scaling:` makes its
    # power-smoothing branch DEAD code (`spectrum_utilities.py:155-165`) —
    # power-scaled spectra are never smoothed here either
    if smoothing != 0 and is_amplitude_scaling:
        mag = np.asarray(
            fractional_octave_smoothing(mag, None, smoothing)
        )

    def _to_db_np(x, amplitude_input, dynamic_range_db=None):
        factor = 20.0 if amplitude_input else 10.0
        x_abs = np.abs(x)
        if dynamic_range_db is not None:
            min_val = np.max(x_abs) * 10.0 ** (
                -abs(dynamic_range_db) / factor
            )
        else:
            min_val = float(np.finfo(np.float64).smallest_normal)
        return factor * np.log10(np.clip(x_abs, min_val, None))

    mag_db = _to_db_np(mag / scale_factor, is_amplitude_scaling, 500)

    if normalize == MagnitudeNormalization.OneKhz:
        norm_db = np.asarray(get_exact_gain_1khz(f, mag_db))
    elif normalize == MagnitudeNormalization.OneKhzFirstChannel:
        norm_db = np.ones(spectra.shape[1]) * np.asarray(
            get_exact_gain_1khz(f, mag_db[:, 0])
        )
    elif normalize == MagnitudeNormalization.Max:
        norm_db = np.max(mag_db, axis=0)
    elif normalize == MagnitudeNormalization.MaxFirstChannel:
        norm_db = np.max(mag_db[:, 0], axis=0, keepdims=True)
    elif normalize == MagnitudeNormalization.Energy:
        norm_db = _to_db_np(
            np.mean(mag**2.0 if is_amplitude_scaling else mag, axis=0), False
        )
    elif normalize == MagnitudeNormalization.EnergyFirstChannel:
        norm_db = _to_db_np(
            np.mean(
                mag[:, 0] ** 2.0 if is_amplitude_scaling else mag,
                axis=0,
                keepdims=True,
            ),
            False,
        )
    elif normalize == MagnitudeNormalization.NoNormalization:
        norm_db = np.zeros(mag.shape[1])
    else:
        raise ValueError("No valid normalization")

    norm_db = np.atleast_1d(norm_db)
    mag_db = mag_db - norm_db[None, :]

    phase_spectra = None
    if phase:
        phase_spectra = np.angle(spectra)
        if smoothing != 0:
            smoothed = np.asarray(
                fractional_octave_smoothing(
                    np.unwrap(phase_spectra, axis=0), None, smoothing
                )
            )
            phase_spectra = (smoothed + np.pi) % (2 * np.pi) - np.pi

    if one_dimensional:
        mag_db = np.squeeze(mag_db)
        if phase:
            phase_spectra = np.squeeze(phase_spectra)
    if phase:
        return f, mag_db, phase_spectra
    return f, mag_db


@lru_cache(maxsize=32)
def _spline_operator(
    f_interp_key: tuple, f_target_key: tuple, kind: str
) -> np.ndarray:
    """Static interpolation operator A with interpolated = A @ y, built by
    passing identity basis vectors through scipy's interp1d (zero fill)."""
    from scipy.interpolate import interp1d

    f_interp = np.asarray(f_interp_key)
    f_target = np.asarray(f_target_key)
    eye = np.eye(len(f_interp))
    A = interp1d(
        f_interp,
        eye,
        kind=kind,
        axis=0,
        copy=False,
        bounds_error=False,
        fill_value=0.0,
        assume_sorted=True,
    )(f_target)
    return np.asarray(A)


def interpolate_fr(
    f_interp: np.ndarray,
    fr_interp: jnp.ndarray,
    f_target: np.ndarray,
    mode: str | None = None,
    interpolation_scheme: str = "linear",
) -> jnp.ndarray:
    """Interpolate a frequency response onto a new static frequency vector
    along the first axis (`helpers/spectrum_utilities.py:331-454`).

    Linear scheme → gather + lerp; quadratic/cubic → one static-operator
    matmul (scipy-spline numerics). Out-of-range fill is 0, except
    in ``*2db`` mode where the edge values are used.
    """
    f_interp = np.asarray(f_interp, dtype=np.float64)
    f_target = np.asarray(f_target, dtype=np.float64)
    y = jnp.asarray(fr_interp)
    db_fill = False

    if mode is not None:
        mode = mode.lower()
        if mode == "power2amplitude":
            y = y**0.5
        elif mode == "amplitude2power":
            y = y**2.0
        elif mode[:3] == "db2":
            y = from_db(y, "amplitude" in mode)
        elif mode[-3:] == "2db":
            y = to_db(y, "amplitude" in mode)
            db_fill = True
        else:
            raise ValueError(f"Unsupported interpolation mode: {mode}")

    in_range = (f_target >= f_interp[0]) & (f_target <= f_interp[-1])
    if interpolation_scheme == "linear":
        from .interpolation import linear_interpolate

        interpolated = linear_interpolate(f_interp, y, f_target, axis=0)
        mask = jnp.asarray(in_range).reshape((-1,) + (1,) * (y.ndim - 1))
        interpolated = jnp.where(mask, interpolated, 0.0)
    elif interpolation_scheme in ("quadratic", "cubic"):
        A = _spline_operator(
            tuple(f_interp.tolist()),
            tuple(f_target.tolist()),
            interpolation_scheme,
        )
        y2d = y.reshape(y.shape[0], -1)
        interpolated = jnp.asarray(A, dtype=y2d.dtype) @ y2d
        interpolated = interpolated.reshape((len(f_target),) + y.shape[1:])
    else:
        raise ValueError(
            f"Unsupported interpolation scheme: {interpolation_scheme}"
        )

    if db_fill:
        below = jnp.asarray(f_target < f_interp[0]).reshape(
            (-1,) + (1,) * (y.ndim - 1)
        )
        above = jnp.asarray(f_target > f_interp[-1]).reshape(
            (-1,) + (1,) * (y.ndim - 1)
        )
        interpolated = jnp.where(below, y[0], interpolated)
        interpolated = jnp.where(above, y[-1], interpolated)

    if mode is not None:
        if mode == "power2amplitude":
            interpolated = interpolated**2.0
        elif mode == "amplitude2power":
            interpolated = interpolated**0.5
        elif mode[:3] == "db2":
            interpolated = to_db(interpolated, "amplitude" in mode)
        elif mode[-3:] == "2db":
            interpolated = from_db(interpolated, "amplitude" in mode)
    return interpolated


def warp_frequency_vector(
    freqs_hz: np.ndarray, sampling_rate_hz: int, warping_factor: float
) -> np.ndarray:
    """Warped frequency vector (Ramos et al.; static host computation,
    `helpers/spectrum_utilities.py:456-489`)."""
    assert np.abs(warping_factor) < 1.0, "Warping factor must be between ]-1;1["
    omega = 2 * np.pi * np.asarray(freqs_hz) / sampling_rate_hz
    return freqs_hz + sampling_rate_hz / np.pi * np.arctan(
        -warping_factor * np.sin(omega) / (1 + warping_factor * np.cos(omega))
    )
