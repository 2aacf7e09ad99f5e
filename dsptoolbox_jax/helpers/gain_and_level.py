"""dB conversion, RMS, normalization and fades (array level).

Behavioral reference: `dsptoolbox/helpers/gain_and_level.py` (semantics
reproduced exactly: std-based RMS, flattened-RMS normalization, the fade
ramp shapes, and `to_db`'s dynamic-range floor).

Array convention here is channels-first ``(..., T)`` (time on the minor
axis); the class layer transposes at its boundary.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..standard.enums import FadeType


def to_db(
    x,
    amplitude_input: bool = True,
    dynamic_range_db: float | None = None,
    min_value: float | None = float(np.finfo(np.float64).smallest_normal),
):
    """Magnitude (or power) → dB.

    ``dynamic_range_db`` floors values at ``max - range`` (in dB);
    ``min_value`` floors absolute values before the log. With both ``None``
    the raw log is taken (may produce -inf).
    """
    # dispatch on input location: device arrays (incl. jit tracers) stay
    # jnp; host numpy/scalars stay numpy — otherwise every host
    # decision-logic caller pays an upload + eager ops + a fetch
    on_device = isinstance(x, jnp.ndarray)
    factor = 20.0 if amplitude_input else 10.0
    if on_device:
        if min_value is None and dynamic_range_db is None:
            return factor * jnp.log10(jnp.abs(x))
        x_abs = jnp.abs(x)
        if dynamic_range_db is not None:
            min_val = jnp.max(x_abs) * 10.0 ** (
                -abs(dynamic_range_db) / factor
            )
        else:
            min_val = min_value
        return factor * jnp.log10(jnp.clip(x_abs, min=min_val))
    x = np.asarray(x)
    if min_value is None and dynamic_range_db is None:
        with np.errstate(divide="ignore"):
            return factor * np.log10(np.abs(x))
    x_abs = np.abs(x)
    if dynamic_range_db is not None:
        min_val = np.max(x_abs) * 10.0 ** (-abs(dynamic_range_db) / factor)
    else:
        min_val = min_value
    return factor * np.log10(np.maximum(x_abs, min_val))


def from_db(x, amplitude_output: bool = True):
    """dB → linear amplitude (or power). Host inputs stay host (see
    `to_db`)."""
    factor = 20.0 if amplitude_output else 10.0
    if isinstance(x, jnp.ndarray):
        return 10.0 ** (x / factor)
    return 10.0 ** (np.asarray(x) / factor)


def rms(x: jnp.ndarray, axis: int = -1, remove_mean: bool = True) -> jnp.ndarray:
    """RMS along ``axis``.

    parity: the reference's ``_rms`` is ``np.std`` along time, i.e. the mean
    is removed first (`helpers/gain_and_level.py:24`). Pass
    ``remove_mean=False`` for the plain quadratic mean.
    """
    if remove_mean:
        return jnp.std(x, axis=axis)
    return jnp.sqrt(jnp.mean(jnp.abs(x) ** 2, axis=axis))


def amplify_db(x: jnp.ndarray, db: float) -> jnp.ndarray:
    return x * 10.0 ** (db / 20.0)


def normalize(
    x: jnp.ndarray,
    dbfs: float,
    peak_normalization: bool = True,
    per_channel: bool = False,
    axis: int = -1,
) -> jnp.ndarray:
    """Peak- or RMS-normalize to ``dbfs`` along the time ``axis``.

    parity: RMS mode uses std-RMS; non-per-channel RMS uses the flattened
    array (`helpers/gain_and_level.py:79-82`).
    """
    factor = 10.0 ** (dbfs / 20.0)
    if peak_normalization:
        if per_channel:
            denom = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
        else:
            denom = jnp.max(jnp.abs(x))
    else:
        if per_channel:
            denom = jnp.expand_dims(jnp.std(x, axis=axis), axis)
        else:
            denom = jnp.std(x.reshape(-1))
    return x * (factor / denom)


def fade_ramp(length_samples: int, mode: FadeType) -> np.ndarray:
    """Static fade-in ramp of the reference's three shapes
    (`helpers/gain_and_level.py:136-144`)."""
    L = int(length_samples)
    if mode == FadeType.Exponential:
        db = np.linspace(-100, 0, L)
        return 10 ** (db / 20)
    if mode == FadeType.Linear:
        return np.linspace(0, 1, L)
    if mode == FadeType.Logarithmic:
        ramp = np.log10(np.linspace(1, 50 * 10**0.5, L))
        return ramp / ramp[-1]
    raise ValueError("No valid fade")


def fade(
    x: jnp.ndarray,
    length_seconds: float,
    mode: FadeType,
    sampling_rate_hz: int,
    at_start: bool,
    axis: int = -1,
) -> jnp.ndarray:
    """Apply a fade along the time ``axis`` (multiplicative static ramp)."""
    if mode == FadeType.NoFade:
        return x
    assert length_seconds > 0, "Only positive lengths"
    L = int(length_seconds * sampling_rate_hz)
    T = x.shape[axis]
    assert T > L, "Signal is shorter than the desired fade"
    ramp = fade_ramp(L, mode)
    gain = np.ones(T)
    if at_start:
        gain[:L] = ramp
    else:
        gain[T - L :] = ramp[::-1]
    shape = [1] * x.ndim
    shape[axis] = T
    return x * jnp.asarray(gain, dtype=x.dtype).reshape(shape)
