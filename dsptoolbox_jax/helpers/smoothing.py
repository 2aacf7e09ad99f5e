"""Fractional-octave and exponential time smoothing.

The reference smoothing (`dsptoolbox/helpers/smoothing.py:9`) resamples the
spectrum onto a log grid (PCHIP), convolves with a normalized window and
resamples back. Here all grids and the window are static (they depend only on
the length), so the whole chain compiles to gathers + one FFT convolution —
no host round-trips. The EMA time smoothing is a one-pole IIR evaluated with
the associative-scan recurrence from `ops.iir`.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
from scipy.signal import windows as _sw

from ..ops.fft_conv import fft_convolve
from .interpolation import linear_interpolate, pchip_interpolate


@lru_cache(maxsize=64)
def _log_grid(N: int) -> tuple:
    """Static log-frequency resampling grid of the reference
    (`helpers/smoothing.py:60-67`): k_log = N**(l/(N-1)), beta = log2(k_log[1])."""
    l1 = np.arange(N, dtype=np.float64)
    k_log = N ** (l1 / (N - 1))
    l1 = l1 + 1.0
    beta = np.log2(k_log[1])
    return l1, k_log, beta


def _smoothing_window(
    n_window: int, window_type="hann", window_vec: np.ndarray | None = None
) -> np.ndarray:
    if window_type is not None:
        assert window_vec is None
        if isinstance(window_type, tuple) and "gauss" in window_type[0]:
            # alpha parametrization → sigma (reference helpers/windows.py)
            alpha = window_type[1]
            sigma = (n_window - 1) / (2 * alpha)
            window_type = ("gaussian", sigma)
        w = _sw.get_window(window_type, n_window, fftbins=False)
    else:
        w = np.asarray(window_vec, dtype=np.float64)
    return w / w.sum()


def fractional_octave_smoothing(
    vector: jnp.ndarray,
    bin_spacing_octaves: float | None = None,
    num_fractions: int = 3,
    window_type="hann",
    window_vec: np.ndarray | None = None,
    clip_values: bool = False,
    axis: int = 0,
) -> jnp.ndarray:
    """1/``num_fractions``-octave smoothing along ``axis``.

    Numerically mirrors `dsptoolbox/helpers/smoothing.py:9` (pyfar method):
    PCHIP to log grid → edge-padded windowed moving average → linear back.
    """
    vector = jnp.moveaxis(jnp.asarray(vector), axis, 0)
    N = vector.shape[0]
    lin_spaced = bin_spacing_octaves is None
    if lin_spaced:
        l1, k_log, beta = _log_grid(N)
        work = pchip_interpolate(l1, vector, k_log, axis=0)
    else:
        beta = bin_spacing_octaves
        work = vector

    n_window = int(1 / (num_fractions * beta) + 0.5)
    n_window += 1 - n_window % 2  # odd
    window = _smoothing_window(n_window, window_type, window_vec)

    nh = n_window // 2
    pad_lo, pad_hi = nh, nh - (1 - n_window % 2)
    padded = jnp.concatenate(
        [
            jnp.repeat(work[:1], pad_lo, axis=0),
            work,
            jnp.repeat(work[-1:], pad_hi, axis=0),
        ],
        axis=0,
    )
    # window conv along axis 0 (valid): move to minor axis for the FFT conv
    pm = jnp.moveaxis(padded, 0, -1)
    sm = fft_convolve(pm, jnp.asarray(window, dtype=pm.dtype), mode="valid")
    smoothed = jnp.moveaxis(sm, -1, 0)

    if lin_spaced:
        smoothed = linear_interpolate(k_log, smoothed, l1, axis=0)
    if clip_values:
        smoothed = jnp.clip(smoothed, min=0)
    return jnp.moveaxis(smoothed, 0, axis)


def get_smoothing_factor_ema(
    relaxation_time_s: float, sampling_rate_hz: int, accuracy: float = 0.95
) -> float:
    """EMA coefficient for a given relaxation time
    (`helpers/smoothing.py:131-168`)."""
    factor = np.log(1 - accuracy)
    return float(1 - np.exp(factor / relaxation_time_s / sampling_rate_hz))


def time_smoothing_host(
    x: np.ndarray, sampling_rate_hz: int, ascending_time_s: float
) -> np.ndarray:
    """Host (scipy) single-coefficient EMA, numerically identical to the
    `time_smoothing` device path (same steady-state zi scaled by the
    first sample, `helpers/smoothing.py:220-227`). For 1-D decision-logic
    consumers whose data already lives on the host, scipy avoids a
    device round trip."""
    from scipy.signal import lfilter, lfilter_zi

    x = np.asarray(x)
    if ascending_time_s <= 0.0:
        return x.copy()  # alpha = 1: identity (matches the device guard)
    alpha = get_smoothing_factor_ema(ascending_time_s, sampling_rate_hz)
    b = np.array([alpha])
    a = np.array([1.0, -(1.0 - alpha)])
    zi = lfilter_zi(b, a)
    y, _ = lfilter(b, a, x, zi=zi * x[..., :1], axis=-1)
    return y


def time_smoothing(
    x: jnp.ndarray,
    sampling_rate_hz: int,
    ascending_time_s: float,
    descending_time_s: float | None = None,
    axis: int = -1,
) -> jnp.ndarray:
    """Exponential moving average over time with optional separate
    attack/release time constants (`helpers/smoothing.py:169`).

    Single-coefficient smoothing runs as a linear one-pole recurrence
    (associative scan); the attack/release variant, whose coefficient depends
    on the signal's direction, runs as a `lax.scan`.
    """
    import jax

    x = jnp.moveaxis(x, axis, -1)
    alpha = (
        get_smoothing_factor_ema(ascending_time_s, sampling_rate_hz)
        if ascending_time_s > 0.0
        else 1.0
    )
    if descending_time_s is None:
        from ..ops.iir import lfilter, lfilter_zi

        b = np.array([alpha])
        a = np.array([1.0, -(1.0 - alpha)])
        # parity: steady-state zi scaled by the first sample
        # (`helpers/smoothing.py:220-227`)
        zi = lfilter_zi(b, a)
        y, _ = lfilter(b, a, x, zi=zi * x[..., :1])
    else:
        beta = (
            get_smoothing_factor_ema(descending_time_s, sampling_rate_hz)
            if descending_time_s > 0.0
            else 1.0
        )

        def step(carry, xt):
            a = jnp.where(xt > carry, alpha, beta)
            new = carry + a * (xt - carry)
            return new, new

        x_t = jnp.moveaxis(x, -1, 0)
        # parity: y[0] = x[0] (`helpers/smoothing.py:246-247`); unroll
        # amortizes per-step loop overhead (latency-bound recursion)
        _, y_t = jax.lax.scan(step, x_t[0], x_t[1:], unroll=8)
        y = jnp.moveaxis(jnp.concatenate([x_t[:1], y_t], axis=0), 0, -1)
    return jnp.moveaxis(y, -1, axis)
