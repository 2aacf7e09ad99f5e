"""Latency estimation: device-side cross-correlation, host-side sub-sample
peak refinement.

The reference (`dsptoolbox/helpers/latency.py`) finds fractional impulse
peaks via polynomial root-finding on the Hilbert transform of the
cross-correlation. The O(T log T) bulk — FFT cross-correlation and the
analytic signal — runs on device; the per-channel root finding (a handful of
samples, data-dependent branching, user warnings) runs host-side on the tiny
slice around each peak. Results are per-channel scalars the caller reads on
host anyway.
"""

from __future__ import annotations

from warnings import warn

import jax.numpy as jnp
import numpy as np

from ..ops.fft_conv import fft_correlate
from .spectrum_utilities import wrap_phase


def analytic_signal(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Hilbert analytic signal along ``axis`` (matches scipy.signal.hilbert)."""
    x = jnp.moveaxis(x, axis, -1)
    N = x.shape[-1]
    X = jnp.fft.fft(x, axis=-1)
    h = np.zeros(N)
    if N % 2 == 0:
        h[0] = h[N // 2] = 1
        h[1 : N // 2] = 2
    else:
        h[0] = 1
        h[1 : (N + 1) // 2] = 2
    out = jnp.fft.ifft(X * jnp.asarray(h), axis=-1)
    return jnp.moveaxis(out, -1, axis)


def get_fractional_impulse_peak_index(
    time_data: np.ndarray, polynomial_points: int = 1
) -> np.ndarray:
    """Sub-sample impulse peak per channel of ``time_data (T, C)``.

    Mirrors `dsptoolbox/helpers/latency.py:10-98`: quadratic (or higher)
    polynomial root of the imaginary part of the analytic signal around the
    magnitude peak; falls back to the integer peak with a warning.
    """
    time_data = np.asarray(time_data)
    n_channels = time_data.shape[1]
    delay_samples = np.argmax(np.abs(time_data), axis=0).astype(int)

    # restrict to the peak region (±200 safety samples, like the reference)
    time_data = time_data[: np.max(delay_samples) + 200, :]
    start_offset = max(np.min(delay_samples) - 200, 0)
    time_data = time_data[start_offset:, :]
    delay_samples = delay_samples - start_offset

    # the analytic signal is complex: take .imag INSIDE the program and
    # fetch only the real part
    from .._config import run_jitted_complex

    h = np.asarray(
        run_jitted_complex(lambda td: analytic_signal(td, axis=0).imag,
                           time_data)
    )
    x = np.arange(-polynomial_points + 1, polynomial_points + 1)
    latency_samples = np.zeros(n_channels)
    for ch in range(n_channels):
        sel = h[delay_samples[ch] : delay_samples[ch] + 2, ch]
        move_back_one_sample = bool(sel[0] * sel[1] > 0)
        delay_samples[ch] -= int(move_back_one_sample)
        if h[delay_samples[ch], ch] * h[delay_samples[ch] + 1, ch] > 0:
            latency_samples[ch] = delay_samples[ch] + int(move_back_one_sample)
            warn(
                f"Fractional latency detection failed for channel {ch}. "
                "Integer latency is returned"
            )
            continue
        pol = np.polyfit(
            x,
            h[
                delay_samples[ch] - polynomial_points + 1 : delay_samples[ch]
                + polynomial_points
                + 1,
                ch,
            ],
            deg=2 * polynomial_points - 1,
        )
        roots = np.roots(pol)
        roots = roots[(roots == roots.real) & (roots <= 1) & (roots >= 0)].real
        if len(roots) == 0:
            warn(
                f"Fractional latency detection failed for channel {ch}. "
                "Integer latency is returned"
            )
            latency_samples[ch] = delay_samples[ch] + int(move_back_one_sample)
            continue
        latency_samples[ch] = delay_samples[ch] + roots[0]
    return latency_samples + start_offset


def fractional_latency(
    td1: np.ndarray, td2: np.ndarray | None, polynomial_points: int = 1
) -> np.ndarray:
    """Sub-sample latency between signals ``(T, C)`` via the analytic
    cross-correlation (`helpers/latency.py:101-150`)."""
    td1 = np.asarray(td1)
    if td2 is None:
        td2_ = jnp.asarray(td1[:, :1].T)  # (1, T)
        # parity: the reference correlates the 2-D arrays directly
        # (`helpers/latency.py:140-142`); scipy's N-D correlate flips the
        # CHANNEL axis of in2 too, so for 3+ channels the reference
        # returns the latencies in REVERSED channel order — reproduced
        td1_ = jnp.asarray(td1[:, 1:][:, ::-1].T)  # (C-1, T) reversed
        xcor = fft_correlate(td2_, td1_)  # (C-1, L)
    else:
        xcor = fft_correlate(jnp.asarray(td2.T), jnp.asarray(td1.T))
    xcor_np = np.asarray(xcor).T  # (L, C)
    inds = get_fractional_impulse_peak_index(xcor_np, polynomial_points)
    return td1.shape[0] - inds - 1


def remove_ir_latency_from_phase(
    freqs: np.ndarray,
    phase: jnp.ndarray,
    latency_samples: np.ndarray,
    sampling_rate_hz: int,
) -> jnp.ndarray:
    """Add back the linear phase of the impulse delay and wrap
    (`helpers/latency.py:152-183`). ``phase (F, C)``."""
    delays_s = np.asarray(latency_samples) / sampling_rate_hz
    return wrap_phase(
        phase + 2 * np.pi * jnp.asarray(freqs)[:, None] * jnp.asarray(delays_s)[None, :]
    )


def correlation_of_latencies(
    time_data: np.ndarray, other_time_data: np.ndarray, latencies: np.ndarray
) -> np.ndarray:
    """Pearson correlation per channel after latency compensation
    (`helpers/latency.py:217-265`). Host-side quality metric."""
    one_channel = time_data.shape[1] == 1
    correlations = np.zeros(len(latencies))
    for ch in range(len(latencies)):
        if latencies[ch] > 0:
            undelayed = time_data[:, 0] if one_channel else time_data[:, ch]
            delayed = other_time_data[:, ch]
        else:
            undelayed = other_time_data[:, ch]
            delayed = time_data[:, 0] if one_channel else time_data[:, ch]
        delayed = delayed[abs(int(latencies[ch])) :]
        n = min(len(delayed), len(undelayed))
        d = delayed[:n] - delayed[:n].mean()
        u = undelayed[:n] - undelayed[:n].mean()
        denom = np.sqrt((d**2).sum() * (u**2).sum())
        correlations[ch] = (d * u).sum() / denom if denom > 0 else 0.0
    return correlations
