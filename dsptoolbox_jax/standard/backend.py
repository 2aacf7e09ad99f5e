"""Array-level backend for the `standard` module.

Behavioral reference: `dsptoolbox/standard/_standard_backend.py`. Device-side
bulk math (group delay, minimum phase, thresholds); static designs
(fractional-octave grids, Kaiser fractional-delay windows) host-side.

Convention: frequency/time on the FIRST axis for the functions consumed by
the class layer (matching the reference), channels after.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from scipy.special import iv as bessel_first_mod

from ..helpers.gain_and_level import from_db
from ..helpers.spectrum_utilities import wrap_phase
from ..ops.fft_conv import fft_correlate


def latency_integer(in1: np.ndarray, in2: np.ndarray | None, *_):
    """Integer-sample latency via the correlation peak
    (`_standard_backend.py:14-35`). ``in1/in2 (T, C)``; device FFT
    correlation, host argmax readout."""
    if in2 is None:
        # parity: the reference's 2-D scipy correlate flips the channel
        # axis of in2, so for 3+ channels the latencies come back in
        # REVERSED channel order (`_standard_backend.py:24-28`; same quirk
        # as helpers.latency.fractional_latency)
        xcorr = fft_correlate(
            jnp.asarray(in1[:, :1].T), jnp.asarray(in1[:, 1:][:, ::-1].T)
        )
        peak_inds = np.argmax(np.abs(np.asarray(xcorr)), axis=-1)
    else:
        xcorr = fft_correlate(jnp.asarray(in2.T), jnp.asarray(in1.T))
        peak_inds = np.argmax(np.abs(np.asarray(xcorr)), axis=-1)
    return in1.shape[0] - peak_inds - 1


def group_delay_direct(
    phase: jnp.ndarray, delta_f: float = 1, axis: int = 0
) -> jnp.ndarray:
    """Group delay as -dφ/dω via central differences on the unwrapped phase
    (`_standard_backend.py:37-64`; np.gradient edge behavior reproduced)."""
    if jnp.iscomplexobj(phase):
        phase = jnp.angle(phase)
    ph = jnp.unwrap(phase, axis=axis)
    ph = jnp.moveaxis(ph, axis, 0)
    # np.gradient: central differences, one-sided at edges
    inner = (ph[2:] - ph[:-2]) / 2.0
    first = (ph[1] - ph[0])[None]
    last = (ph[-1] - ph[-2])[None]
    grad = jnp.concatenate([first, inner, last], axis=0)
    grad = jnp.moveaxis(grad, 0, axis)
    if delta_f != 1:
        return -grad / delta_f / np.pi / 2
    return -grad


def minimum_phase_from_magnitude(
    magnitude: jnp.ndarray,
    whole_spectrum: bool = False,
    unwrapped: bool = True,
    odd_length: bool = False,
) -> jnp.ndarray:
    """Minimum phase from a magnitude spectrum via the Hilbert transform of
    the log magnitude (`_standard_backend.py:66-121`). First axis =
    frequency."""
    from ..helpers.latency import analytic_signal

    if jnp.iscomplexobj(magnitude):
        magnitude = jnp.abs(magnitude)
    max_value = jnp.max(magnitude)
    lowest = from_db(-500.0, True) * max_value
    log_mag = jnp.log(jnp.clip(magnitude, min=lowest))
    original_length = magnitude.shape[0]
    if not whole_spectrum:
        if odd_length:
            log_mag = jnp.concatenate(
                [log_mag, jnp.flip(log_mag[1:], axis=0)], axis=0
            )
        else:
            log_mag = jnp.concatenate(
                [log_mag, jnp.flip(log_mag[1:-1], axis=0)], axis=0
            )
    min_phase = -jnp.imag(analytic_signal(log_mag, axis=0))[:original_length]
    return min_phase if unwrapped else wrap_phase(min_phase)


def center_frequencies_fractional_octaves_iec(num_fractions: int):
    """IEC 61260:1:2014 nominal + exact center frequencies (static,
    `_standard_backend.py:124-223`; pyfar formulas)."""
    if num_fractions == 1:
        nominal = np.array(
            [31.5, 63, 125, 250, 500, 1e3, 2e3, 4e3, 8e3, 16e3], dtype=float
        )
    elif num_fractions == 3:
        nominal = np.array(
            [25, 31.5, 40, 50, 63, 80, 100, 125, 160, 200, 250, 315, 400,
             500, 630, 800, 1000, 1250, 1600, 2000, 2500, 3150, 4000, 5000,
             6300, 8000, 10000, 12500, 16000, 20000],
            dtype=float,
        )
    else:
        raise ValueError("Nominal frequencies only for fractions 1 and 3")
    reference_freq = 1e3
    octave_ratio = 10 ** (3 / 10)
    if num_fractions % 2 != 0:
        indices = np.around(
            num_fractions
            * np.log(nominal / reference_freq)
            / np.log(octave_ratio)
        )
        exponent = indices / num_fractions
    else:
        indices = (
            np.around(
                2.0
                * num_fractions
                * np.log(nominal / reference_freq)
                / np.log(octave_ratio)
                - 1
            )
            / 2
        )
        exponent = (2 * indices + 1) / num_fractions / 2
    exact = reference_freq * octave_ratio**exponent
    return nominal, exact


def exact_center_frequencies_fractional_octaves(
    num_fractions: int, frequency_range
) -> np.ndarray:
    """Center frequencies of arbitrary fractional octave bands (static,
    `_standard_backend.py:226-257`)."""
    ref_freq = 1e3
    Nmax = np.around(num_fractions * np.log2(frequency_range[1] / ref_freq))
    Nmin = np.around(num_fractions * np.log2(ref_freq / frequency_range[0]))
    indices = np.arange(-Nmin, Nmax + 1)
    return ref_freq * 2 ** (indices / num_fractions)


def kaiser_window_beta(A: float) -> float:
    """Kaiser beta from desired side-lobe suppression
    (`_standard_backend.py:259-287`)."""
    A = abs(A)
    if A > 50:
        return 0.1102 * (A - 8.7)
    if A >= 21:
        return 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21)
    return 0.0


def kaiser_window_fractional(
    length: int, side_lobe_suppression_db: float, fractional_delay: float
) -> np.ndarray:
    """Kaiser window with fractional offset (static design,
    `_standard_backend.py:289-323`)."""
    filter_order = length - 1
    alpha = filter_order / 2
    beta = kaiser_window_beta(abs(side_lobe_suppression_db))
    L = np.arange(length).astype(float) - fractional_delay
    if filter_order % 2:
        L += 0.5
    elif fractional_delay > 0.5:
        L += 1
    Z = beta * np.sqrt(
        np.array(1 - ((L - alpha) / alpha) ** 2, dtype="complex")
    )
    return np.real(bessel_first_mod(0, Z)) / bessel_first_mod(0, beta)


def fractional_delay_filter(
    delay_samples: float,
    filter_order: int,
    side_lobe_suppression_db: float,
) -> tuple[int, np.ndarray]:
    """Kaiser-windowed-sinc fractional delay FIR (static design; pyfar/Laakso
    method, `_standard_backend.py:430-493`). Returns (integer delay, fir)."""
    delay_int = int(delay_samples)
    delay_frac = delay_samples - delay_int
    if filter_order % 2:
        M_opt = int(delay_frac) - (filter_order - 1) / 2
    else:
        M_opt = np.round(delay_frac) - filter_order / 2
    n = np.arange(filter_order + 1) + M_opt - delay_frac
    sinc = np.sinc(n)
    kaiser = kaiser_window_fractional(
        filter_order + 1, side_lobe_suppression_db, delay_frac
    )
    return int(delay_int + M_opt), sinc * kaiser


def fractional_delay_filter_batch(
    delay_samples: np.ndarray,
    filter_order: int,
    side_lobe_suppression_db: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized `fractional_delay_filter` over a vector of D delays:
    returns ``(integer delays (D,) int, firs (D, order+1))`` — the same
    Kaiser-sinc design (`_standard_backend.py:430-493`) built with one
    numpy program instead of D scalar calls. Feeds the batched
    delay-and-sum / monopole-projection kernels in `beamforming`."""
    d = np.asarray(delay_samples, np.float64).reshape(-1)
    delay_int = d.astype(np.int64)
    delay_frac = d - delay_int
    length = filter_order + 1
    if filter_order % 2:
        M_opt = delay_frac.astype(np.int64) - (filter_order - 1) / 2
    else:
        M_opt = np.round(delay_frac) - filter_order / 2
    n = np.arange(length)[None, :] + M_opt[:, None] - delay_frac[:, None]
    sinc = np.sinc(n)
    # fractional Kaiser window (kaiser_window_fractional, vectorized)
    alpha = filter_order / 2
    beta = kaiser_window_beta(abs(side_lobe_suppression_db))
    L = np.arange(length, dtype=np.float64)[None, :] - delay_frac[:, None]
    if filter_order % 2:
        L = L + 0.5
    else:
        L = L + (delay_frac > 0.5)[:, None].astype(np.float64)
    Z = beta * np.sqrt(
        np.asarray(1 - ((L - alpha) / alpha) ** 2, dtype=complex)
    )
    kaiser = np.real(bessel_first_mod(0, Z)) / bessel_first_mod(0, beta)
    return (delay_int + M_opt).astype(np.int64), sinc * kaiser


def indices_above_threshold_dbfs(
    time_vec: jnp.ndarray,
    threshold_dbfs: float,
    attack_smoothing_coeff: float,
    release_smoothing_coeff: float,
    normalize: bool = True,
):
    """Boolean activity mask from a smoothed power envelope, reproducing the
    reference recursion exactly (`_standard_backend.py:324-380`, including
    its comparison of the yet-unwritten gain sample). ``time_vec (T,)``.

    Runs as ONE cached jitted program: eagerly, the log-depth scan and its
    surrounding ops would each be a separate dispatch.
    """
    from ..classes.signal import _dev_jit

    return _dev_jit(
        (
            "activity_mask",
            float(threshold_dbfs),
            float(attack_smoothing_coeff),
            float(release_smoothing_coeff),
            bool(normalize),
        ),
        lambda tv: _indices_above_threshold_core(
            tv,
            threshold_dbfs,
            attack_smoothing_coeff,
            release_smoothing_coeff,
            normalize,
        ),
    )(jnp.asarray(time_vec))


def indices_above_threshold_dbfs_packed(
    time_vec: jnp.ndarray,
    threshold_dbfs: float,
    attack_smoothing_coeff: float,
    release_smoothing_coeff: float,
    normalize: bool = True,
):
    """Same mask as `indices_above_threshold_dbfs` but bit-packed on the
    device into uint8 (np.unpackbits layout, big-endian bit order): the
    host fetch shrinks 8x. Unpack with
    ``np.unpackbits(np.asarray(out))[:T].astype(bool)``."""
    from ..classes.signal import _dev_jit

    def _packed(tv):
        mask = _indices_above_threshold_core(
            tv,
            threshold_dbfs,
            attack_smoothing_coeff,
            release_smoothing_coeff,
            normalize,
        )
        T = mask.shape[0]
        pad = (-T) % 8
        bits = jnp.concatenate(
            [mask.astype(jnp.uint8), jnp.zeros(pad, jnp.uint8)]
        ).reshape(-1, 8)
        weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
        return (bits * weights).sum(axis=1, dtype=jnp.uint8)

    return _dev_jit(
        (
            "activity_mask_packed",
            float(threshold_dbfs),
            float(attack_smoothing_coeff),
            float(release_smoothing_coeff),
            bool(normalize),
        ),
        _packed,
    )(jnp.asarray(time_vec))


def _indices_above_threshold_core(
    time_vec: jnp.ndarray,
    threshold_dbfs: float,
    attack_smoothing_coeff: float,
    release_smoothing_coeff: float,
    normalize: bool,
):
    import jax

    x = jnp.asarray(time_vec).reshape(-1)
    if normalize:
        x = x / jnp.max(jnp.abs(x))
    power = x**2

    # parity: the reference compares momentary_gain[i] (still zero when
    # read) with time_power[i-1], so the attack branch never fires and the
    # coefficient is the release one unless the previous power is exactly
    # 0. The coefficient therefore depends only on the PREVIOUS INPUT
    # power — not on the carry — so the recursion
    #   g[i] = c[i]·p[i] + (1-c[i])·g[i-1]
    # is a first-order linear recurrence with known time-varying
    # coefficients: composed affine maps (A, B) ∘ (A', B') =
    # (A·A', A·B' + B) under `associative_scan` run in log depth instead
    # of a 190k-step sequential scan.
    p_prev, p_cur = power[:-1], power[1:]
    coeff = jnp.where(
        0.0 > p_prev,
        attack_smoothing_coeff,
        jnp.where(0.0 < p_prev, release_smoothing_coeff, 0.0),
    ).astype(x.dtype)
    A = 1.0 - coeff
    B = coeff * p_cur

    def compose(left, right):
        a1, b1 = left
        a2, b2 = right
        return a2 * a1, a2 * b1 + b2

    _, gains = jax.lax.associative_scan(compose, (A, B))
    # initial carry is 0, so g[i] = (prefix A)·0 + (prefix B) = prefix B
    momentary_gain = jnp.concatenate([jnp.zeros(1, x.dtype), gains])
    momentary_db = 10.0 * jnp.log10(momentary_gain)
    return momentary_db > threshold_dbfs
