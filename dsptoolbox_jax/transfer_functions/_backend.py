"""Array-level backend for transfer-function measurement.

Behavioral reference: `dsptoolbox/transfer_functions/_transfer_functions.py`.
Device replacements for the reference's three numba kernels:

- complex smoothing (`:414-476`): the per-bin variable-width log window is a
  *static* banded linear operator given (F, octave_fraction, window) — built
  host-side once, applied as a single (F×F)·(F×C) matmul (long spectra:
  the banded O(F·W) form).
- frequency-dependent windowing (`:478-504`): per-frequency Gaussian-windowed
  DFT sums become a chunked einsum over (frequency, time, channel) tiles.
- spectral deconvolution: batched regularized division + irfft.

The data-dependent trimming heuristics (`:285-411`) stay host-side: they are
scalar decision logic over tiny envelopes, not bulk compute (scipy hilbert +
EMA on the host — device round trips cost more than the math).
"""

from __future__ import annotations

from functools import lru_cache
from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np

from ..helpers.other import pearson_correlation
from ..helpers.gain_and_level import to_db
from ..helpers.other import find_nearest_points_index_in_vector
from ..helpers.windows_extra import calculate_tukey_like_window
from ..ops.pad_trim import pad_trim_axis
from ..standard.enums import Window


def spectral_deconvolve_core(
    num_fft: jnp.ndarray,
    denum_fft: jnp.ndarray,
    time_signal_length: int,
    eps: np.ndarray | None,
) -> jnp.ndarray:
    """Batched regularized spectral division → irfft.

    ``num_fft``/``denum_fft`` shaped ``(F, C)``; ``eps`` is the static
    regularization profile (already scaled), shaped ``(F, C)`` or ``(F, 1)``
    broadcasting over channels, or None for plain division.
    Mirrors `_transfer_functions.py:19-43`.
    """
    if eps is not None:
        denum_reg = jnp.conj(denum_fft) / (
            jnp.abs(denum_fft) ** 2 + jnp.asarray(eps, num_fft.real.dtype)
        )
        product = num_fft * denum_reg
    else:
        product = num_fft / denum_fft
    return jnp.fft.irfft(product, n=time_signal_length, axis=0)


def regularization_window(
    start_stop_hz, freqs_hz: np.ndarray, window_type=Window.Hann
) -> np.ndarray:
    """Inverse Tukey-like window scaled by +30 dB — the regularization
    spectrum of the reference (`_transfer_functions.py:30-36`)."""
    ids = find_nearest_points_index_in_vector(start_stop_hz, freqs_hz)
    return calculate_tukey_like_window(
        ids, len(freqs_hz), window_type, True, inverse=True
    ) * 10 ** (30 / 20)


def regularization_window_traced(
    first, last, n_freqs: int, f0: float, df: float, nyquist_hz: float
):
    """In-trace twin of :func:`regularization_window` for the AUTOMATIC
    range (Hann flanks, the only window the auto path uses): from the
    traced first/last-above-threshold bins to the scaled inverse window,
    everything runs in-program so `spectral_deconvolve` stays traceable
    under `dsp.pipeline`. The Hann half-flanks are written analytically
    (``sin²``/``cos²`` of the periodic window the host builds via scipy);
    ±1-bin flank placement vs the f64 host build is possible from f32
    grid arithmetic."""
    from .._config import default_float

    dt = default_float()
    freqs = (f0 + jnp.arange(n_freqs) * df).astype(dt)
    fl = (f0 + first * df).astype(dt)
    fh = (f0 + last * df).astype(dt)
    targets = jnp.stack(
        [
            fl / np.sqrt(2.0),
            fl,
            fh,
            jnp.minimum(fh * np.sqrt(2.0), nyquist_hz),
        ]
    )
    ids = jnp.argmin(
        jnp.abs(freqs[None, :] - targets[:, None]), axis=1
    )
    i0, i1, i2, i3 = ids[0], ids[1], ids[2], ids[3]
    n = jnp.arange(n_freqs)
    len_low = jnp.maximum(i1 - i0, 1)
    len_high = jnp.maximum(i3 - i2, 1)
    low = (
        jnp.sin(jnp.pi * (n - i0).astype(dt) / (2.0 * len_low.astype(dt)))
        ** 2
    )
    low = jnp.where(i1 - i0 > 0, low, 1.0)
    high = (
        jnp.cos(jnp.pi * (n - i2).astype(dt) / (2.0 * len_high.astype(dt)))
        ** 2
    )
    high = jnp.where(i3 - i2 > 1, high, 1.0)
    w = jnp.where(
        n < i0,
        0.0,
        jnp.where(
            n < i1,
            low,
            jnp.where(n < i2, 1.0, jnp.where(n < i3, high, 0.0)),
        ),
    )
    eps = (1.0 - w) * np.float64(10.0 ** (30.0 / 20.0))
    return eps.astype(dt)[:, None]


@lru_cache(maxsize=32)
def regularization_window_device(
    ssz_t: tuple, n_freqs: int, f0: float, df: float
) -> jnp.ndarray:
    """Cached device-resident regularization column ``(F, 1)``.

    The host window build (scipy window + nearest-index search over the
    full rfft grid + repeat) costs ~5 ms per deconvolution and is fully
    determined by ``(ssz, F, f0, df)``; as a cached jnp array the captured
    value is also identity-memoized by the jit-closure freezer instead of
    content-hashed on every call.
    """
    from .._config import default_float

    freqs = f0 + np.arange(n_freqs) * df
    eps_col = regularization_window(np.asarray(ssz_t), freqs)
    return jnp.asarray(eps_col[:, None], default_float())


def window_this_ir_tukey_meta(
    signal_length: int,
    impulse_index: int,
    total_length: int,
    window_type,
    constant_percentage: float,
    at_start: bool,
    offset_samples: int,
    left_to_right_flank_ratio: float,
    adaptive_window: bool,
):
    """Index-space form of the peak-aligned adaptive Tukey windowing
    (`_transfer_functions.py:45-148`): everything the reference's
    data-dependent trimming decides is a function of only the channel
    length and its peak position, so the bulk data can stay on device.

    Returns ``(slice_start, window, start_sample)`` such that the windowed
    channel equals ``window * zext(vec)[slice_start : slice_start +
    total_length]`` where ``zext`` reads out-of-range samples as zeros
    (``slice_start`` may be negative).
    """
    start_sample = 0
    flank_length_total = int((1 - constant_percentage) * total_length)
    left_flank_length = int(
        flank_length_total * 0.5 * left_to_right_flank_ratio
    )
    right_flank_length = max(flank_length_total - left_flank_length, 0)
    impulse_index = int(impulse_index)
    T = int(signal_length)
    # `front` = zeros the reference prepends to the working vector;
    # `drop` = samples it slices off the front of that padded vector
    front = 0
    drop = 0

    if not adaptive_window:
        padding_left = 0
        if impulse_index - offset_samples < 0:
            pad_length = -int(impulse_index - offset_samples)
            front += pad_length
            impulse_index += pad_length
            start_sample += pad_length
            padding_left += pad_length
        else:
            impulse_index -= offset_samples
        if impulse_index - left_flank_length < 0:
            pad_length = int(-(impulse_index - left_flank_length))
            front += pad_length
            start_sample += pad_length
            padding_left += pad_length
        else:
            drop = impulse_index - left_flank_length
            start_sample = impulse_index - left_flank_length
            impulse_index = left_flank_length
        current_length = front + T - drop
        padding_right = max(0, total_length - current_length)
        points = [
            0,
            left_flank_length,
            total_length - right_flank_length,
            total_length,
        ]
        assert not np.any(np.ediff1d(points) < 0), (
            "A valid window could not be constructed with given parameters."
        )
        window = calculate_tukey_like_window(
            points, total_length, window_type, at_start=at_start,
            inverse=False,
        )
        window[:padding_left] = 0
        if padding_right != 0:
            window[-padding_right:] = 0
        return drop - front, window, start_sample

    # adaptive path
    if impulse_index - offset_samples - left_flank_length < 0:
        left_flank_length = max(0, impulse_index - offset_samples)
    else:
        start_sample = impulse_index - offset_samples - left_flank_length
        drop = start_sample
    current_length = min(T - drop, total_length)
    padding_after_adaptation = 0
    effective_length = total_length
    if current_length < total_length:
        padding_after_adaptation = total_length - current_length
        effective_length = current_length
    if (
        left_flank_length + offset_samples
        > effective_length - right_flank_length
    ):
        right_flank_length = (
            effective_length - left_flank_length - offset_samples - 1
        )
    points = [
        0,
        left_flank_length,
        effective_length - right_flank_length,
        effective_length,
    ]
    assert not np.any(np.ediff1d(points) < 0), (
        "A valid window could not be constructed with given parameters."
    )
    window = calculate_tukey_like_window(
        points, effective_length, window_type, at_start=at_start,
        inverse=False,
    )
    window = np.pad(window, ((0, padding_after_adaptation)))
    return drop, window, start_sample


def window_ir_fused_program(
    total_length: int,
    adaptive_window: bool,
    constant_percentage: float,
    at_start: bool,
    offset_samples: int,
    left_to_right_flank_ratio: float,
):
    """Fully in-graph `window_ir` for closed-form (Hann) flanks.

    The reference's adaptive trimming (`_transfer_functions.py:45-148`)
    is scalar index arithmetic on the channel peak position — the peak
    search, the trimming decisions, the flank construction and the
    windowed gather all run as ONE program with zero host syncs.

    Returns ``fn(td (T, C)) -> (out (TL, C), window (TL, C),
    start_positions (C,))``. Degenerate flank configurations that the
    host path rejects with an assertion are clamped to the nearest valid
    window instead (documented in `docs/parity_notes.md`).
    """
    TL = int(total_length)
    o = int(offset_samples)
    flank_total = int((1 - constant_percentage) * TL)
    Lf0 = int(flank_total * 0.5 * left_to_right_flank_ratio)
    Rf0 = max(flank_total - Lf0, 0)
    if not adaptive_window:
        points = [0, Lf0, TL - Rf0, TL]
        assert not np.any(np.ediff1d(points) < 0), (
            "A valid window could not be constructed with given parameters."
        )

    def fn(td):
        T = td.shape[0]
        p = jnp.argmax(jnp.abs(td), axis=0)  # (C,)

        def meta(p):
            if adaptive_window:
                cond = (p - o - Lf0) < 0
                Lf = jnp.where(cond, jnp.maximum(0, p - o), Lf0)
                drop = jnp.where(cond, 0, p - o - Lf0)
                start_sample = drop
                eff = jnp.minimum(T - drop, TL)
                overlap = (Lf + o) > (eff - Rf0)
                Rf = jnp.where(overlap, eff - Lf - o - 1, Rf0)
                Rf = jnp.clip(Rf, 0, None)
                Lf = jnp.minimum(Lf, eff - Rf)
                return drop, start_sample, Lf, Rf, eff, 0, eff
            c1 = (p - o) < 0
            pad1 = jnp.where(c1, o - p, 0)
            p1 = jnp.where(c1, p + pad1, p - o)
            c2 = (p1 - Lf0) < 0
            pad2 = jnp.where(c2, Lf0 - p1, 0)
            drop = jnp.where(c2, 0, p1 - Lf0)
            start_sample = jnp.where(c2, pad1 + pad2, p1 - Lf0)
            front = pad1 + pad2
            padding_right = jnp.maximum(0, TL - (front + T - drop))
            return (
                drop - front,
                start_sample,
                Lf0,
                Rf0,
                TL,
                front,
                TL - padding_right,
            )

        def one(col, p):
            slice_start, start_sample, Lf, Rf, eff, z_to, z_from = meta(p)
            # the non-adaptive branch yields static python ints
            Lf, Rf, eff = (jnp.asarray(v) for v in (Lf, Rf, eff))
            i = jax.lax.broadcasted_iota(jnp.int32, (TL, 1), 0)[:, 0]
            x = i.astype(td.dtype)
            # periodic Hann flanks — identical to
            # scipy get_window('hann', 2L, fftbins=True) split at L
            low = 0.5 - 0.5 * jnp.cos(
                jnp.pi * x / jnp.maximum(Lf, 1).astype(td.dtype)
            )
            high = 0.5 + 0.5 * jnp.cos(
                jnp.pi
                * (x - (eff - Rf).astype(td.dtype))
                / jnp.maximum(Rf, 1).astype(td.dtype)
            )
            w = jnp.where(i < Lf, low if at_start else 1.0, 1.0)
            w = jnp.where(
                i >= eff - Rf, jnp.where(i < eff, high, 0.0), w
            )
            w = jnp.where(i < z_to, 0.0, w)
            w = jnp.where(i >= z_from, 0.0, w)
            padded = jnp.pad(col, (2 * TL, 2 * TL))
            seg = jax.lax.dynamic_slice(padded, (slice_start + 2 * TL,), (TL,))
            return seg * w, w, start_sample

        out, win, starts = jax.vmap(one, in_axes=(1, 0), out_axes=(1, 1, 0))(
            td, p
        )
        return out, win, starts

    return fn


def window_this_ir_tukey(
    vec: np.ndarray,
    total_length: int,
    window_type,
    constant_percentage: float,
    at_start: bool,
    offset_samples: int,
    left_to_right_flank_ratio: float,
    adaptive_window: bool,
):
    """Peak-aligned adaptive Tukey windowing of one channel (host-side
    data-dependent trimming; `_transfer_functions.py:45-148`)."""
    T = len(vec)
    slice_start, window, start_sample = window_this_ir_tukey_meta(
        T,
        int(np.argmax(np.abs(vec))),
        total_length,
        window_type,
        constant_percentage,
        at_start,
        offset_samples,
        left_to_right_flank_ratio,
        adaptive_window,
    )
    idx = np.arange(total_length) + slice_start
    valid = (idx >= 0) & (idx < T)
    seg = np.where(valid, vec[np.clip(idx, 0, T - 1)], 0.0)
    return seg * window, window, start_sample


def window_this_ir_centered_meta(
    T: int, peak_ind: int, total_length: int, window_type
):
    """Index arithmetic for peak-centered windowing of one length-``T``
    channel (`_transfer_functions.py:150-215`). Pure metadata twin of the
    reference's per-channel routine: returns ``(flip, start, win_col)``
    such that the windowed channel equals
    ``(vec[::-1] if flip else vec)[start : start + total_length] *
    win_col`` (zero-padded out of range), flipped back afterwards — which
    a batched device kernel applies for all channels at once. ``win_col``
    is zero wherever the reference's pad/trim would have written zeros, so
    out-of-slice data values cannot leak through."""
    from scipy.signal import get_window

    half_length = total_length // 2
    centered_even = peak_ind + half_length == T and T % 2 == 0
    flipping = peak_ind > half_length
    if flipping:
        peak_ind = T - peak_ind - 1
    w = get_window(window_type.to_scipy_format(), half_length * 2 + 1, False)
    if peak_ind - half_length < 0:
        ind_low_td = 0
        ind_low_w = half_length - peak_ind
    else:
        ind_low_td = peak_ind - half_length
        ind_low_w = 0
    # the reference zero-pads the channel to total_length + ind_low_td
    # when the window would run past the end
    T_eff = (
        total_length + ind_low_td if total_length - ind_low_td > T else T
    )
    if peak_ind + half_length + 1 > T_eff and not centered_even:
        ind_up_td = T_eff
        ind_up_w = peak_ind + half_length + 1 - T_eff
    else:
        ind_up_td = peak_ind + half_length + 1
        ind_up_w = len(w) - (1 if centered_even else 0)
    w = w[ind_low_w:ind_up_w]
    # length the reference's clamped slice-multiply produces before its
    # final pad/trim to total_length
    L0 = max(0, min(ind_up_td, T_eff) - ind_low_td)
    win_col = np.zeros(total_length)
    L = min(len(w), L0, total_length)
    win_col[:L] = w[:L]
    return flipping, ind_low_td, win_col


def get_chirp_rate(range_hz, length_seconds: float) -> float:
    """Chirp rate in octaves/second (`_transfer_functions.py:216-237`)."""
    r = np.sort(np.atleast_1d(range_hz))
    assert r.shape == (2,), "Range must contain exactly two elements."
    return np.log2(r[1] / r[0]) / length_seconds


def get_harmonic_times(
    chirp_range_hz,
    chirp_length_s: float,
    n_harmonics: int,
    time_offset_seconds: float = 0.0,
) -> np.ndarray:
    """Relative (negative) times of harmonic IRs in an exponential-chirp
    measurement (`_transfer_functions.py:239-275`)."""
    rate = get_chirp_rate(chirp_range_hz, chirp_length_s)
    return time_offset_seconds - np.log2(np.arange(n_harmonics) + 2) / rate


def _smoothing_row_window(
    i: int,
    frequency_vector: np.ndarray,
    delta_f: float,
    factor: float,
    window_x: np.ndarray,
    window_y: np.ndarray,
):
    """Per-bin log-spaced smoothing window of the reference's numba kernel
    (`_transfer_functions.py:414-476`): returns
    ``(w, ind_low_clipped, ind_high_clipped)`` or ``None`` when the row is
    too narrow (< 3 bins → identity). Shared by the dense-operator and
    host streaming paths so they stay bit-identical."""
    n_bins = len(frequency_vector)
    f0 = frequency_vector[i]
    ind_low = i - int((f0 - f0 / factor) / delta_f + 0.5)
    ind_high = i + int((f0 * factor - f0) / delta_f + 0.5) + 1
    window_length = ind_high - ind_low
    ind_low_c = max(ind_low, 0)
    ind_high_c = min(ind_high, n_bins)
    effective = ind_high_c - ind_low_c
    if ind_low_c + 2 >= ind_high_c:
        return None
    w = np.interp(
        np.logspace(np.log10(3.0), np.log10(1.0), window_length)[
            :effective
        ]
        - 2.0,
        window_x,
        window_y,
    )
    return w / w.sum(), ind_low_c, ind_high_c


@lru_cache(maxsize=16)
def _complex_smoothing_operator(
    freqs_key: tuple, octave_fraction: float, window_key: tuple
) -> np.ndarray:
    """Static banded smoothing operator W (F, F) of the reference's numba
    kernel (`_transfer_functions.py:414-476`): per-bin log-spaced window,
    row-normalized. Rows too narrow (< 3 bins) are identity."""
    frequency_vector = np.asarray(freqs_key, dtype=np.float64)
    n_bins = len(frequency_vector)
    delta_f = frequency_vector[1] - frequency_vector[0]
    window_y = np.asarray(window_key, dtype=np.float64)
    window_x = np.linspace(-1.0, 1.0, len(window_y))
    factor = 2.0 ** (1.0 / octave_fraction / 2.0)
    W = np.zeros((n_bins, n_bins))
    for i in range(n_bins):
        row = _smoothing_row_window(
            i, frequency_vector, delta_f, factor, window_x, window_y
        )
        if row is None:
            W[i, i] = 1.0
            continue
        w, ind_low_c, ind_high_c = row
        W[i, ind_low_c:ind_high_c] = w
    return W


_BANDED_TR = 128  # rows per banded-kernel tile


@lru_cache(maxsize=8)
def _banded_smoothing_plan(
    n_bins: int,
    f_first: float,
    delta_f: float,
    octave_fraction: float,
    window_key: tuple,
):
    """Segmented banded form of the smoothing operator: O(F·W) memory.

    Same math as `_smoothing_row_window` / `_complex_smoothing_operator`,
    built fully vectorized. Rows are tiled in blocks of ``_BANDED_TR``;
    each block stores a dense ``(TR, SPAN)`` weight slab plus the global
    column offset of its band start. Blocks are grouped into segments
    with geometrically growing SPAN (band width grows ∝ frequency), so
    total memory ≈ 1.3× the true band area instead of SPAN_max·F.

    Returns a list of ``{rows, offsets (NB,), slab (NB, TR, SPAN)}``.
    """
    F = int(n_bins)
    freqs = f_first + np.arange(F, dtype=np.float64) * delta_f
    window_y = np.asarray(window_key, dtype=np.float64)
    n_lut = len(window_y)
    factor = 2.0 ** (1.0 / octave_fraction / 2.0)
    i = np.arange(F, dtype=np.int64)
    ind_low = i - np.trunc(
        (freqs - freqs / factor) / delta_f + 0.5
    ).astype(np.int64)
    ind_high = (
        i
        + np.trunc((freqs * factor - freqs) / delta_f + 0.5).astype(
            np.int64
        )
        + 1
    )
    eff_high = np.minimum(ind_high, F)
    width = ind_high - ind_low
    identity = (ind_low + 2) >= eff_high

    # segment row ranges: geometric so per-segment SPAN tracks the local
    # band width (a single global SPAN would cost SPAN_max·F memory)
    bounds = [0]
    nxt = 2048
    while nxt < F:
        bounds.append(nxt)
        nxt *= 2
    bounds.append(F)

    a_log = np.log10(3.0)
    lut_dx = 2.0 / (n_lut - 1)
    segments = []
    TR = _BANDED_TR
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        rows = s1 - s0
        nb = -(-rows // TR)
        rows_padded = nb * TR
        r_idx = s0 + np.arange(rows_padded)
        valid_row = r_idx < F
        r_clip = np.minimum(r_idx, F - 1)
        il = ind_low[r_clip]
        eh = eff_high[r_clip]
        wd = width[r_clip]
        ident = identity[r_clip] | (~valid_row)
        base = il.reshape(nb, TR).min(axis=1)  # (NB,)
        span_raw = int(
            (eh.reshape(nb, TR).max(axis=1) - base).max()
        )
        span = max(128, -(-span_raw // 128) * 128)
        k = np.arange(span, dtype=np.int64)
        base_r = np.repeat(base, TR)  # (rows_padded,)
        slab = np.empty((rows_padded, span), np.float32)
        # in row chunks: the f64 temporaries of a whole segment would take
        # tens of GB at 65537 bins
        chunk = TR * max(1, (1 << 24) // (TR * span))
        for c0 in range(0, rows_padded, chunk):
            c = slice(c0, c0 + chunk)
            col = base_r[c, None] + k[None, :]  # global column index
            krel = col - il[c, None]
            in_band = (krel >= 0) & (col < eh[c, None]) & (
                krel < wd[c, None]
            )
            wm1 = np.where(wd[c] > 1, wd[c] - 1, 1).astype(np.float64)
            # np.logspace(log10 3, 0, width)[krel] − 2, vectorized with the
            # same start + k·step evaluation order as np.linspace
            step = -a_log / wm1
            val = a_log + krel * step[:, None]
            pos = np.clip(10.0**val - 2.0, -1.0, 1.0)
            u = (pos + 1.0) / lut_dx
            iu = np.clip(np.floor(u).astype(np.int64), 0, n_lut - 2)
            frac = u - iu
            w = window_y[iu] * (1.0 - frac) + window_y[iu + 1] * frac
            w = np.where(in_band, w, 0.0)
            norm = w.sum(axis=1, keepdims=True)
            w = w / np.where(norm == 0.0, 1.0, norm)
            # identity rows (too-narrow bands): one-hot at the row's own bin
            ident_c = ident[c]
            w[ident_c] = 0.0
            w[ident_c, (r_clip[c] - base_r[c])[ident_c]] = 1.0
            slab[c] = w
        segments.append(
            {
                "rows": rows,
                "offsets": base.astype(np.int32),
                "slab": slab.reshape(nb, TR, span),
            }
        )
    return segments


def banded_matmul_xla(
    slab: jnp.ndarray, offsets: jnp.ndarray, x_padded: jnp.ndarray
) -> jnp.ndarray:
    """Row-banded operator product ``out[r] = W[r] @ x[off_r : off_r +
    SPAN]``: rows are processed in tiles whose weight block ``slab[b]
    (TR, SPAN)`` starts at input row ``offsets[b]``. One gather of every
    tile's input window plus one batched matmul, O(F·W) like the banded
    operator itself. ``slab (NB, TR, SPAN)``, ``x_padded (F + SPAN, C)``
    -> ``(NB * TR, C)``."""
    nb, tr, span = slab.shape
    idx = jnp.asarray(offsets, jnp.int32)[:, None] + jnp.arange(
        span, dtype=jnp.int32
    )
    xg = jnp.take(x_padded, idx, axis=0)  # (NB, SPAN, C)
    out = jnp.einsum(
        "btw,bwc->btc",
        slab,
        xg,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(nb * tr, x_padded.shape[1])


def _plan_key(frequency_vector, octave_fraction, window_y) -> tuple:
    fv = np.asarray(frequency_vector, dtype=np.float64)
    return (
        len(fv),
        float(fv[0]),
        float(fv[1] - fv[0]),
        float(octave_fraction),
        tuple(np.asarray(window_y).tolist()),
    )


@lru_cache(maxsize=2)
def _banded_operands(plan_key: tuple) -> tuple:
    plan = _banded_smoothing_plan(*plan_key)
    return tuple(
        jnp.asarray(a) for s in plan for a in (s["offsets"], s["slab"])
    )


def banded_smoothing_operands(
    frequency_vector: np.ndarray, octave_fraction: float, window_y
) -> tuple:
    """Device-resident ``(offsets, slab)`` arrays of every segment of the
    banded plan, flattened, for `complex_smoothing_banded(operands=...)`.

    Pass them to the jitted program as arguments: captured as constants
    they are compiled into the executable, which at 65537 bins of 1/3
    octave holds 2.4 GB of weights and takes tens of seconds to build."""
    return _banded_operands(
        _plan_key(frequency_vector, octave_fraction, window_y)
    )


def complex_smoothing_banded(
    spectrum: jnp.ndarray,
    frequency_vector: np.ndarray,
    octave_fraction: float,
    window_y: np.ndarray,
    operands: tuple | None = None,
) -> jnp.ndarray:
    """O(F·W) banded smoothing on device (`banded_matmul_xla`). Replaces
    both the dense operator for long spectra and the former host
    fallback. ``operands`` are the plan's arrays from
    `banded_smoothing_operands` (looked up here when None)."""
    key = _plan_key(frequency_vector, octave_fraction, window_y)
    plan = _banded_smoothing_plan(*key)
    if operands is None:
        operands = _banded_operands(key)
    one_d = spectrum.ndim == 1
    x = spectrum[:, None] if one_d else spectrum
    is_c = jnp.iscomplexobj(x)
    planes = (
        jnp.concatenate([x.real, x.imag], axis=1) if is_c else x
    ).astype(jnp.float32)
    max_span = max(s["slab"].shape[2] for s in plan)
    F, C = planes.shape
    x_padded = jnp.pad(planes, ((0, max_span), (0, 0)))
    outs = [
        banded_matmul_xla(slab, offsets, x_padded)[: s["rows"]]
        for s, offsets, slab in zip(plan, operands[::2], operands[1::2])
    ]
    out = jnp.concatenate(outs, axis=0)
    if is_c:
        out = out[:, : C // 2] + 1j * out[:, C // 2 :]
    out = out.astype(spectrum.dtype)
    return out[:, 0] if one_d else out


DENSE_SMOOTHING_MAX_BINS = 4096


def complex_smoothing_core(
    spectrum: jnp.ndarray,
    frequency_vector: np.ndarray,
    octave_fraction: float,
    window_y: np.ndarray,
    operands: tuple | None = None,
) -> jnp.ndarray:
    """Smoothing operator on device. Short spectra use one (F×F)@(F,C)
    matmul (dense operator, cached); long spectra use the O(F·W) banded
    path (`complex_smoothing_banded`, which takes ``operands``).
    ``spectrum (F, C)`` complex or real; linear frequency grid."""
    if len(frequency_vector) > DENSE_SMOOTHING_MAX_BINS:
        return complex_smoothing_banded(
            spectrum, frequency_vector, octave_fraction, window_y, operands
        )
    W = _complex_smoothing_operator(
        tuple(np.asarray(frequency_vector, dtype=np.float64).tolist()),
        float(octave_fraction),
        tuple(np.asarray(window_y).tolist()),
    )
    Wj = jnp.asarray(W, dtype=spectrum.real.dtype)
    _hi = jax.lax.Precision.HIGHEST  # fp32 products, not TF32/bf16
    if jnp.iscomplexobj(spectrum):
        return (
            jnp.matmul(Wj, spectrum.real, precision=_hi)
            + 1j * jnp.matmul(Wj, spectrum.imag, precision=_hi)
        ).astype(spectrum.dtype)
    return jnp.matmul(Wj, spectrum, precision=_hi)


def fdw_core(
    time_data: jnp.ndarray,
    freqs_normalized: np.ndarray,
    alpha: np.ndarray,
    peak_indices: np.ndarray,
    chunk: int = 128,
) -> jnp.ndarray:
    """Frequency-dependent Gaussian windowing as chunked batched DFT sums.

    ``time_data (T, C)``; returns ``(F, C)`` complex where
    ``spec[f, c] = sum_n exp(-0.5((n-peak_c)/half)^2 · alpha_f) ·
    exp(-2πi f n / T) · x[n, c]``.

    Replaces numba kernel #2 (`_transfer_functions.py:478-504`) with an
    einsum over (freq-chunk, time, channel) tiles.

    The rotation phase ``f·n/T`` reaches ~1e4 cycles for measurement-length
    IRs, beyond fp32 mantissa; the same coarse/fine mod-1 split as
    `transforms._backend.dft_core` keeps phase error at the ~1e-7 level:
    ``n = n1·B + n0``, ``phase = [(ω·B·n1) mod 1] + ω·n0`` with the coarse
    table reduced mod 1 in f64 host-side.
    """
    T, C = time_data.shape
    half = (T - 1) / 2
    n_idx = np.arange(T)[:, None] - np.asarray(peak_indices)[None, :]  # (T, C)
    n2 = -0.5 * (n_idx / half) ** 2  # (T, C) real

    F = len(freqs_normalized)
    pad_f = (-F) % chunk
    fr = np.pad(np.asarray(freqs_normalized, np.float64), (0, pad_f))
    al = np.pad(np.asarray(alpha, np.float64), (0, pad_f))

    B = 1024
    n1_max = (T + B - 1) // B
    omega = np.mod(fr / T, 1.0)  # (F',) f64, exact for integer bins
    coarse = np.mod(
        np.mod(omega * B, 1.0)[:, None] * np.arange(n1_max)[None, :], 1.0
    )  # (F', N1) f64
    coarse_b = coarse.reshape(-1, chunk, n1_max)
    omega_b = omega.reshape(-1, chunk)
    al_b = al.reshape(-1, chunk)

    n_all = np.arange(T)
    n1 = (n_all // B).astype(np.int32)
    n0 = (n_all % B).astype(np.float32)

    td = jnp.asarray(time_data, jnp.complex64)
    n2j = jnp.asarray(n2, jnp.float32)
    n1j = jnp.asarray(n1)
    n0j = jnp.asarray(n0)

    def body(carry, fa):
        coarse_c, omega_c, a_c = fa  # (chunk, N1), (chunk,), (chunk,)
        phase = coarse_c[:, n1j] + omega_c[:, None] * n0j[None, :]  # (chunk,T)
        # (chunk, T, C) window+rotation matrix
        Mat = jnp.exp(
            (-2j * np.pi) * phase.astype(jnp.complex64)[:, :, None]
            + (a_c[:, None, None] * n2j[None, :, :]).astype(jnp.complex64)
        )
        out = jnp.einsum(
            "ftc,tc->fc", Mat, td, precision=jax.lax.Precision.HIGHEST
        )
        return carry, out

    _, chunks = jax.lax.scan(
        body,
        0,
        (
            jnp.asarray(coarse_b, jnp.float32),
            jnp.asarray(omega_b, jnp.float32),
            jnp.asarray(al_b, jnp.float32),
        ),
    )
    spec = chunks.reshape(-1, C)[:F]
    return spec


def trim_ir_indices(
    time_data: np.ndarray,
    fs_hz: int,
    offset_start_s: float,
    safety_distance_to_noise_floor_db: float = 10.0,
) -> tuple[int, int, int]:
    """Start/stop/impulse indices for smart IR trimming
    (`_transfer_functions.py:276-411`). All host-side: 1-D decision logic
    on data that already lives on the host (scipy hilbert + EMA)."""
    time_data = np.asarray(time_data).reshape(-1)
    impulse_index = int(np.argmax(np.abs(time_data)))
    offset_start_samples = int(offset_start_s * fs_hz + 0.5)
    start_index = int(np.max([0, impulse_index - 1 - offset_start_samples]))
    impulse_index -= start_index

    from scipy.fft import next_fast_len

    tail = time_data[start_index + impulse_index :]
    nfl = next_fast_len(len(tail), False)
    # parity: the reference's `hilbert(tail, N=next_fast_len)` keeps the
    # FULL padded length for the decay scan and fallback averaging
    # (`_transfer_functions.py:307-315`) — do not truncate to len(tail).
    # Host scipy throughout: this is 1-D decision logic on data already on
    # the host, so no device round trips (and `scipy.signal.hilbert` IS
    # the reference's own op).
    from scipy.signal import hilbert as _sp_hilbert

    from ..helpers.smoothing import time_smoothing_host

    env_c = _sp_hilbert(tail, N=nfl)
    etc = np.asarray(to_db(np.abs(env_c), True))
    envelope = time_smoothing_host(etc, fs_hz, 20e-3)

    window_lengths = (np.array([10, 30, 50, 70, 90]) * 1e-3 * fs_hz + 0.5).astype(
        int
    )
    end = np.zeros(len(window_lengths))
    x = np.arange(len(envelope))
    corr_coeff = np.zeros(len(window_lengths))
    for ind, wl in enumerate(window_lengths):
        pos = 0
        current_mean = 0.0
        for _ in range(len(envelope) // wl):
            new_mean = np.mean(envelope[pos : pos + wl])
            if current_mean <= new_mean:
                break
            current_mean = new_mean
            pos += wl
        end_cur = min((pos * 2 + wl) // 2, len(envelope))
        corr_coeff[ind] = pearson_correlation(
            x[:end_cur], envelope[:end_cur]
        )
        end[ind] = end_cur

    select = int(np.argmin(corr_coeff))
    if corr_coeff[select] <= -0.95:
        end_point = int(end[select])
    elif np.any(corr_coeff <= -0.9):
        end_point = int(np.mean(end[corr_coeff <= -0.9]))
    elif np.any(corr_coeff <= -0.7):
        inds = corr_coeff <= -0.7
        end_point = int(
            np.mean(np.hstack([np.ones(9) * end[select], end[inds]]))
        )
    else:
        warn("No satisfactory estimation for trimming the rir could be made")
        end_point = int(np.mean(np.hstack([np.ones(5) * len(envelope), end])))

    stop = end_point + start_index + impulse_index
    if safety_distance_to_noise_floor_db != 0.0:
        end_point = _find_index_above_noise_floor(
            envelope[:end_point],
            float(to_db(np.var(time_data[stop:]), False))
            if stop < len(time_data)
            else -np.inf,
            abs(safety_distance_to_noise_floor_db),
        )
        stop = end_point + start_index + impulse_index
    return start_index, stop, impulse_index


def _find_index_above_noise_floor(
    envelope: np.ndarray,
    noise_floor_db: float,
    distance_to_noise_floor_db: float,
) -> int:
    if not np.isfinite(noise_floor_db):
        return len(envelope)
    poly = (
        np.polynomial.Polynomial.fit(np.arange(len(envelope)), envelope, 1)
        .convert()
        .coef
    )
    if poly[1] > 0.0:
        return len(envelope)
    new_stop = int(
        ((noise_floor_db + distance_to_noise_floor_db) - poly[0]) / poly[1]
        + 0.5
    )
    return int(
        np.clip(new_stop, int(len(envelope) * 0.75 + 0.5), len(envelope))
    )


def frequency_vector_with_frequency_resolution(
    delta_f_hz: float, sampling_rate_hz: int
):
    """(f_vec, delta_f, time_length) for a requested frequency resolution.

    Matches `_transfer_functions.py:574-606`: an odd-length linspace whose
    last point is EXACTLY Nyquist — an rfftfreq-based vector can overshoot
    Nyquist by one ulp, which a downstream interpolator with zero-pad edge
    handling turns into a zeroed Nyquist bin (one wrong bin spreads
    ~|H(Nyq)|/F error over the whole irfft)."""
    nyquist_hz = sampling_rate_hz / 2.0
    length_f_vec = int(nyquist_hz / delta_f_hz + 0.5)
    if length_f_vec % 2 == 0:
        length_f_vec += 1
    f_vec = np.linspace(0.0, nyquist_hz, length_f_vec, endpoint=True)
    return f_vec, f_vec[1], (length_f_vec - 1) * 2


def complex_smoothing_host(
    spectrum: np.ndarray,
    frequency_vector: np.ndarray,
    octave_fraction: float,
    window_y: np.ndarray,
) -> np.ndarray:
    """Host-side complex smoothing, numerically identical to the operator
    path (`_complex_smoothing_operator`) but O(F·W) in time and memory.

    Used for long spectra where the dense (F, F) operator would not fit —
    the reference's numba kernel (`_transfer_functions.py:414-476`) has
    the same complexity."""
    x = np.atleast_2d(np.asarray(spectrum))
    transposed = False
    if x.shape[0] == 1 and np.asarray(spectrum).ndim == 1:
        x = x.T
        transposed = True
    frequency_vector = np.asarray(frequency_vector, dtype=np.float64)
    n_bins = len(frequency_vector)
    delta_f = frequency_vector[1] - frequency_vector[0]
    window_y = np.asarray(window_y, dtype=np.float64)
    window_x = np.linspace(-1.0, 1.0, len(window_y))
    factor = 2.0 ** (1.0 / octave_fraction / 2.0)
    out = np.array(x, dtype=np.result_type(x.dtype, np.float64))
    for i in range(n_bins):
        row = _smoothing_row_window(
            i, frequency_vector, delta_f, factor, window_x, window_y
        )
        if row is None:
            continue
        w, ind_low_c, ind_high_c = row
        out[i] = w @ x[ind_low_c:ind_high_c]
    return out[:, 0] if transposed else out
