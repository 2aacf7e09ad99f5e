"""Gain, level, loudness (public API over Signal objects).

Behavioral reference: `dsptoolbox/standard/gain_and_level.py`. LUFS framing
and K-filtering run as the batched framing + blocked-IIR device kernels.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..classes import Filter, FilterBank, MultiBandSignal, Signal
from ..helpers.gain_and_level import fade as _fade
from ..helpers.gain_and_level import from_db, normalize as _normalize, to_db
from ..ops.framing import frame_signal
from ..standard.enums import BiquadEqType, FadeType


def normalize(
    sig,
    norm_dbfs: float,
    peak_normalization: bool = True,
    each_channel: bool = False,
):
    """Peak/RMS normalization (`standard/gain_and_level.py:12-61`)."""
    if isinstance(sig, Signal):
        out = _normalize(
            sig.time_data_jax.T, norm_dbfs, peak_normalization, each_channel
        ).T
        return sig.copy_with_new_time_data(np.asarray(out))
    if isinstance(sig, MultiBandSignal):
        new_sig = sig.copy()
        new_sig.bands = [
            normalize(b, norm_dbfs, peak_normalization, each_channel)
            for b in sig.bands
        ]
        return new_sig
    raise TypeError(
        "Type of signal is not valid. Use either Signal or MultiBandSignal"
    )


def fade(
    sig: Signal,
    fade_type: FadeType,
    length_fade_seconds: float | None = None,
    at_start: bool = True,
    at_end: bool = True,
) -> Signal:
    """Fade in/out (`standard/gain_and_level.py:63-119`)."""
    assert at_start or at_end, (
        "At least start or end of signal should be faded"
    )
    if length_fade_seconds is None:
        length_fade_seconds = sig.time_vector_s[-1] * 0.025
    assert length_fade_seconds < sig.time_vector_s[-1], (
        "Fade length should not be longer than the signal itself"
    )
    td = sig.time_data_jax.T
    if at_start:
        td = _fade(
            td, length_fade_seconds, fade_type, sig.sampling_rate_hz, True
        )
    if at_end:
        td = _fade(
            td, length_fade_seconds, fade_type, sig.sampling_rate_hz, False
        )
    return sig.copy_with_new_time_data(np.asarray(td.T))


def true_peak_level(signal):
    """ITU-R BS.1770-4 true peak via 4× oversampling
    (`standard/gain_and_level.py:121-167`)."""
    from .resampling import resample

    if isinstance(signal, Signal):
        from ..classes.signal import _dev_jit

        sig = signal.copy()
        down_factor = float(from_db(-12.04, True))
        up_factor = 1 / down_factor
        # device multiply (a host round trip of the full signal otherwise)
        sig.time_data = _dev_jit(
            ("tp_scale", down_factor), lambda a: a * down_factor
        )(signal.time_data_jax)
        sig_over = resample(sig, sig.sampling_rate_hz * 4)
        # both reductions in one program, ONE (2, C) host fetch
        both = np.asarray(
            _dev_jit(
                ("tp_levels", up_factor),
                lambda a, b: jnp.stack(
                    [
                        to_db(jnp.max(jnp.abs(a), axis=0) * up_factor, True),
                        to_db(jnp.max(jnp.abs(b), axis=0) * up_factor, True),
                    ]
                ),
            )(sig_over.time_data_jax, sig.time_data_jax)
        )
        return both[0], both[1]
    if isinstance(signal, MultiBandSignal):
        tpl = np.empty((signal.number_of_bands, signal.number_of_channels))
        pl = np.empty_like(tpl)
        for ind, b in enumerate(signal.bands):
            tpl[ind, :], pl[ind, :] = true_peak_level(b)
        return tpl, pl
    raise TypeError(
        "Passed signal must be of type Signal or MultiBandSignal"
    )


def rms(sig, in_dbfs: bool = True) -> np.ndarray:
    """Per-channel (std-)RMS (`standard/gain_and_level.py:169-201`)."""
    if isinstance(sig, Signal):
        vals = np.std(sig.time_data, axis=0)
    elif isinstance(sig, MultiBandSignal):
        vals = np.zeros((sig.number_of_bands, sig.number_of_channels))
        for ind, b in enumerate(sig):
            vals[ind, :] = np.std(b.time_data, axis=0)
    else:
        raise TypeError(
            "Passed signal should be either a Signal or MultiBandSignal type"
        )
    if in_dbfs:
        vals = 20.0 * np.log10(vals)
    return np.atleast_1d(vals)


def lufs_integrated(s: Signal) -> float:
    """Integrated loudness per ITU-R BS.1770-5: K-weighting (device IIR) +
    400 ms gating blocks (device framing)
    (`standard/gain_and_level.py:203-283`)."""
    from .other import merge_filters

    assert s.number_of_channels <= 5, (
        "Not implemented for more channels than 5"
    )
    fs_hz = s.sampling_rate_hz
    k_filter = merge_filters(
        [
            Filter.biquad(
                eq_type=BiquadEqType.Highshelf,
                frequency_hz=1500,
                gain_db=4.0,
                q=2**0.5 / 2.0,
                sampling_rate_hz=fs_hz,
            ),
            Filter.biquad(
                eq_type=BiquadEqType.Highpass,
                frequency_hz=38.1,
                gain_db=0.0,
                q=0.5,
                sampling_rate_hz=fs_hz,
            ),
        ]
    )
    Tg = 400e-3
    G = np.array([1.0, 1.0, 1.0, 1.41, 1.41])[: s.number_of_channels]
    Tg_samples = int(Tg * fs_hz + 0.5)
    step = int(0.25 * Tg_samples + 0.5)
    GAMMA_A = -70
    DIFF_GAMMA_R = 10

    constrained = s.constrain_amplitude
    s.constrain_amplitude = False
    s_pre = k_filter.filter_signal(s)
    s.constrain_amplitude = constrained

    frames = frame_signal(
        s_pre.time_data_jax.T**2.0, Tg_samples, step, keep_last_frames=False
    )  # (C, K, L)
    z_ji = np.asarray(jnp.mean(frames, axis=-1)).T  # (K, C)

    def gated_loudness(x):
        return -0.691 + 10.0 * np.log10(x @ G)

    l_j = gated_loudness(z_ji)
    gamma_r = (
        gated_loudness(np.mean(z_ji[l_j > GAMMA_A, :], axis=0))
        - DIFF_GAMMA_R
    )
    return float(
        gated_loudness(
            np.mean(z_ji[l_j > max(gamma_r, GAMMA_A), :], axis=0)
        )
    )


def apply_gain(target, gain_db):
    """Gain application on signals/filters
    (`standard/gain_and_level.py:284-360`)."""
    if isinstance(target, Signal):
        gain_linear = np.asarray(from_db(np.atleast_1d(gain_db), True))
        if len(gain_linear) == 1:
            gain_linear = gain_linear[0]
        new_sig = target.copy_with_new_time_data(
            target.time_data * gain_linear
        )
        if new_sig.is_complex_signal:
            new_sig.time_data_imaginary = (
                new_sig.time_data_imaginary * gain_linear
            )
        return new_sig
    if isinstance(target, MultiBandSignal):
        new_mb = target.copy()
        new_mb.bands = [apply_gain(b, gain_db) for b in new_mb.bands]
        return new_mb
    if isinstance(target, Filter):
        filt = target.copy()
        gain_linear = np.asarray(from_db(np.atleast_1d(gain_db), True))
        if len(gain_linear) == 1:
            gain_linear = gain_linear[0]
        if filt.has_zpk:
            filt.zpk[-1] *= gain_linear
        if filt.has_sos:
            filt.sos[-1, :3] *= gain_linear
        else:
            filt.ba[0] *= gain_linear
        return filt
    if isinstance(target, FilterBank):
        gain = np.atleast_1d(gain_db)
        assert len(gain) == 1 or len(gain) == target.number_of_filters, (
            "Incompatible number of gains"
        )
        if len(gain) == 1:
            gain = np.repeat(gain, target.number_of_filters)
        new_fb = target.copy()
        new_fb.filters = [
            apply_gain(f, g) for f, g in zip(new_fb.filters, gain)
        ]
        return new_fb
    raise TypeError("No valid type was passed")


def crest_factor(
    sig, in_db: bool = True, use_true_peak: bool = False
) -> np.ndarray:
    """Peak-to-RMS ratio (`standard/gain_and_level.py:362-401`)."""
    if isinstance(sig, Signal):
        peak = (
            np.asarray(from_db(true_peak_level(sig)[0], True))
            if use_true_peak
            else np.max(np.abs(sig.time_data), axis=0)
        )
        crest = peak / np.std(sig.time_data, axis=0)
        if in_db:
            crest = 20.0 * np.log10(crest)
        return np.atleast_1d(crest)
    if isinstance(sig, MultiBandSignal):
        crest = np.zeros((sig.number_of_bands, sig.number_of_channels))
        for ind, b in enumerate(sig):
            crest[ind, :] = crest_factor(b, in_db, use_true_peak)
        return crest
    raise TypeError(
        "Passed signal should be either a Signal or MultiBandSignal type"
    )
