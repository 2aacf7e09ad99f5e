"""Filter design helpers and Signal-level application glue.

Behavioral reference: `dsptoolbox/classes/filter_helpers.py`. Coefficient
design is host-side numpy (static given parameters); application dispatches
to the device kernels in `ops.iir` / `ops.fft_conv` with channels-first
layout.
"""

from __future__ import annotations

from warnings import warn

import jax.numpy as jnp
import numpy as np

from ..ops.fft_conv import fft_convolve
from ..ops.iir import (
    filtfilt_ba,
    lfilter,
    sosfilt,
    sosfilt_zero_state,
    sosfiltfilt,
)
from ..standard.enums import BiquadEqType


def biquad_coefficients(
    eq_type: BiquadEqType,
    fs_hz: int,
    frequency_hz: float,
    gain_db: float,
    q: float,
):
    """RBJ audio-EQ-cookbook biquad coefficients.

    parity: like the reference (`classes/filter_helpers.py:30-44`), the
    linear gain ``A`` multiplies the numerator of *every* eq type (not only
    peak/shelf, where the cookbook defines it as 10^(G/40)).
    """
    shelf_like = eq_type in (
        BiquadEqType.Peaking,
        BiquadEqType.Lowshelf,
        BiquadEqType.Highshelf,
    )
    A = 10 ** (gain_db / 40) if shelf_like else 10 ** (gain_db / 20)
    Omega = 2.0 * np.pi * (frequency_hz / fs_hz)
    sn, cs = np.sin(Omega), np.cos(Omega)
    alpha = sn / (2.0 * q)
    sqA = np.sqrt(A)
    b = np.zeros(3)
    a = np.zeros(3)
    if eq_type == BiquadEqType.Peaking:
        b[:] = 1 + alpha * A, -2 * cs, 1 - alpha * A
        a[:] = 1 + alpha / A, -2 * cs, 1 - alpha / A
    elif eq_type == BiquadEqType.Lowpass:
        b[:] = (1 - cs) / 2 * A, (1 - cs) * A, (1 - cs) / 2 * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.Highpass:
        b[:] = (1 + cs) / 2 * A, -(1 + cs) * A, (1 + cs) / 2 * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.BandpassSkirt:
        b[:] = sn / 2 * A, 0.0, -sn / 2 * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.BandpassPeak:
        b[:] = alpha * A, 0.0, -alpha * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.Notch:
        b[:] = A, -2 * cs * A, A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.Allpass:
        b[:] = (1 - alpha) * A, -2 * cs * A, (1 + alpha) * A
        a[:] = 1 + alpha, -2 * cs, 1 - alpha
    elif eq_type == BiquadEqType.Lowshelf:
        b[:] = (
            A * ((A + 1) - (A - 1) * cs + 2 * sqA * alpha),
            2 * A * ((A - 1) - (A + 1) * cs),
            A * ((A + 1) - (A - 1) * cs - 2 * sqA * alpha),
        )
        a[:] = (
            (A + 1) + (A - 1) * cs + 2 * sqA * alpha,
            -2 * ((A - 1) + (A + 1) * cs),
            (A + 1) + (A - 1) * cs - 2 * sqA * alpha,
        )
    elif eq_type == BiquadEqType.Highshelf:
        b[:] = (
            A * ((A + 1) + (A - 1) * cs + 2 * sqA * alpha),
            -2 * A * ((A - 1) + (A + 1) * cs),
            A * ((A + 1) + (A - 1) * cs - 2 * sqA * alpha),
        )
        a[:] = (
            (A + 1) - (A - 1) * cs + 2 * sqA * alpha,
            2 * ((A - 1) - (A + 1) * cs),
            (A + 1) - (A - 1) * cs - 2 * sqA * alpha,
        )
    elif eq_type == BiquadEqType.LowpassFirstOrder:
        K = 1.0 / np.tan(Omega / 2.0)
        b[:] = A, A, 0.0
        a[:] = 1.0 + K, 1.0 - K, 0.0
    elif eq_type == BiquadEqType.HighpassFirstOrder:
        K = 1.0 / np.tan(Omega / 2.0)
        b[:] = K * A, -K * A, 0.0
        a[:] = 1.0 + K, 1.0 - K, 0.0
    elif eq_type == BiquadEqType.AllpassFirstOrder:
        K = 1.0 / np.tan(Omega / 2.0)
        b[:] = (1.0 - K) * A, (1.0 + K) * A, 0.0
        a[:] = 1.0 + K, 1.0 - K, 0.0
    elif eq_type == BiquadEqType.Inverter:
        b[:] = A, 0.0, 0.0
        a[:] = 1.0, 0.0, 0.0
    else:
        raise ValueError("eq_type not supported")
    return b, a


def impulse(length_samples: int = 512, delay_samples: int = 0) -> np.ndarray:
    """Unit impulse (`classes/filter_helpers.py:145-164`)."""
    imp = np.zeros(length_samples)
    imp[delay_samples] = 1
    return imp


def _eval_descending_poly_ratio_on_arc(cr, c, n_points: int):
    """``polyval(cr, z) / polyval(c, z)`` for ``z = exp(1j·linspace(0, π,
    n_points))`` without Horner evaluation.

    Factoring ``z^(L-1)`` out of both descending-order polynomials leaves
    ``Σ x[j]·z^(-j)``, and on the grid ``ω_k = πk/(n_points-1) = 2πk/N``
    (``N = 2(n_points-1)``) that sum IS the length-N real FFT of ``x`` with
    indices folded mod N. Replaces the reference's O(L·F) `np.polyval`
    (`classes/filter_helpers.py:181-189`), which costs ~10 s for an IR-length
    polynomial, with two O(N log N) f64 FFTs — identical math on the same
    grid, f64 rounding differences only (~1e-12)."""
    N = 2 * (n_points - 1)

    def _fold_rfft(x):
        if len(x) > N:
            folded = np.zeros(N, dtype=x.dtype)
            np.add.at(folded, np.arange(len(x)) % N, x)
        else:
            folded = x
        return np.fft.rfft(folded, n=N)[:n_points]

    return _fold_rfft(np.asarray(cr)), _fold_rfft(np.asarray(c))


def group_delay_filter(ba, length_samples: int = 512, fs_hz: int = 48000):
    """Group delay of a filter from ba via ramped-coefficient polynomial
    evaluation (`classes/filter_helpers.py:166-205`). Host f64 math; the
    polynomial ratio is evaluated by FFT (see
    `_eval_descending_poly_ratio_on_arc`) so IR-length inputs stay fast."""
    omega = np.linspace(0, np.pi, length_samples)
    c = np.convolve(ba[0], np.conjugate(ba[1][::-1]))
    cr = c * np.arange(len(c))
    num, denum = _eval_descending_poly_ratio_on_arc(cr, c, length_samples)
    with np.errstate(divide="ignore", invalid="ignore"):
        gd = np.real(num / denum) - len(ba[1]) + 1
    gd[~np.isfinite(gd)] = 0
    f = omega / np.pi * (fs_hz / 2)
    return f, gd / fs_hz


def _replace_channels(signal, y, channels, warn_complex: bool):
    """Insert filtered channels ``y (T, len(channels))`` back into a copy of
    ``signal``; complex output goes to time_data_imaginary with a warning.

    ``y`` may be a (T, C) device pair ``DeviceTimeData`` for the
    full-channel case — then the result stays device-resident (no
    per-band host assembly)."""
    from .signal import DeviceTimeData

    channels_np = np.asarray(channels)
    full = (
        channels_np.shape[0] == signal.number_of_channels
        and np.array_equal(channels_np, np.arange(channels_np.shape[0]))
    )
    if isinstance(y, DeviceTimeData):
        assert full, "device-pair replacement requires all channels"
        if y.imag is not None and warn_complex:
            warn(
                "Filter output is complex. Imaginary part is saved in "
                "Signal as time_data_imaginary"
            )
        return signal.copy_with_new_time_data(y)
    if np.iscomplexobj(y):
        # host-side assembly of the complex output
        if warn_complex:
            warn(
                "Filter output is complex. Imaginary part is saved in "
                "Signal as time_data_imaginary"
            )

        new_td = np.asarray(signal.time_data).astype(np.complex128)
        new_td[:, channels_np] = np.asarray(y)
        return signal.copy_with_new_time_data(new_td)
    if full and isinstance(y, jnp.ndarray):
        return signal.copy_with_new_time_data(y)
    new_td = jnp.asarray(signal.time_data)
    new_td = new_td.at[:, jnp.asarray(channels)].set(y)
    return signal.copy_with_new_time_data(new_td)


def _oracle_exact_f64() -> bool:
    """True in float64 drop-in mode: IIR/zero-phase application routes
    through the literal scipy recursions on the host so results are
    BIT-identical to the reference (its tests assert rtol=1e-7/atol=0
    against scipy, `tests/test_classes.py:495-531`; any re-associated
    f64 kernel fails on near-zero samples). The fp32 device kernels are
    unaffected.

    Set ``DSPTB_F64_DEVICE_IIR=1`` to force the blocked device kernels
    even in f64 mode — the instrumentation switch used to measure how
    many reference tests truly require bit-exactness (count committed in
    docs/parity_notes.md)."""
    import os

    if os.environ.get("DSPTB_F64_DEVICE_IIR") == "1":
        return False
    from .._config import default_float

    return np.dtype(default_float()) == np.float64


def filter_on_signal(
    signal,
    sos: np.ndarray,
    channels=None,
    zi=None,
    zero_phase: bool = False,
    warning_on_complex_output: bool = True,
):
    """SOS filtering of selected channels of a Signal
    (`classes/filter_helpers.py:208-286`). Returns (new_signal, zi_new)."""
    if channels is None:
        channels = np.arange(signal.number_of_channels)
    complex_sos = np.iscomplexobj(sos)
    if _oracle_exact_f64() and not complex_sos:
        import scipy.signal as _ssig

        xh = np.asarray(
            signal.time_data[:, np.asarray(channels)].T, np.float64
        )  # (C_sel, T)
        if zi is not None:
            zi_all = np.stack(zi, axis=0)  # (C_all, S, 2)
            zi_sel = np.transpose(
                zi_all[np.asarray(channels)], (1, 0, 2)
            )  # (S, C_sel, 2)
            y, zf = _ssig.sosfilt(sos, xh, axis=-1, zi=zi_sel)
            zi_all[np.asarray(channels)] = np.transpose(zf, (1, 0, 2))
            zi_new = [zi_all[c] for c in range(zi_all.shape[0])]
        elif zero_phase:
            y = _ssig.sosfiltfilt(sos, xh, axis=-1)
            zi_new = None
        else:
            y = _ssig.sosfilt(sos, xh, axis=-1)
            zi_new = None
        new_signal = _replace_channels(
            signal,
            jnp.asarray(np.ascontiguousarray(y.T)),
            channels,
            warning_on_complex_output,
        )
        return new_signal, zi_new
    x = signal.time_data_jax[:, jnp.asarray(channels)].T  # (C_sel, T)
    if zi is not None:
        from .._config import run_maybe_jitted

        zi_arr = jnp.asarray(np.stack(zi, axis=0))  # (C_all, S, 2)
        zi_sel = zi_arr[jnp.asarray(channels)]
        y, zf = run_maybe_jitted(
            lambda xv, zv: sosfilt(sos, xv, zi=zv), x, zi_sel
        )
        zi_arr = zi_arr.at[jnp.asarray(channels)].set(zf)
        # one host fetch for all channels, not one round trip per channel
        zi_host = np.asarray(zi_arr)
        zi_new = [zi_host[c] for c in range(zi_host.shape[0])]
    else:
        zi_new = None
        from .._config import run_jitted_complex, run_maybe_jitted

        # one cached jitted program per (filter, shape) instead of one
        # dispatch per op
        if complex_sos:
            fn = sosfiltfilt if zero_phase else (
                lambda s_, x_: sosfilt(s_, x_)[0]
            )
            yr, yi = run_jitted_complex(
                lambda xv: (lambda yv: (yv.real, yv.imag))(fn(sos, xv)),
                x,
                materialize=False,
            )
            channels_np = np.asarray(channels)
            if channels_np.shape[0] == signal.number_of_channels and (
                np.array_equal(
                    channels_np, np.arange(channels_np.shape[0])
                )
            ):
                from .signal import DeviceTimeData

                new_signal = _replace_channels(
                    signal,
                    DeviceTimeData(yr.T, yi.T),
                    channels,
                    warning_on_complex_output,
                )
                return new_signal, zi_new
            y = np.asarray(yr) + 1j * np.asarray(yi)
            new_signal = _replace_channels(
                signal, y.T, channels, warning_on_complex_output
            )
            return new_signal, zi_new
        elif zero_phase:
            y = run_maybe_jitted(lambda xv: sosfiltfilt(sos, xv), x)
        else:
            y = run_maybe_jitted(lambda xv: sosfilt_zero_state(sos, xv), x)
    new_signal = _replace_channels(
        signal, y.T, channels, warning_on_complex_output
    )
    return new_signal, zi_new


def filter_on_signal_ba(
    signal,
    ba,
    channels=None,
    zi=None,
    zero_phase: bool = False,
    is_fir: bool = False,
    warning_on_complex_output: bool = True,
):
    """ba filtering of selected channels (`classes/filter_helpers.py:288-380`).

    FIR without state → FFT convolution truncated to the signal length (the
    device replacement for the reference's `_lfilter_fir`/oaconvolve path).
    Returns (new_signal, zi_new)."""
    b, a = np.atleast_1d(ba[0]), np.atleast_1d(ba[1])
    if channels is None:
        channels = np.arange(signal.number_of_channels)
    if (
        _oracle_exact_f64()
        and not np.iscomplexobj(b)
        and not np.iscomplexobj(a)
    ):
        import scipy.signal as _ssig

        xh = np.asarray(
            signal.time_data[:, np.asarray(channels)].T, np.float64
        )  # (C_sel, T)
        if zi is not None:
            zi_all = np.stack(zi, axis=0)  # (C_all, N)
            zi_sel = zi_all[np.asarray(channels)]
            y, zf = _ssig.lfilter(b, a, xh, axis=-1, zi=zi_sel)
            zi_all[np.asarray(channels)] = zf
            zi_new = [zi_all[c] for c in range(zi_all.shape[0])]
        elif zero_phase:
            y = _ssig.filtfilt(b, a, xh, axis=-1)
            zi_new = None
        elif is_fir:
            y = _ssig.oaconvolve(
                xh, b[None, :], mode="full", axes=-1
            )[..., : xh.shape[-1]]
            zi_new = None
        else:
            y = _ssig.lfilter(b, a, xh, axis=-1)
            zi_new = None
        new_signal = _replace_channels(
            signal,
            jnp.asarray(np.ascontiguousarray(y.T)),
            channels,
            warning_on_complex_output,
        )
        return new_signal, zi_new
    x = signal.time_data_jax[:, jnp.asarray(channels)].T  # (C_sel, T)
    T = x.shape[-1]
    if zi is not None:
        from .._config import run_maybe_jitted

        zi_arr = jnp.asarray(np.stack(zi, axis=0))  # (C_all, N)
        zi_sel = zi_arr[jnp.asarray(channels)]
        y, zf = run_maybe_jitted(
            lambda xv, zv: lfilter(b, a, xv, zi=zv), x, zi_sel
        )
        zi_arr = zi_arr.at[jnp.asarray(channels)].set(zf)
        # one host fetch for all channels, not one round trip per channel
        zi_host = np.asarray(zi_arr)
        zi_new = [zi_host[c] for c in range(zi_host.shape[0])]
    else:
        zi_new = None
        from .._config import run_maybe_jitted

        # one cached jitted program per (filter, shape) — see
        # filter_on_signal
        if zero_phase:
            if is_fir:
                # scipy.filtfilt semantics for a pure FIR (odd-ext padding
                # + zi-initialized passes) in FFT-conv form: without
                # feedback the TDF2 initial state surfaces as an additive
                # length-N head correction, so each pass is one conv + one
                # slice-add — no sequential scan
                from ..ops.iir import _odd_ext, lfilter_zi

                padlen = 3 * max(len(a), len(b))
                if T <= padlen:
                    raise ValueError(
                        "Input too short for filtfilt padding"
                    )
                zi0 = lfilter_zi(b, a)

                def _zp_fir(xv):
                    h = jnp.asarray(b, dtype=xv.real.dtype)
                    ziv = jnp.asarray(zi0, dtype=xv.real.dtype)

                    def one_pass(u):
                        yv = fft_convolve(u, h)[..., : u.shape[-1]]
                        head = ziv * u[..., :1]
                        return yv.at[..., : ziv.shape[0]].add(head)

                    ext = _odd_ext(xv, padlen)
                    yv = one_pass(ext)
                    yv = jnp.flip(one_pass(jnp.flip(yv, -1)), -1)
                    return yv[..., padlen:-padlen]

                y = run_maybe_jitted(_zp_fir, x)
            else:
                y = run_maybe_jitted(lambda xv: filtfilt_ba(b, a, xv), x)
        else:
            if is_fir:
                y = run_maybe_jitted(
                    lambda xv: fft_convolve(
                        xv, jnp.asarray(b, dtype=xv.real.dtype)
                    )[..., :T],
                    x,
                )
            else:
                y = run_maybe_jitted(lambda xv: lfilter(b, a, xv)[0], x)
    new_signal = _replace_channels(
        signal, y.T, channels, warning_on_complex_output
    )
    return new_signal, zi_new
