"""Transfer-function measurement and IR manipulation (public API).

Behavioral reference: `dsptoolbox/transfer_functions/transfer_functions.py`.
Device-side bulk math (spectral division, Welch estimators, min-phase,
frequency-dependent windowing, complex smoothing as a static-operator
matmul); host-side peak/trim decision logic.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..classes import Filter, FilterBank, ImpulseResponse, Signal, Spectrum
from ..helpers.gain_and_level import from_db, to_db
from ..helpers.latency import get_fractional_impulse_peak_index
from ..helpers.minimum_phase import (
    min_phase_ir_from_real_cepstrum,
    minimum_phase_spectrum_from_real_cepstrum,
)
from ..helpers.smoothing import fractional_octave_smoothing
from ..helpers.spectrum_utilities import (
    correct_for_real_phase_spectrum,
    interpolate_fr,
)
from ..ops.pad_trim import pad_trim_axis
from ..ops.spectral import welch
from ..standard.backend import group_delay_direct, minimum_phase_from_magnitude
from ..standard.enums import (
    MagnitudeNormalization,
    SpectrumMethod,
    SpectrumType,
    Window,
)
from . import _backend as bk
from .enums import SmoothingDomain, TransferFunctionType


def spectral_deconvolve(
    output: Signal,
    input: Signal,
    apply_regularization: bool = True,
    start_stop_hz=None,
    threshold_db: float = -30.0,
    padding: bool = False,
    keep_original_length: bool = False,
) -> ImpulseResponse:
    """Deconvolution by (regularized) spectral division
    (`transfer_functions.py:61-184`). The division and inverse FFT run
    batched on device; the regularization window per channel is static."""
    assert output.time_data_jax.shape[0] == input.time_data_jax.shape[0], (
        "Lengths do not match for spectral deconvolution"
    )
    if input.number_of_channels != 1:
        assert output.number_of_channels == input.number_of_channels, (
            "The number of channels do not match."
        )
        multichannel = False
    else:
        multichannel = True
    assert output.sampling_rate_hz == input.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    if not apply_regularization:
        assert start_stop_hz is None, (
            "No start_stop_hz vector can be passed when using standard mode"
        )

    _orig_input = input
    original_length = output.time_data_jax.shape[0]
    if padding:
        output = output.copy()
        input = input.copy()
        output.time_data = np.asarray(
            pad_trim_axis(output.time_data_jax, original_length * 2, axis=0)
        )
        input.time_data = np.asarray(
            pad_trim_axis(input.time_data_jax, original_length * 2, axis=0)
        )
    # parity: the reference FFTs at the signals' configured length, which
    # defaults to next_fast_len padding (`transfer_functions.py:143-145`
    # with `classes/signal.py:899-904`) — do NOT force the exact length.
    # The unpadded path temporarily overrides spectrum_method on the
    # callers' signals instead of deep-copying them (~3.5 ms per call).
    # The override writes the parameter dict directly, NOT the public
    # setter: the setter drops the host spectrum/csm caches, which would
    # silently destroy a caller's expensive cached CSM on every
    # deconvolution. Nothing reads those host caches while the override is
    # active — the device-spectrum cache consulted below is self-validating
    # via `_spectrum_param_key` (which includes the method).
    _prev_methods = (input.spectrum_method, output.spectrum_method)
    # the single-slot device-spectrum cache would otherwise be replaced by
    # the FFT-method entry computed below, silently dropping a caller's
    # cached (e.g. Welch) spectrum — snapshot and restore it
    _prev_dev_entries = [
        (
            sig,
            sig._cache.get("spectrum_dev"),
            sig._cache.get("spectrum_dev_mono"),
        )
        for sig in (input, output)
    ]
    try:
        input._spectrum_parameters["method"] = SpectrumMethod.FFT
        output._spectrum_parameters["method"] = SpectrumMethod.FFT
        for sig in (input, output):
            # re-seed from the previous deconvolution's stashed FFT entry
            # (self-validating key, so a stale stash just misses)
            stashed = sig._cache.pop("deconv_spectrum_dev", None)
            if stashed is not None:
                sig._cache["spectrum_dev"] = stashed
        # device-resident spectra: the division consumes them on-device;
        # only the (small, real) |denum| comes host for the regularization
        # window
        _, denum_re, denum_im = input._get_spectrum_device()
        freqs_hz, num_re, num_im = output._get_spectrum_device()
    finally:
        for sig, dev_entry, mono_entry in _prev_dev_entries:
            cur = sig._cache.get("spectrum_dev")
            if cur is not None and cur is not dev_entry:
                # keep the FFT-method entry for the next deconvolution
                sig._cache["deconv_spectrum_dev"] = cur
            if dev_entry is not None:
                sig._cache["spectrum_dev"] = dev_entry
            else:
                sig._cache.pop("spectrum_dev", None)
            if mono_entry is not None:
                sig._cache["spectrum_dev_mono"] = mono_entry
        input._spectrum_parameters["method"] = _prev_methods[0]
        output._spectrum_parameters["method"] = _prev_methods[1]
    fs_hz = output.sampling_rate_hz
    length = original_length * 2 if padding else original_length

    from .._config import run_jitted_complex
    from ..classes.signal import _dev_jit

    C = output.number_of_channels

    if apply_regularization:
        # parity: the reference reassigns start_stop_hz inside its channel
        # loop (`transfer_functions.py:151-168`), so the automatic
        # regularization range is computed ONCE — from channel 0 — and
        # every channel reuses the same window
        ssz = start_stop_hz
        import jax as _jax

        if ssz is None and isinstance(denum_re, _jax.core.Tracer):
            # pipeline trace: no host fetch is possible, so the automatic
            # regularization range AND its Hann window are computed
            # in-program (`bk.regularization_window_traced`) and the whole
            # deconvolution stays one traced expression
            thr = float(threshold_db)
            f0 = float(freqs_hz[0])
            df = float(freqs_hz[1] - freqs_hz[0])
            nyq = float(fs_hz / 2)
            F = int(len(freqs_hz))

            def _deconv_auto(nre, nim, dre, dim):
                mag = jnp.sqrt(dre[:, 0] * dre[:, 0] + dim[:, 0] * dim[:, 0])
                db = 20.0 * jnp.log10(
                    jnp.clip(mag, jnp.finfo(mag.dtype).tiny, None)
                )
                mask = (db - jnp.max(db)) > thr
                first = jnp.argmax(mask)
                last = mask.shape[0] - 1 - jnp.argmax(mask[::-1])
                eps_t = bk.regularization_window_traced(
                    first, last, F, f0, df, nyq
                )
                num = nre + 1j * nim
                den = dre + 1j * dim
                if multichannel:
                    den = jnp.broadcast_to(den[:, :1], num.shape)
                return bk.spectral_deconvolve_core(num, den, length, eps_t)

            new_time_data = run_jitted_complex(
                _deconv_auto,
                num_re,
                num_im,
                denum_re,
                denum_im,
                materialize=False,
                key=(
                    "deconv_core_auto", bool(multichannel), int(length),
                    thr, F, f0, df, nyq,
                ),
            )
            new_sig = ImpulseResponse(
                None,
                new_time_data,
                output.sampling_rate_hz,
                constrain_amplitude=False,
            )
            if padding and keep_original_length:
                new_sig.time_data = pad_trim_axis(
                    new_sig.time_data_jax, original_length, axis=0
                )
            return new_sig
        if ssz is None:
            # the first/last bin above threshold is a reduction over the
            # denominator magnitude: run it on device and fetch 2 ints
            # instead of the full (F, C) magnitude (the excitation is
            # usually fixed across measurements, so cache the result on
            # the original input signal)
            cache_key = (
                float(threshold_db),
                bool(padding),
                int(original_length),
                _orig_input._spectrum_param_key(),
            )
            hit = _orig_input._cache.get("deconv_ssz")
            if hit is not None and hit[0] == cache_key:
                ssz = hit[1]
            else:

                def _first_last(dre, dim):
                    mag = jnp.sqrt(
                        dre[:, 0] * dre[:, 0] + dim[:, 0] * dim[:, 0]
                    )
                    db = 20.0 * jnp.log10(
                        jnp.clip(mag, jnp.finfo(mag.dtype).tiny, None)
                    )
                    mask = (db - jnp.max(db)) > threshold_db
                    first = jnp.argmax(mask)
                    last = mask.shape[0] - 1 - jnp.argmax(mask[::-1])
                    return jnp.stack([first, last])

                fl = np.asarray(
                    _dev_jit(
                        ("deconv_first_last", float(threshold_db)),
                        _first_last,
                    )(denum_re, denum_im)
                )
                ssz = [freqs_hz[int(fl[0])], freqs_hz[int(fl[1])]]
                # self-validating entry (like the device-spectrum cache):
                # the key re-checks every input, and Signal._cache is
                # cleared whenever the time data mutates
                _orig_input._cache["deconv_ssz"] = (cache_key, ssz)
        if len(ssz) == 2:
            ssz = np.array(
                [
                    ssz[0] / np.sqrt(2),
                    ssz[0],
                    ssz[1],
                    np.min([ssz[1] * np.sqrt(2), fs_hz / 2]),
                ]
            )
        elif len(ssz) != 4:
            raise ValueError(
                "start_stop_hz vector should have 2 or 4 values"
            )
        eps_key = (
            tuple(float(v) for v in ssz),
            int(len(freqs_hz)),
            float(freqs_hz[0]),
            float(freqs_hz[1] - freqs_hz[0]),
        )
        eps = bk.regularization_window_device(
            *eps_key
        )  # (F, 1), broadcasts over channels in the division
    else:
        eps_key = None
        eps = None

    def _deconv(nre, nim, dre, dim):
        num = nre + 1j * nim
        den = dre + 1j * dim
        if multichannel:
            den = jnp.broadcast_to(den[:, :1], num.shape)
        return bk.spectral_deconvolve_core(num, den, length, eps)

    new_time_data = run_jitted_complex(
        _deconv,
        num_re,
        num_im,
        denum_re,
        denum_im,
        materialize=False,  # the IR stays device-resident
        # explicit program identity: every closure dependency of _deconv
        # (the eps window is fully determined by eps_key via the lru cache)
        key=("deconv_core", bool(multichannel), int(length), eps_key),
    )
    new_sig = ImpulseResponse(
        None,
        new_time_data,
        output.sampling_rate_hz,
        constrain_amplitude=False,
    )
    if padding and keep_original_length:
        new_sig.time_data = pad_trim_axis(
            new_sig.time_data_jax, original_length, axis=0
        )
    return new_sig


def window_ir(
    signal: ImpulseResponse,
    total_length_samples: int,
    adaptive: bool = True,
    constant_percentage: float = 0.75,
    window_type: Window | list = Window.Hann,
    at_start: bool = True,
    offset_samples: int = 0,
    left_to_right_flank_length_ratio: float = 1.0,
    return_device: bool = False,
):
    """Adaptive peak-aligned Tukey-like windowing
    (`transfer_functions.py:187-293`). Returns (windowed IR, start
    positions).

    ``return_device=True`` leaves the start-position vector on the
    device (the default numpy conversion is a host fetch — the only
    sync in a deconvolve→window chain)."""
    assert isinstance(signal, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    assert 0 <= constant_percentage < 1, (
        "Constant percentage can not be larger than 1 or smaller than 0"
    )
    assert offset_samples >= 0, "Offset must be positive"
    assert offset_samples <= constant_percentage * total_length_samples, (
        "Offset is too large for the constant part of the window and its "
        "total length"
    )
    assert left_to_right_flank_length_ratio >= 0, (
        "Ratio between window flanks must be a positive number"
    )
    from ..classes.signal import _dev_jit

    td_dev = signal.time_data_jax
    if window_type is Window.Hann:
        # zero-sync path: peak search, adaptive trimming, Hann flank
        # construction and the windowed gather run as one device program
        # with no host sync
        fn = bk.window_ir_fused_program(
            total_length_samples,
            adaptive,
            constant_percentage,
            at_start,
            offset_samples,
            left_to_right_flank_length_ratio,
        )
        new_time_data, window_dev, start_positions = _dev_jit(
            (
                "window_ir_fused",
                total_length_samples,
                adaptive,
                float(constant_percentage),
                at_start,
                int(offset_samples),
                float(left_to_right_flank_length_ratio),
            ),
            fn,
        )(td_dev)
        new_sig = signal.copy_with_new_time_data(new_time_data)
        new_sig.set_window(window_dev)
        if return_device:
            return new_sig, start_positions
        # host ints: the reference returns a numpy start-position vector
        # (`transfer_functions.py:289-293`) and its tests isinstance-check
        return new_sig, np.asarray(start_positions)

    C = signal.number_of_channels
    start_positions = np.zeros(C, dtype=int)
    window = np.zeros((total_length_samples, C))
    slice_starts = np.zeros(C, dtype=np.int32)
    # device-resident path: only the per-channel peak index comes to the
    # host (C ints); the trimming decisions are pure index arithmetic
    # (window_this_ir_tukey_meta) and the windowed slice is gathered and
    # multiplied on device
    T = td_dev.shape[0]
    peaks = np.asarray(
        _dev_jit("absargmax0", lambda a: jnp.argmax(jnp.abs(a), axis=0))(
            td_dev
        )
    )
    for n in range(C):
        slice_starts[n], window[:, n], start_positions[n] = (
            bk.window_this_ir_tukey_meta(
                T,
                int(peaks[n]),
                total_length_samples,
                window_type,
                constant_percentage,
                at_start,
                offset_samples,
                left_to_right_flank_length_ratio,
                adaptive,
            )
        )

    def _apply_window(td, starts, win):
        import jax

        L = win.shape[0]
        # pad 2L on both sides: slice starts lie in [-2L, T] for any
        # valid flank/offset configuration, so dynamic_slice never clamps
        padded = jnp.pad(td, ((2 * L, 2 * L), (0, 0)))

        def one(col, s):
            return jax.lax.dynamic_slice(col, (s + 2 * L,), (L,))

        segs = jax.vmap(one, in_axes=(1, 0), out_axes=1)(padded, starts)
        return segs * win

    new_time_data = _dev_jit("window_ir_apply", _apply_window)(
        td_dev,
        jnp.asarray(slice_starts),
        jnp.asarray(window, td_dev.dtype),
    )
    new_sig = signal.copy_with_new_time_data(new_time_data)
    new_sig.set_window(window)
    return new_sig, start_positions


def window_ir_tukey(
    ir: ImpulseResponse,
    left_flank_s: float | None,
    right_flank_s: float | None,
    window_flank_type: Window = Window.Hann,
) -> ImpulseResponse:
    """Timing-preserving Tukey-like window over all channels
    (`transfer_functions.py:295-367`)."""
    from scipy.signal import get_window as get_window_scipy

    assert isinstance(ir, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    assert left_flank_s is not None or right_flank_s is not None, (
        "At least one flank length should be passed"
    )
    assert window_flank_type != Window.Tukey, (
        "Tukey window type is not supported here. For computing a standard "
        "Tukey window, pass `Hann` as window type"
    )
    left = (
        int(left_flank_s * ir.sampling_rate_hz + 0.5)
        if left_flank_s is not None
        else 0
    )
    right = (
        int(right_flank_s * ir.sampling_rate_hz + 0.5)
        if right_flank_s is not None
        else 0
    )
    assert left + right <= ir.length_samples, (
        "Flanks overlap given the current IR length"
    )
    window = np.ones((ir.length_samples, 1))
    if left > 0:
        window[:left, 0] = get_window_scipy(
            window_flank_type.to_scipy_format(), left * 2
        )[:left]
    if right > 0:
        window[-right:, 0] = get_window_scipy(
            window_flank_type.to_scipy_format(), right * 2
        )[right:]
    new_ir = ir.copy_with_new_time_data(ir.time_data * window)
    new_ir.set_window(np.repeat(window, ir.number_of_channels, 1))
    return new_ir


def window_centered_ir(
    signal: ImpulseResponse,
    total_length_samples: int,
    window_type: Window = Window.Hann,
):
    """Peak-centered windowing (`transfer_functions.py:368-417`)."""
    assert isinstance(signal, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    from ..classes.signal import _dev_jit

    C = signal.number_of_channels
    td_dev = signal.time_data_jax
    T = td_dev.shape[0]
    L = int(total_length_samples)
    # only the per-channel peak index comes to the host (C ints); the
    # slice/flip decisions are pure index arithmetic and the windowed
    # slices are gathered and multiplied in one batched device program
    peaks = np.asarray(
        _dev_jit("absargmax0", lambda a: jnp.argmax(jnp.abs(a), axis=0))(
            td_dev
        )
    )
    start_positions = np.zeros(C, dtype=int)
    window = np.zeros((L, C))
    win_pre = np.zeros((L, C))
    flips = np.zeros(C, dtype=bool)
    starts = np.zeros(C, dtype=np.int32)
    for n in range(C):
        flip, start, win_col = bk.window_this_ir_centered_meta(
            T, int(peaks[n]), L, window_type
        )
        flips[n] = flip
        starts[n] = start
        start_positions[n] = start
        win_pre[:, n] = win_col
        window[:, n] = win_col[::-1] if flip else win_col

    def _apply_centered(td, flips_j, starts_j, win):
        import jax

        length = win.shape[0]
        td_f = jnp.where(flips_j[None, :], td[::-1], td)
        padded = jnp.pad(td_f, ((0, 2 * length), (0, 0)))

        def one(col, s):
            return jax.lax.dynamic_slice(col, (s,), (length,))

        segs = jax.vmap(one, in_axes=(1, 0), out_axes=1)(padded, starts_j)
        segs = segs * win
        return jnp.where(flips_j[None, :], segs[::-1], segs)

    new_time_data = _dev_jit("window_centered_apply", _apply_centered)(
        td_dev,
        jnp.asarray(flips),
        jnp.asarray(starts),
        jnp.asarray(win_pre, td_dev.dtype),
    )
    new_sig = signal.copy_with_new_time_data(new_time_data)
    new_sig.set_window(window)
    return new_sig, start_positions


def compute_transfer_function(
    output: Signal,
    input: Signal,
    window_length_samples: int,
    mode: TransferFunctionType = TransferFunctionType.H2,
) -> Spectrum:
    """H1/H2/H3 estimators with coherence, batched over channels
    (`transfer_functions.py:419-539`). All Welch estimates run in one
    device batch instead of the reference's per-channel loop."""
    assert input.sampling_rate_hz == output.sampling_rate_hz, (
        "Sampling rates do not match"
    )
    assert input.time_data_jax.shape[0] == output.time_data_jax.shape[0], (
        "Signal lengths do not match"
    )
    if input.number_of_channels != 1:
        assert input.number_of_channels == output.number_of_channels, (
            "Channel number does not match between signals"
        )
    p = input._spectrum_parameters.copy()
    kwargs = dict(
        sampling_rate_hz=input.sampling_rate_hz,
        window_length_samples=window_length_samples,
        window_type=p["window_type"],
        overlap_percent=p["overlap_percent"],
        detrend=p["detrend"],
        average=p["average"],
        scaling=p["scaling"],
    )
    x = input.time_data_jax.T  # (Cin, T)
    y = output.time_data_jax.T  # (C, T)
    if input.number_of_channels == 1 and output.number_of_channels > 1:
        x = jnp.repeat(x, output.number_of_channels, axis=0)

    def _estimate(x_in, y_in):
        G_xx = welch(x_in, None, **kwargs)
        G_yy = welch(y_in, None, **kwargs)
        G_xy = welch(x_in, y_in, **kwargs)
        if mode == TransferFunctionType.H1:
            tf = G_xy / G_xx
        elif mode == TransferFunctionType.H2:
            G_yx = welch(y_in, x_in, **kwargs)
            tf = G_yy / G_yx
        elif mode == TransferFunctionType.H3:
            tf = G_xy / jnp.abs(G_xy) * (G_yy / G_xx) ** 0.5
        else:
            raise ValueError("Unsupported transfer function type")
        coherence = jnp.abs(G_xy) ** 2 / G_xx / G_yy
        return tf.T, coherence.T.real

    from .._config import run_jitted_complex

    tf_t, coherence_t = run_jitted_complex(_estimate, x, y)
    spec = Spectrum(
        np.fft.rfftfreq(window_length_samples, 1 / input.sampling_rate_hz),
        np.asarray(tf_t),
    )
    spec.set_coherence(np.asarray(coherence_t))
    return spec


def average_irs(
    signal: ImpulseResponse,
    time_average: bool = True,
    normalize_energy: bool = True,
) -> ImpulseResponse:
    """Channel averaging in time (latency-aligned) or magnitude/phase
    (`transfer_functions.py:542-613`)."""
    assert isinstance(signal, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    assert signal.number_of_channels > 1, (
        "Signal has only one channel so no meaningful averaging can be done"
    )
    avg_sig = signal.copy()
    td = signal.time_data
    if normalize_energy:
        energies = np.sum(td**2, axis=0)
        energies = energies / energies[0]
        td = td * energies
        avg_sig.time_data = td

    if not time_average:
        _, sp = signal.get_spectrum()
        sp = np.asarray(sp)
        mag = np.abs(sp)
        pha = np.unwrap(np.angle(sp), axis=0)
        new_sp = np.mean(mag, axis=1) * np.exp(1j * np.mean(pha, axis=1))
        new_time_data = np.fft.irfft(
            new_sp[..., None], n=signal.length_samples, axis=0
        )
    else:
        from ..standard.latency_delay import fractional_delay

        latencies = find_ir_latency(signal)
        channel_to_follow = int(np.argmax(latencies))
        # writable copy: the time_data getter returns a read-only host view
        # of the device array
        td = np.array(avg_sig.time_data)
        for i in range(signal.number_of_channels):
            if channel_to_follow == i:
                continue
            latency_s = (
                latencies[channel_to_follow] - latencies[i]
            ) / signal.sampling_rate_hz
            new_channel = fractional_delay(
                signal.get_channels(i), latency_s, keep_length=True
            )
            td[:, i] = new_channel.time_data[:, 0]
        new_time_data = np.mean(td, axis=1)
    avg_sig.time_data = new_time_data
    return avg_sig


def min_phase_from_mag(
    spectrum: Spectrum,
    sampling_rate_hz: int,
    ir_length_samples: int | None = None,
) -> ImpulseResponse:
    """Minimum-phase IR from a magnitude spectrum
    (`transfer_functions.py:615-664`)."""
    delta_f_hz = (
        0.5
        if ir_length_samples is None
        else sampling_rate_hz / ir_length_samples
    )
    f_vec, delta_f_hz, original_length = (
        bk.frequency_vector_with_frequency_resolution(
            delta_f_hz, sampling_rate_hz
        )
    )
    mag = spectrum.get_interpolated_spectrum(f_vec, SpectrumType.Magnitude)
    from .._config import run_jitted_complex

    def _min_phase_ir(mag_in):
        phase = minimum_phase_from_magnitude(
            mag_in, False, True, original_length % 2 == 1
        )
        return jnp.fft.irfft(
            mag_in * jnp.exp(1j * phase), axis=0, n=original_length
        )

    time_data = run_jitted_complex(_min_phase_ir, np.asarray(mag))
    return ImpulseResponse.from_time_data(
        np.asarray(time_data), sampling_rate_hz
    )


def lin_phase_from_mag(
    spectrum: Spectrum,
    sampling_rate_hz: int,
    group_delay_ms: float | None = None,
    check_causality: bool = True,
    minimum_group_delay_factor: float = 1.0,
) -> ImpulseResponse:
    """Linear-phase IR from a magnitude spectrum
    (`transfer_functions.py:666-788`)."""
    minimum_group_delay = group_delay_ms is None
    check_causality = not minimum_group_delay and check_causality
    if not minimum_group_delay:
        group_delay_s = group_delay_ms / 1000.0
        delta_f_hz = 1.0 / (group_delay_s * 2.0) * 0.9
    else:
        delta_f_hz = 0.5
    f_vec, delta_f_hz, original_length = (
        bk.frequency_vector_with_frequency_resolution(
            delta_f_hz, sampling_rate_hz
        )
    )
    mag = spectrum.get_interpolated_spectrum(f_vec, SpectrumType.Magnitude)

    if check_causality or minimum_group_delay:
        assert minimum_group_delay_factor >= 1.0, (
            "Minimum group delay factor should at least be 1"
        )
        min_phase = minimum_phase_from_magnitude(
            mag, odd_length=original_length % 2 == 1
        )
        min_gd = group_delay_direct(min_phase, delta_f_hz)
        group_delay_to_use_s = np.asarray(
            minimum_group_delay_factor * (jnp.max(min_gd, axis=0) + 1e-3)
        )
        if check_causality:
            for n in range(len(group_delay_to_use_s)):
                assert group_delay_to_use_s[n] <= group_delay_s, (
                    f"Given group delay {group_delay_s * 1000} ms is lower "
                    "than minimal group delay "
                    f"{group_delay_to_use_s * 1000} ms for channel {n}"
                )
            group_delay_to_use_s = (
                np.ones(spectrum.number_of_channels) * group_delay_s
            )
        if np.any(
            group_delay_to_use_s * 2 > original_length / sampling_rate_hz
        ):
            delta_f_hz = 1.0 / (max(group_delay_to_use_s) * 2) * 0.9
            f_vec, delta_f_hz, original_length = (
                bk.frequency_vector_with_frequency_resolution(
                    delta_f_hz, sampling_rate_hz
                )
            )
            mag = spectrum.get_interpolated_spectrum(
                f_vec, SpectrumType.Magnitude
            )
    else:
        group_delay_to_use_s = (
            np.ones(spectrum.number_of_channels) * group_delay_s
        )

    from .._config import run_jitted_complex

    raw_phase = -2 * np.pi * f_vec[:, None] * group_delay_to_use_s[None, :]
    target_length = int(
        2 * max(group_delay_to_use_s) * sampling_rate_hz + 0.5
    )

    def _linphase_ir(mag_in, phase_in):
        # one program: the complex spectrum never exists eagerly
        phase = correct_for_real_phase_spectrum(phase_in)
        td = jnp.fft.irfft(
            mag_in * jnp.exp(1j * phase), axis=0, n=original_length
        )
        return pad_trim_axis(td, target_length, axis=0)

    time_data = run_jitted_complex(_linphase_ir, mag, raw_phase)
    return ImpulseResponse.from_time_data(
        np.asarray(time_data), sampling_rate_hz
    )


def min_phase_ir(
    sig: ImpulseResponse,
    use_real_cepstrum: bool = True,
    padding_factor: int = 8,
    alpha: float = 1.0,
) -> ImpulseResponse:
    """Minimum-phase version of an IR (`transfer_functions.py:789-859`)."""
    assert isinstance(sig, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    assert padding_factor >= 1, "Padding factor should be at least 1"
    assert 0.0 < alpha <= 1.0, "Alpha must be in the range ]0, 1]"
    new_time_data = jnp.asarray(sig.time_data)
    T = new_time_data.shape[0]
    if alpha != 1.0:
        scale = jnp.asarray(alpha ** np.arange(T))[:, None]
        new_time_data = new_time_data * scale
    if use_real_cepstrum:
        out = min_phase_ir_from_real_cepstrum(
            new_time_data.T, padding_factor
        ).T
    else:
        from scipy.fft import next_fast_len
        from scipy.signal import minimum_phase as min_phase_scipy

        td = np.asarray(new_time_data)
        length_fft = next_fast_len(max(T * padding_factor, T), False)
        out_np = td.copy()
        for ch in range(td.shape[1]):
            out_np[:, ch] = min_phase_scipy(
                sig.time_data[:, ch], method="hilbert", n_fft=length_fft
            )[:T]
        out = jnp.asarray(out_np)
    if alpha != 1.0:
        out = out[:T] * jnp.asarray(alpha ** (-np.arange(T)))[:, None]
    return sig.copy_with_new_time_data(np.asarray(out[:T]))


def group_delay(
    signal: Signal,
    analytic_computation: bool = True,
    smoothing: int = 0,
    remove_ir_latency: bool = False,
):
    """Group delay per channel (`transfer_functions.py:861-931`)."""
    from scipy.fft import next_fast_len

    from ..classes.filter_helpers import group_delay_filter

    length = (
        next_fast_len(signal.time_data_jax.shape[0] * 8, True)
        if remove_ir_latency
        else signal.time_data_jax.shape[0]
    )
    td = np.asarray(
        pad_trim_axis(signal.time_data_jax, length, axis=0)
    )
    f = np.fft.rfftfreq(td.shape[0], 1 / signal.sampling_rate_hz)
    if not analytic_computation:
        sp = np.fft.rfft(td, axis=0)
        ph = np.angle(sp)
        if remove_ir_latency:
            assert isinstance(signal, ImpulseResponse), (
                "This is only valid for an impulse response"
            )
            from ..helpers.latency import (
                fractional_latency,
                remove_ir_latency_from_phase,
            )

            min_ir = np.asarray(
                min_phase_ir_from_real_cepstrum(
                    jnp.asarray(signal.time_data.T), 1
                )
            ).T
            lat = fractional_latency(signal.time_data, min_ir, 1)
            ph = np.asarray(
                remove_ir_latency_from_phase(
                    f, jnp.asarray(ph), lat, signal.sampling_rate_hz
                )
            )
        group_delays = np.asarray(
            group_delay_direct(jnp.asarray(ph), f[1] - f[0])
        )
    else:
        group_delays = np.zeros((length // 2 + 1, td.shape[1]))
        for n in range(td.shape[1]):
            b = td[:, n]
            if remove_ir_latency:
                b = b[max(int(np.argmax(np.abs(b))) - 1, 0) :]
            _, group_delays[:, n] = group_delay_filter(
                [b, [1]], len(f), signal.sampling_rate_hz
            )
    if smoothing != 0:
        group_delays = np.asarray(
            fractional_octave_smoothing(
                jnp.asarray(group_delays), None, smoothing
            )
        )
    return f, group_delays


def minimum_phase(
    signal: ImpulseResponse,
    use_real_cepstrum: bool = True,
    padding_factor: int = 8,
):
    """Minimum phase response per channel
    (`transfer_functions.py:933-988`)."""
    assert isinstance(signal, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    if not use_real_cepstrum:
        from scipy.signal import minimum_phase as min_phase_scipy

        f = np.fft.rfftfreq(
            signal.time_data_jax.shape[0], d=1 / signal.sampling_rate_hz
        )
        min_phases = np.zeros((len(f), signal.number_of_channels))
        for n in range(signal.number_of_channels):
            temp = min_phase_scipy(
                signal.time_data[:, n],
                method="hilbert",
                n_fft=padding_factor * len(signal),
            )
            temp = np.asarray(
                pad_trim_axis(
                    jnp.asarray(temp), signal.time_data_jax.shape[0], axis=0
                )
            )
            min_phases[:, n] = np.angle(np.fft.rfft(temp))
        return f, min_phases
    from .._config import run_jitted_complex

    sp = run_jitted_complex(
        lambda td: minimum_phase_spectrum_from_real_cepstrum(
            td.T, padding_factor
        ).T,
        signal.time_data,
    )
    f = np.fft.fftfreq(sp.shape[0], 1 / signal.sampling_rate_hz)
    if sp.shape[0] % 2 == 0:
        f[sp.shape[0] // 2] *= -1
    inds = f >= 0
    return f[inds], np.angle(sp[inds, ...])


def minimum_group_delay(
    signal: ImpulseResponse, smoothing: int = 0, padding_factor: int = 8
):
    """Minimum group delay (`transfer_functions.py:990-1027`)."""
    f, min_phases = minimum_phase(signal, padding_factor=padding_factor)
    min_gd = np.asarray(
        group_delay_direct(jnp.asarray(min_phases), f[1] - f[0])
    )
    if smoothing != 0:
        min_gd = np.asarray(
            fractional_octave_smoothing(jnp.asarray(min_gd), None, smoothing)
        )
    return f, min_gd


def excess_group_delay(
    signal: ImpulseResponse,
    smoothing: int = 0,
    remove_ir_latency: bool = False,
    analytic_computation: bool = False,
):
    """Excess group delay (`transfer_functions.py:1029-1084`)."""
    f_min, min_gd = minimum_group_delay(signal, smoothing=0, padding_factor=1)
    f, gd = group_delay(
        signal,
        smoothing=0,
        analytic_computation=analytic_computation,
        remove_ir_latency=remove_ir_latency,
    )
    if len(f) != len(f_min):
        gd = np.asarray(
            interpolate_fr(f, jnp.asarray(gd), f_min, None, "linear")
        )
    ex_gd = gd - min_gd
    if smoothing != 0:
        ex_gd = np.asarray(
            fractional_octave_smoothing(jnp.asarray(ex_gd), None, smoothing)
        )
    return f_min, ex_gd


def combine_ir_with_dirac(
    ir: ImpulseResponse,
    crossover_frequency: float,
    take_lower_band: bool,
    order: int = 8,
    normalization: str | float | None = None,
) -> ImpulseResponse:
    """Crossover-merged IR + perfect impulse
    (`transfer_functions.py:1086-1191`)."""
    from ..filterbanks import linkwitz_riley_crossovers
    from ..generators import dirac
    from ..standard.gain_and_level import normalize
    from ..standard.latency_delay import fractional_delay

    assert isinstance(ir, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    if normalization is not None and isinstance(normalization, str):
        normalization = normalization.lower()
        assert normalization in ("energy", "peak"), (
            "Invalid normalization parameter"
        )
    ir = normalize(ir, 0.0)
    latencies_samples = get_fractional_impulse_peak_index(ir.time_data)

    imp = dirac(
        len(ir.time_data),
        delay_samples=0,
        number_of_channels=1,
        sampling_rate_hz=ir.sampling_rate_hz,
    )
    polarity = np.ones(ir.number_of_channels)
    imp_channels = []
    for ch in range(ir.number_of_channels):
        delay_seconds = latencies_samples[ch] / ir.sampling_rate_hz
        imp_ch = fractional_delay(
            imp.get_channels(0), delay_seconds, keep_length=True
        )
        imp_channels.append(imp_ch.time_data[:, 0])
        polarity[ch] *= np.sign(
            ir.time_data[int(latencies_samples[ch] + 0.5), ch]
        )
    imp = ImpulseResponse.from_time_data(
        np.stack(imp_channels, axis=1), ir.sampling_rate_hz
    )

    fb = linkwitz_riley_crossovers(
        [crossover_frequency], order, ir.sampling_rate_hz
    )
    ir_multi = fb.filter_signal(ir, zero_phase=True)
    imp_multi = fb.filter_signal(imp, zero_phase=True)
    band_ir, band_imp = (0, 1) if take_lower_band else (1, 0)
    td_ir = ir_multi.bands[band_ir].time_data
    td_imp = imp_multi.bands[band_imp].time_data
    if normalization == "energy":
        td_imp = td_imp * (
            np.sqrt(np.mean(td_ir**2, axis=0))
            / np.sqrt(np.mean(td_imp**2, axis=0))
        )
    elif normalization == "peak":
        td_imp = td_imp * (
            np.max(np.abs(td_ir), axis=0) / np.max(np.abs(td_imp), axis=0)
        )
    elif isinstance(normalization, (float, int, np.floating, np.integer)):
        td_imp = td_imp * np.asarray(from_db(normalization, True))
    combined = ir.copy_with_new_time_data(
        td_ir + td_imp * polarity[None, ...]
    )
    return normalize(combined, 0.0)


def ir_to_filter(
    signal: ImpulseResponse,
    channel: int | None = 0,
    phase_mode: str = "direct",
):
    """IR → FIR Filter / FilterBank (`transfer_functions.py:1193-1250`)."""
    assert isinstance(signal, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    phase_mode = phase_mode.lower()
    assert phase_mode in ("direct", "min", "lin"), (
        f"{phase_mode} is not valid. Choose from ('direct', 'min', 'lin')"
    )
    signal = signal.get_channels(channel) if channel is not None else signal
    if phase_mode == "min":
        signal = min_phase_from_mag(
            Spectrum.from_signal(signal), signal.sampling_rate_hz, len(signal)
        )
    elif phase_mode == "lin":
        signal = lin_phase_from_mag(
            Spectrum.from_signal(signal), signal.sampling_rate_hz
        )
    filters = []
    for ch in range(signal.number_of_channels):
        filt = Filter.from_ba(
            signal.time_data[:, ch], [1.0], signal.sampling_rate_hz
        )
        if channel is not None:
            return filt
        filters.append(filt)
    return FilterBank(filters)


def filter_to_ir(fir) -> ImpulseResponse:
    """FIR Filter / FilterBank → IR (`transfer_functions.py:1252-1286`)."""
    if isinstance(fir, Filter):
        assert not fir.is_iir, "This is only valid for FIR filters"
        return ImpulseResponse.from_time_data(
            fir.ba[0].copy(), sampling_rate_hz=fir.sampling_rate_hz
        )
    if isinstance(fir, FilterBank):
        assert all(not f.is_iir for f in fir), "Filter types must be fir"
        assert fir.same_sampling_rate, (
            "Only valid for filter banks with consistent sampling rate"
        )
        length = max(len(f) for f in fir)
        td = np.zeros((length, len(fir)))
        for ind, f in enumerate(fir):
            td[: len(f), ind] = f.ba[0].copy()
        return ImpulseResponse.from_time_data(td, fir.sampling_rate_hz)
    raise TypeError("Unsupported type")


def window_frequency_dependent(
    ir: ImpulseResponse,
    cycles: int,
    end_window_value_db: float = -50.0,
) -> Spectrum:
    """Frequency-dependent Gaussian windowing
    (`transfer_functions.py:1288-1378`; numba kernel #2 → chunked einsum,
    see `_backend.fdw_core`)."""
    assert isinstance(ir, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    assert end_window_value_db < 0.0, "Window ends must be less than 0 dB"
    end_window_value = float(from_db(end_window_value_db, True))
    fs = ir.sampling_rate_hz
    T = ir.length_samples
    f = np.fft.rfftfreq(T, 1 / fs)[1:]
    cycles_per_freq = np.round(fs / f * cycles).astype(int)
    half = (T - 1) / 2
    alpha_factor = np.log(1 / end_window_value**2) ** 0.5 * half
    alpha = (alpha_factor / cycles_per_freq) ** 2.0
    ind_max = np.argmax(np.abs(ir.time_data), axis=0)
    freqs_normalized = f * (T / fs)
    from .._config import run_jitted_complex

    spec = run_jitted_complex(
        lambda td: bk.fdw_core(td, freqs_normalized, alpha, ind_max),
        ir.time_data,
    )
    spec = np.asarray(spec)
    return Spectrum(np.hstack([0.0, f]), np.pad(spec, ((1, 0), (0, 0))))


def find_ir_latency(
    ir: ImpulseResponse, compare_to_min_phase_ir: bool = True
) -> np.ndarray:
    """Sub-sample IR latency (`transfer_functions.py:1380-1407`)."""
    assert isinstance(ir, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    if compare_to_min_phase_ir:
        from ..helpers.latency import fractional_latency

        min_ir = min_phase_ir(ir)
        return fractional_latency(ir.time_data, min_ir.time_data, 1)
    return get_fractional_impulse_peak_index(ir.time_data, 1)


def harmonics_from_chirp_ir(
    ir: ImpulseResponse,
    chirp_range_hz,
    chirp_length_s: float,
    n_harmonics: int = 5,
    offset_percentage: float = 0.05,
) -> list:
    """Farina harmonic IR extraction (`transfer_functions.py:1409-1485`)."""
    assert isinstance(ir, ImpulseResponse), (
        "This is only valid for an impulse response"
    )
    assert 0 <= offset_percentage < 1, "Offset must be smaller than one"
    assert ir.number_of_channels == 1, (
        "Only an IR with a single channel is supported"
    )
    td = ir.time_data
    offsets = -np.argmax(np.abs(td), axis=0) + 1
    td = np.roll(td, offsets, axis=0)
    ts = bk.get_harmonic_times(
        chirp_range_hz, chirp_length_s, n_harmonics + 1
    )
    time_harm = len(td) + (ts * ir.sampling_rate_hz + 0.5).astype(int)
    time_harm = np.insert(time_harm, 0, len(td))
    ir_dummy = ir.copy_with_new_time_data(ir.time_data[:10])
    harmonics = []
    for nh in range(n_harmonics):
        max_ind = int(
            time_harm[nh]
            - (time_harm[nh] - time_harm[nh + 1]) * offset_percentage
        )
        min_ind = int(
            time_harm[nh + 1]
            - (time_harm[nh + 1] - time_harm[nh + 2]) * offset_percentage
        )
        harmonics.append(
            ir_dummy.copy_with_new_time_data(td[min_ind:max_ind, 0])
        )
    return harmonics


def harmonic_distortion_analysis(
    ir,
    chirp_range_hz=None,
    chirp_length_s: float | None = None,
    n_harmonics: int | None = 8,
    smoothing: int = 12,
    generate_plot: bool = True,
) -> dict:
    """THD / THD+N analysis from an exponential-chirp IR
    (`transfer_functions.py:1487-1693`)."""
    if isinstance(ir, list):
        for each_ir in ir:
            assert isinstance(each_ir, ImpulseResponse), "Unsupported type"
            assert each_ir.number_of_channels == 1, (
                "Only single-channel IRs are supported"
            )
        ir2 = ir.pop(0)
        ir2._spectrum_parameters["smoothing"] = smoothing
        harm = ir
        n_harmonics = len(harm)
        if chirp_range_hz is None:
            chirp_range_hz = [0, ir2.sampling_rate_hz // 2]
        passed_harmonics = True
    elif isinstance(ir, ImpulseResponse):
        assert (
            chirp_length_s is not None
            and chirp_range_hz is not None
            and n_harmonics is not None
        ), "Chirp parameters and number of harmonics cannot be None"
        harm = harmonics_from_chirp_ir(
            ir, chirp_range_hz, chirp_length_s, n_harmonics, 0.01
        )
        ir2 = ir.copy()
        start, stop, _ = bk.trim_ir_indices(
            ir2.time_data[:, 0], ir.sampling_rate_hz, 10e-3
        )
        ir2.time_data = ir2.time_data[start:stop]
        ir2 = window_ir(ir2, len(ir2), constant_percentage=0.9)[0]
        ir2._spectrum_parameters["smoothing"] = smoothing
        passed_harmonics = False
    else:
        raise TypeError("Type for ir is not supported")

    pad_length = max(ir2.sampling_rate_hz // 5, len(ir2)) - len(ir2)
    ir2.time_data = np.pad(ir2.time_data, ((0, pad_length), (0, 0)))

    thd = np.zeros(int(np.sum([len(h) for h in harm])))
    pos_thd = len(thd)
    d: dict = {}
    quadratic = not ir2.spectrum_scaling.is_amplitude_scaling()
    freqs, base_spectrum = ir2.get_spectrum()
    base_spectrum = np.asarray(base_spectrum)
    d["1"] = Spectrum(
        freqs, base_spectrum**0.5 if quadratic else base_spectrum
    )
    sp_thd = np.zeros(len(freqs))
    if generate_plot:
        fig, ax = ir2.plot_magnitude(
            smoothing=smoothing,
            normalize=MagnitudeNormalization.NoNormalization,
        )
    for i in range(len(harm)):
        if not passed_harmonics:
            harm[i] = window_ir(
                harm[i], len(harm[i]), constant_percentage=0.9
            )[0]
        harm[i].set_spectrum_parameters(**ir2._spectrum_parameters)
        f, sp = harm[i].get_spectrum()
        sp = np.asarray(sp)
        inds = f < chirp_range_hz[-1]
        f = f[inds] / (i + 2)
        sp = sp[inds]
        sp_power = (
            sp.squeeze().real if quadratic else np.abs(sp.squeeze()) ** 2
        )
        d[f"{i + 2}"] = Spectrum(f, sp**0.5 if quadratic else sp)
        if generate_plot:
            ax.plot(f, np.asarray(to_db(jnp.asarray(sp_power), False)))
        thd[pos_thd - len(harm[i]) : pos_thd] = harm[i].time_data.squeeze()
        pos_thd -= len(harm[i])
        sp_thd += np.interp(freqs, f, sp_power, left=0.0, right=0.0)

    ind_end = int(np.argmin(np.abs(freqs - chirp_range_hz[-1] / 2)))
    sp_thd = sp_thd[:ind_end]
    freqs_thd = freqs[:ind_end]
    thd_n = Signal(None, thd, ir2.sampling_rate_hz)
    thd_n.set_spectrum_parameters(**ir2._spectrum_parameters)
    f_thd_n, sp_thd_n = thd_n.get_spectrum()
    sp_thd_n = np.asarray(sp_thd_n)
    if not quadratic:
        sp_thd_n = np.abs(sp_thd_n) ** 2.0
    if generate_plot:
        plot_thd = sp_thd.copy()
        plot_thd[plot_thd == 0] = np.nan
        ax.plot(
            freqs_thd, np.asarray(to_db(jnp.asarray(plot_thd), False))
        )
        ax.plot(f_thd_n, np.asarray(to_db(jnp.asarray(sp_thd_n), False)))
        ax.legend(
            ["Fundamental"]
            + [f"{i + 2} Harmonic" for i in range(n_harmonics)]
            + ["THD", "THD+N"]
        )
        d["plot"] = [fig, ax]
    d["thd_n"] = Spectrum(f_thd_n, np.real(sp_thd_n) ** 0.5)
    d["thd"] = Spectrum(freqs_thd, sp_thd**0.5)
    d["thd_percent"] = Spectrum(
        d["thd"].frequency_vector_hz,
        np.asarray(d["thd"].spectral_data)
        / np.asarray(
            d["1"].get_interpolated_spectrum(
                d["thd"].frequency_vector_hz, SpectrumType.Magnitude
            )
        )
        * 100.0,
    )
    return d


def trim_ir(
    ir: ImpulseResponse,
    channel: int | None = None,
    start_offset_s: float | None = 20e-3,
):
    """Smart start/stop IR trimming (`transfer_functions.py:1695-1786`)."""
    start_offset_s = (
        len(ir) / ir.sampling_rate_hz
        if start_offset_s is None
        else start_offset_s
    )
    assert start_offset_s >= 0, "Offset must be at least 0"
    if channel is not None:
        trimmed = ir.get_channels(channel)
        td = trimmed.time_data.squeeze()
        start, stop, _ = bk.trim_ir_indices(
            td, ir.sampling_rate_hz, start_offset_s
        )
        trimmed.time_data = td[start:stop]
        return trimmed, start, stop
    starts = np.zeros(ir.number_of_channels, dtype=int)
    stops = starts.copy()
    for ch in range(ir.number_of_channels):
        starts[ch], stops[ch], _ = bk.trim_ir_indices(
            ir.time_data[:, ch], ir.sampling_rate_hz, start_offset_s
        )
    start = int(np.min(starts))
    stop = int(np.max(stops))
    return (
        ir.copy_with_new_time_data(ir.time_data[start:stop, ...]),
        start,
        stop,
    )


def complex_smoothing(
    ir: ImpulseResponse,
    octave_fraction: float,
    smoothing_domain: SmoothingDomain,
    window: Window = Window.Hann,
) -> Spectrum:
    """Complex smoothing in the selected domain
    (`transfer_functions.py:1788-1876`; numba kernel #1 → device kernels:
    a cached dense-operator matmul for short spectra, the O(F·W) banded
    product for long ones — see `_backend.complex_smoothing_core`).
    Everything runs in one jitted device program; there is no host
    compute path."""
    assert octave_fraction > 0.0, "Octave fraction must be greater than 0"
    f, sp_host = ir.get_spectrum()
    window_values = window(3000, True)
    # the banded weights enter the program as arguments, not constants
    operands = (
        bk.banded_smoothing_operands(f, octave_fraction, window_values)
        if len(f) > bk.DENSE_SMOOTHING_MAX_BINS
        else ()
    )

    def _smooth_all(sp, *operands):
        xp = jnp

        def smooth(x):
            return bk.complex_smoothing_core(
                x, f, octave_fraction, window_values, operands or None
            )

        if smoothing_domain == SmoothingDomain.RealImaginary:
            return smooth(sp)
        if smoothing_domain == SmoothingDomain.MagnitudePhase:
            s = smooth(
                xp.abs(sp) + 1j * xp.unwrap(xp.angle(sp), axis=0)
            )
            return xp.real(s) * xp.exp(1j * xp.imag(s))
        if smoothing_domain == SmoothingDomain.PowerPhase:
            s = smooth(
                xp.abs(sp) ** 2.0
                + 1j * xp.unwrap(xp.angle(sp), axis=0)
            )
            return xp.real(s) ** 0.5 * xp.exp(1j * xp.imag(s))
        if smoothing_domain == SmoothingDomain.Power:
            s = smooth(xp.abs(sp) ** 2.0)
            return s**0.5 * xp.exp(1j * xp.angle(sp))
        if smoothing_domain == SmoothingDomain.Magnitude:
            s = smooth(xp.abs(sp))
            return s * xp.exp(1j * xp.angle(sp))
        if smoothing_domain == SmoothingDomain.EquivalentComplex:
            s1 = smooth(sp)
            s2 = smooth(xp.abs(sp) ** 2.0)
            return xp.real(s2) ** 0.5 * xp.exp(1j * xp.angle(s1))
        raise ValueError("Invalid smoothing domain")

    from .._config import run_jitted_complex

    out = run_jitted_complex(_smooth_all, np.asarray(sp_host), *operands)
    return Spectrum(f, np.asarray(out))
