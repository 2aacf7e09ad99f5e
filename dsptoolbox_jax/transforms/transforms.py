"""Special transforms: cepstrum, mel/MFCC, ISTFT, chroma, CWT/VQT, hilbert,
warping, Laguerre, LPC, arbitrary DFT.

Behavioral reference: `dsptoolbox/transforms/transforms.py`. The matmul-shaped
transforms (mel projection, chroma/pitch folding, DCT, arbitrary DFT) run as
matmuls; framed synthesis/analysis uses the device framing kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..classes import (
    Filter,
    FilterBank,
    ImpulseResponse,
    MultiBandSignal,
    Signal,
    Spectrum,
)
from ..helpers.ar_estimation import burg_ar, yule_walker_ar
from ..helpers.frequency_conversion import hz2mel, mel2hz
from ..helpers.gain_and_level import to_db
from ..ops.fft_conv import fft_convolve, resample_poly
from ..ops.framing import frame_signal, reconstruct_framed_signal
from ..ops.pad_trim import pad_trim_axis
from ..plots import general_matrix_plot
from ..standard.enums import (
    FilterBankMode,
    FilterCoefficientsType,
    FilterPassType,
    Window,
)
from ._backend import (
    MorletWavelet,
    Wavelet,
    dft_core,
    get_kernels_vqt,
    get_warping_factor,
    pitch2frequency,
    _squeeze_core,
    squeeze_scalogram,
    warp_time_series,
)

__all__ = [
    "cepstrum",
    "from_complex_cepstrum",
    "log_mel_spectrogram",
    "mel_filterbank",
    "plot_waterfall",
    "mfcc",
    "istft",
    "chroma_stft",
    "cwt",
    "hilbert",
    "vqt",
    "stereo_mid_side",
    "laguerre",
    "warp",
    "warp_filter",
    "lpc",
    "dft",
    "spectrum_via_filterbank",
    "Wavelet",
    "MorletWavelet",
]


def cepstrum(signal: Signal, complex: bool = True):
    """Complex or real cepstrum (`transforms.py:59-87`)."""
    from .._config import run_jitted_complex

    def _cep(td):
        sp = jnp.fft.fft(td, axis=0)
        if complex:
            return jnp.fft.ifft(jnp.log(sp), axis=0)
        return jnp.fft.ifft(jnp.log(jnp.abs(sp)), axis=0)

    return np.asarray(run_jitted_complex(_cep, signal.time_data))


def from_complex_cepstrum(cepstrum, sampling_rate_hz: int) -> Signal:
    """Inverse of the complex cepstrum (`transforms.py:89-111`)."""
    from .._config import run_jitted_complex

    td = run_jitted_complex(
        lambda c: jnp.fft.ifft(
            jnp.exp(jnp.fft.fft(c, axis=0)), axis=0
        ).real,
        np.asarray(cepstrum),
    )
    return Signal.from_time_data(np.asarray(td), sampling_rate_hz)


def mel_filterbank(
    f_hz: np.ndarray,
    range_hz=None,
    n_bands: int = 40,
    normalize: bool = True,
):
    """Triangular Hz→mel projection matrix (static;
    `transforms.py:198-279`)."""
    f_hz = np.squeeze(f_hz)
    assert f_hz.ndim == 1, "f_hz should be a 1D-array"
    n_bands = int(n_bands)
    if range_hz is None:
        range_hz = f_hz[[0, -1]]
    else:
        range_hz = np.atleast_1d(np.asarray(range_hz).squeeze())
        assert len(range_hz) == 2, (
            "range_hz should be an array with exactly two values!"
        )
        range_hz = np.sort(range_hz)
        assert range_hz[-1] <= f_hz[-1], (
            f"Upper frequency in range {range_hz[-1]} is bigger than "
            f"nyquist frequency {f_hz[-1]}"
        )
        assert range_hz[0] >= 0, "Lower frequency in range must be positive"
    range_mel = hz2mel(range_hz)
    mel_center_freqs = np.linspace(
        range_mel[0], range_mel[1], n_bands + 2, endpoint=True
    )
    bands_hz = mel2hz(mel_center_freqs)
    inds = np.array(
        [np.argmin(np.abs(b - f_hz)) for b in bands_hz], dtype=int
    )
    mel_filters = np.zeros((n_bands, len(f_hz)))
    for n in range(n_bands):
        ni = n + 1
        mel_filters[n, inds[ni - 1] : inds[ni]] = np.linspace(
            0, 1, inds[ni] - inds[ni - 1], endpoint=False
        )
        mel_filters[n, inds[ni] : inds[ni + 1]] = np.linspace(
            1, 0, inds[ni + 1] - inds[ni], endpoint=False
        )
        if normalize and mel_filters[n].sum() > 0:
            mel_filters[n, :] /= np.sum(mel_filters[n, :])
    return mel_filters, mel_center_freqs[1:-1]


def log_mel_spectrogram(
    s: Signal,
    channel: int = 0,
    range_hz=None,
    n_bands: int = 40,
    generate_plot: bool = True,
    stft_parameters: dict | None = None,
):
    """Log-mel spectrogram via a matmul projection of the power STFT
    (`transforms.py:113-196`)."""
    if stft_parameters is not None:
        s.set_spectrogram_parameters(**stft_parameters)
    # device power spectrogram: the complex STFT never reaches the host
    time_s, f_hz, power = s._get_power_spectrogram_device()
    mfilt, f_mel = mel_filterbank(f_hz, range_hz, n_bands, normalize=True)
    log_mel_sp = jnp.tensordot(
        jnp.asarray(mfilt, power.dtype),
        power,
        axes=(-1, 0),
        precision=jax.lax.Precision.HIGHEST,
    )
    # fp32 power underflows to 0 where the f64 reference keeps a denormal;
    # floor at tiny to keep the log finite
    log_mel_sp = jnp.maximum(log_mel_sp, np.finfo(np.float32).tiny)
    log_mel_sp = np.asarray(to_db(log_mel_sp, False))
    if generate_plot:
        fig, ax = general_matrix_plot(
            log_mel_sp[..., channel],
            range_x=[time_s[0], time_s[-1]],
            range_y=[f_mel[0], f_mel[-1]],
            range_z=50,
            ylabel="Frequency / Mel",
            xlabel="Time / s",
            ylog=False,
        )
        return time_s, f_mel, log_mel_sp, fig, ax
    return time_s, f_mel, log_mel_sp


def plot_waterfall(
    sig: Signal,
    channel: int = 0,
    dynamic_range_db: float = 40,
    stft_parameters: dict | None = None,
):
    """3D waterfall plot of the STFT (`transforms.py:281-333`)."""
    import matplotlib.pyplot as plt

    assert dynamic_range_db > 0, "Dynamic range has to be more than 0"
    sig = sig.get_channels(channel)
    if stft_parameters is not None:
        sig.set_spectrogram_parameters(**stft_parameters)
    t, f, S = sig.get_spectrogram()
    amplitude_scaling = sig.spectrum_scaling.is_amplitude_scaling()
    fig, ax = plt.subplots(
        figsize=(10, 8), subplot_kw=dict(projection="3d")
    )
    tt, ff = np.meshgrid(t, f)
    ax.plot_surface(
        tt,
        ff,
        np.asarray(
            to_db(jnp.asarray(S[..., 0]), amplitude_scaling, dynamic_range_db)
        ),
        cmap="magma",
    )
    ax.set_xlabel("Time / s")
    ax.set_ylabel("Frequency / Hz")
    ax.set_zlabel("dB")
    fig.tight_layout()
    return fig, ax


def mfcc(
    signal: Signal,
    channel: int = 0,
    mel_filters: np.ndarray | None = None,
    generate_plot: bool = True,
    stft_parameters: dict | None = None,
):
    """Mel-frequency cepstral coefficients (mel projection + DCT-II as
    matmuls; `transforms.py:335-441`)."""
    if stft_parameters is not None:
        signal.set_spectrogram_parameters(**stft_parameters)
    # device power spectrogram: the complex STFT never reaches the host
    time_s, f, power = signal._get_power_spectrogram_device()
    if mel_filters is None:
        mel_filters, f_mel = mel_filterbank(f, None, n_bands=40)
    else:
        assert mel_filters.shape[1] == power.shape[0], (
            f"Shape of the mel filter matrix {mel_filters.shape} does "
            f"not match the STFT {power.shape}"
        )
        f_mel = np.array([0, mel_filters.shape[0]])
    from ..classes.signal import _dev_jit

    def _mfcc_core(mel_mat, power_in):
        mel_power = jnp.tensordot(
            mel_mat.astype(power_in.dtype),
            power_in,
            axes=(-1, 0),
            precision=jax.lax.Precision.HIGHEST,
        )
        # keep the log finite where fp32 power underflows to 0 (see
        # log_mel_spectrogram)
        mel_power = jnp.maximum(mel_power, np.finfo(np.float32).tiny)
        log_sp = to_db(mel_power, False)
        # DCT-II as a static matmul on the band axis
        n = mel_power.shape[0]
        k = np.arange(n)
        dct_mat = 2.0 * np.cos(
            np.pi * k[:, None] * (2 * k[None, :] + 1) / (2 * n)
        )
        return jnp.abs(
            jnp.tensordot(
                jnp.asarray(dct_mat, log_sp.dtype),
                log_sp,
                axes=(-1, 0),
                precision=jax.lax.Precision.HIGHEST,
            )
        )

    # one cached device program for mel projection + dB + DCT instead of
    # ~5 eager dispatches
    coeffs_dev = _dev_jit(
        "mfcc_core", lambda m, p: jnp.nan_to_num(_mfcc_core(m, p), nan=0.0)
    )(jnp.asarray(np.asarray(mel_filters, np.float32)), power)
    from .._config import lazy_host_returns

    if not generate_plot and lazy_host_returns():
        # feature-extraction pipelines consume the coefficient stack
        # downstream; defer the host fetch until someone reads it
        from ..classes.lazy_array import LazyHostArray

        return time_s, f_mel, LazyHostArray(coeffs_dev)
    coeffs = np.asarray(coeffs_dev)
    if generate_plot:
        fig, ax = general_matrix_plot(
            coeffs[..., channel],
            range_x=[time_s[0], time_s[-1]],
            range_y=[f_mel[0], f_mel[-1]],
            xlabel="Time / s",
            ylabel="Cepstral coefficients",
        )
        return time_s, f_mel, coeffs, fig, ax
    return time_s, f_mel, coeffs


def istft(
    stft: np.ndarray,
    original_signal: Signal | None = None,
    parameters: dict | None = None,
    sampling_rate_hz: int | None = None,
    window_length_samples: int | None = None,
    window_type=None,
    overlap_percent: int | None = None,
    fft_length_samples: int | None = None,
    padding: bool | None = None,
    scaling=None,
) -> Signal:
    """Inverse STFT with window² overlap-add (Griffin-Lim LSE;
    `transforms.py:444-588`). ``stft (F, frames, C)``."""
    from ..ops.windows import get_window as get_window_np

    assert stft.ndim == 3, (
        f"{stft.ndim} is not a valid number of dimensions. It must be 3"
    )
    if original_signal is not None:
        assert parameters is None, (
            "A signal was passed. No parameters dictionary should be passed"
        )
        parameters = original_signal._spectrogram_parameters.copy()
        sampling_rate_hz = original_signal.sampling_rate_hz
    elif parameters is not None:
        pass
    else:
        assert (
            (window_length_samples is not None)
            and (window_type is not None)
            and (overlap_percent is not None)
            and (padding is not None)
            and (scaling is not None)
        ), "At least one of the needed parameters needed was passed as None"
        parameters = {
            "window_length_samples": window_length_samples,
            "window_type": window_type,
            "overlap_percent": overlap_percent,
            "fft_length_samples": fft_length_samples,
            "padding": padding,
            "scaling": scaling,
        }

    window = get_window_np(
        parameters["window_type"],
        parameters["window_length_samples"],
        symmetric=False,
    )
    scaling_param = parameters["scaling"]

    def _istft_core(S):  # S (F, K, C) complex
        td_framed = jnp.fft.irfft(
            S,
            axis=0,
            n=parameters["fft_length_samples"],
            norm=scaling_param.fft_norm(),
        )
        td_framed = td_framed[: parameters["window_length_samples"], ...]
        if scaling_param.has_physical_units():
            td_framed = td_framed / scaling_param.get_scaling_factor(
                parameters["fft_length_samples"]
                or parameters["window_length_samples"],
                sampling_rate_hz,
                window,
            )
        step = int(
            (1 - parameters["overlap_percent"] / 100) * len(window)
        )
        # channels-first frames for the device kernel: (C, K, L)
        frames_cf = jnp.transpose(td_framed, (2, 1, 0))
        if parameters["padding"]:
            td = reconstruct_framed_signal(frames_cf, step, window)
            overlap = int(
                parameters["overlap_percent"] / 100 * len(window)
            )
            td = td[..., overlap:-overlap]
        else:
            extra = jnp.zeros_like(frames_cf[:, :1, :])
            frames_cf = jnp.concatenate(
                [extra, frames_cf, extra], axis=1
            )
            td = reconstruct_framed_signal(frames_cf, step, window)
            td = td[..., step:-step]
        return td

    from .._config import run_jitted_complex
    from ..classes.signal import DeviceSpectralData

    # one jitted program with real output: complex spectra never cross
    # the host boundary. The reconstructed
    # time data stays a device array end to end — transpose and length
    # trim run INSIDE the program (each eager op pays a dispatch launch)
    # and the returned Signal holds the result without a host round trip
    # (`_assign_device_time_data`).
    target_len = (
        int(original_signal.time_data_jax.shape[0])
        if original_signal is not None
        else None
    )

    def _finish(td_cf):
        td = td_cf.T
        if target_len is not None:
            td = pad_trim_axis(td, target_len, axis=0)
        return td

    from ..classes.lazy_array import LazyHostArray

    if isinstance(stft, LazyHostArray):
        # default-API chains: consume the device buffers directly (zero
        # host round trips). Once the user has materialized (and possibly
        # mutated) the host view, that buffer is the truth instead.
        if stft.is_materialized:
            stft = stft.numpy()
        elif stft.device_imag is not None:
            stft = DeviceSpectralData(stft.device_real, stft.device_imag)
        else:
            stft = stft.device_real
    _key = (
        "istft",
        sampling_rate_hz,
        target_len,
        tuple(sorted((k, str(v)) for k, v in parameters.items())),
    )
    if isinstance(stft, DeviceSpectralData):
        td = run_jitted_complex(
            lambda re, im: _finish(_istft_core(re + 1j * im)),
            stft.real,
            stft.imag,
            materialize=False,
            defer=True,
            key=("split",) + _key,
        )
    else:
        td = run_jitted_complex(
            lambda S: _finish(_istft_core(S)),
            stft,
            materialize=False,
            defer=True,
            key=("whole",) + _key,
        )
    if original_signal is not None:
        return original_signal.copy_with_new_time_data(td)
    return Signal(None, time_data=td, sampling_rate_hz=sampling_rate_hz)


def chroma_stft(
    signal: Signal,
    tuning_a_hz: float = 440,
    compression: float = 0.5,
    plot_channel: int = -1,
):
    """Chroma and pitch features via static folding matrices
    (`transforms.py:589-686`)."""
    import matplotlib.pyplot as plt

    assert tuning_a_hz > 0, "Tuning A4 must be greater than zero"
    assert compression > 0, "Compression factor must be greater than zero"
    # device power spectrogram: the complex STFT never reaches the host
    t, f, power = signal._get_power_spectrogram_device()
    if len(f) != power.shape[0]:
        # the reference derives the frequency vector from the WINDOW
        # length even when fft_length > window
        # (`_spectral_methods.py:281`), which crashes its own chroma
        # (upstream test_chroma fails in this state); use the true bin
        # grid of the actual FFT length instead
        f = np.fft.rfftfreq(
            (power.shape[0] - 1) * 2, 1 / signal.sampling_rate_hz
        )
    pitch_frequencies = pitch2frequency(tuning_a_hz)
    pitch_transformation = np.zeros((len(pitch_frequencies), len(f)))
    for ind, fn in enumerate(pitch_frequencies):
        inds = (f >= fn * 2 ** (-1 / 24)) & (f < fn * 2 ** (1 / 24))
        pitch_transformation[ind, inds] = 1
    n_notes = 12
    chroma_transformation = np.zeros((n_notes, len(pitch_frequencies)))
    for i in range(n_notes):
        chroma_transformation[i, i::n_notes] = 1
    pitch_stft = jnp.tensordot(
        jnp.asarray(pitch_transformation, power.dtype),
        power,
        (1, 0),
        precision=jax.lax.Precision.HIGHEST,
    )
    chroma = jnp.tensordot(
        jnp.asarray(chroma_transformation, power.dtype),
        pitch_stft,
        (1, 0),
        precision=jax.lax.Precision.HIGHEST,
    )
    pitch_stft = np.asarray(jnp.log(1 + compression * pitch_stft))
    chroma = np.asarray(jnp.log(1 + compression * chroma))
    if plot_channel != -1:
        fig, ax = plt.subplots(1, 1)
        image = ax.imshow(
            chroma[..., plot_channel], aspect="auto", origin="lower"
        )
        ax.set_yticks(
            np.arange(12),
            ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"],
        )
        time_step = int(1 / t[1]) if t[1] > 0 else 1
        ax.set_xticks(
            np.arange(0, chroma.shape[1], time_step),
            np.round(t[::time_step]),
        )
        ax.set_xlabel("Time / s")
        ax.set_ylabel("Note")
        fig.colorbar(image)
        return t, chroma, pitch_stft, fig, ax
    return t, chroma, pitch_stft


def cwt(
    signal: Signal,
    frequencies: np.ndarray,
    wavelet,
    channel=None,
    synchrosqueezed: bool = False,
    apply_synchrosqueezed_normalization: bool = False,
    return_device: bool = False,
):
    """Continuous wavelet transform: batched device convolution per scale
    (`transforms.py:687-761`).

    The whole pipeline (per-scale convolution and, when requested, the
    synchrosqueezing reassignment) runs as ONE jitted device program.
    With ``return_device=True`` the result is a
    :class:`~dsptoolbox_jax.classes.signal.DeviceSpectralData` that never
    leaves the device — the (F, T, C) host matrix is ~100 MB for seconds
    of audio. The default
    returns the host complex matrix (reference parity)."""
    from .._config import run_jitted_complex
    from ..classes.signal import DeviceSpectralData

    if channel is None:
        channel = np.arange(signal.number_of_channels)
    channel = np.atleast_1d(channel)
    td_np = np.asarray(signal.time_data)[:, channel].T  # (C, T)
    fs_hz = signal.sampling_rate_hz
    freqs_np = np.asarray(frequencies)
    wavelets = []
    for f in frequencies:
        wv = np.asarray(wavelet.get_wavelet(f, fs_hz))
        wavelets.append(wv / np.abs(wv).sum())

    def _cwt_all(td, *wvs):
        rows = [
            fft_convolve(td.astype(jnp.complex64), wv, "same")
            for wv in wvs
        ]
        scal = jnp.stack(rows, axis=0)  # (F, C, T)
        scal = jnp.transpose(scal, (0, 2, 1))  # (F, T, C)
        if synchrosqueezed:
            scal = _squeeze_core(
                scal,
                freqs_np,
                fs_hz,
                apply_frequency_normalization=(
                    apply_synchrosqueezed_normalization
                ),
            )
        # (real, imag) leaves: the device return is a DeviceSpectralData
        # pair
        return scal.real, scal.imag

    re, im = run_jitted_complex(
        _cwt_all, td_np, *wavelets, materialize=False
    )
    if return_device:
        return DeviceSpectralData(re, im)
    return np.asarray(re) + 1j * np.asarray(im)


def hilbert(signal):
    """Analytic signal (`transforms.py:763-810`)."""
    from ..helpers.latency import analytic_signal

    if isinstance(signal, Signal):
        from .._config import run_jitted_complex
        from ..classes.signal import DeviceTimeData

        re, im = run_jitted_complex(
            lambda td: (lambda z: (z.real, z.imag))(
                analytic_signal(td, axis=0)
            ),
            signal.time_data_jax,
            materialize=False,  # analytic signal stays device-resident
        )
        return signal.copy_with_new_time_data(DeviceTimeData(re, im))
    if isinstance(signal, MultiBandSignal):
        new_mb = signal.copy()
        new_mb.bands = [hilbert(b) for b in new_mb.bands]
        return new_mb
    raise TypeError("Signal does not have a valid type")


def vqt(
    signal: Signal,
    channel=None,
    q: float = 1,
    gamma: float = 50,
    octaves: list = [1, 5],
    bins_per_octave: int = 24,
    a4_tuning: int = 440,
    window="hann",
    return_device: bool = False,
):
    """Variable-Q transform (`transforms.py:812-924`).

    ``return_device=True`` keeps the (F, T, C) complex matrix on the
    device as a :class:`DeviceSpectralData` (no host fetch of the full
    matrix); default returns the host matrix (reference parity)."""
    if channel is None:
        channel = np.arange(signal.number_of_channels)
    channel = np.atleast_1d(channel)
    td = jnp.asarray(signal.time_data[:, channel].T)  # (C, T)
    highest_f = a4_tuning * 2 ** (octaves[1] - 4 + 2 / 12)
    decimation = int((signal.sampling_rate_hz // 2) / (highest_f * 1.1))
    mid_fs = signal.sampling_rate_hz // decimation
    td = resample_poly(td, up=1, down=decimation)
    gamma = gamma / signal.sampling_rate_hz * mid_fs
    kernels = get_kernels_vqt(
        q, highest_f, bins_per_octave, mid_fs, window, gamma
    )
    octs = octaves[1] - octaves[0] + 1
    T_out = signal.time_data_jax.shape[0]

    def _vqt_core(td_in):
        td_loc = td_in
        pieces = []
        for oc in range(octs):
            outs = []
            for k in kernels:
                out = fft_convolve(
                    td_loc.astype(jnp.complex64),
                    jnp.asarray(k, jnp.complex64),
                    "same",
                )
                outs.append(out)
            acc = jnp.stack(outs, axis=0)  # (bins, C, T_oct)
            if oc != 0:
                acc = resample_poly(acc, up=2**oc, down=1)
            acc = resample_poly(acc, up=decimation, down=1)
            diff = acc.shape[-1] - T_out
            if diff > 0:
                acc = acc[..., :T_out]
            elif diff < 0:
                acc = jnp.pad(acc, ((0, 0), (0, 0), (0, -diff)))
            pieces.append(acc)
            td_loc = resample_poly(td_loc, up=1, down=2)
        cqt_ = jnp.concatenate(pieces, axis=0)  # (F, C, T)
        cqt_ = jnp.flip(cqt_, axis=0)
        cqt_ = jnp.transpose(cqt_, (0, 2, 1))
        return cqt_.real, cqt_.imag

    from .._config import run_jitted_complex
    from ..classes.signal import DeviceSpectralData

    # one jitted program across all octaves (complex stays on device)
    re, im = run_jitted_complex(_vqt_core, td, materialize=False)
    f = a4_tuning * 2 ** (
        np.arange(octaves[0] - 4 - 9 / 12, octaves[1] - 4 + 2 / 12, 1 / 12)
    )
    if return_device:
        return f, DeviceSpectralData(re, im)
    return f, np.asarray(re) + 1j * np.asarray(im)


def stereo_mid_side(signal: Signal, forward: bool) -> Signal:
    """Left/right ↔ mid/side (`transforms.py:926-953`)."""
    assert signal.number_of_channels == 2, (
        "Signal must have exactly two channels"
    )
    td = signal.time_data.copy()
    a, b = signal.time_data[:, 0], signal.time_data[:, 1]
    td[:, 0] = a + b
    td[:, 1] = a - b
    if forward:
        td /= 2
    return signal.copy_with_new_time_data(td)


def laguerre(signal: Signal, warping_factor: float) -> Signal:
    """Discrete Laguerre transform via the cascaded first-order sections
    (`transforms.py:955-1017`). Runs as one `lax.scan` over output samples."""
    from ..ops.iir_block import lfilter_block

    assert np.abs(warping_factor) < 1.0, (
        "Warping factor cannot be larger than 1."
    )
    lam = warping_factor
    xx = jnp.asarray(signal.time_data[::-1, :].T)  # (C, T)
    b = np.array([lam, 1.0])
    a = np.array([1.0, lam])
    b_norm = (1.0 - lam**2.0) ** 0.5
    xx, _ = lfilter_block(np.array([b_norm]), a, xx)
    T = xx.shape[-1]

    def step(carry, _):
        new, _ = lfilter_block(b, a, carry)
        return new, new[..., -1]

    first = xx[..., -1]
    _, rest = jax.lax.scan(step, xx, None, length=T - 1)
    output = jnp.concatenate([first[None], rest], axis=0)  # (T, C)
    return signal.copy_with_new_time_data(np.asarray(output))


def warp(
    ir: Signal,
    warping_factor,
    shift_ir: bool,
    total_length: int | None = None,
):
    """Warp/dewarp a signal (WFIR; `transforms.py:1019-1131`)."""
    from ..room_acoustics._backend import find_ir_start

    approximation = isinstance(warping_factor, str)
    warping_factor = get_warping_factor(
        warping_factor, ir.sampling_rate_hz
    )
    td = ir.time_data.copy()
    if shift_ir:
        for ch in range(ir.number_of_channels):
            start = find_ir_start(td[:, ch], -20)
            td[:, ch] = np.roll(td[:, ch], -start)
    warped = warp_time_series(
        td if total_length is None else td[:total_length, ...],
        warping_factor,
    )
    warped_ir = ir.copy_with_new_time_data(warped)
    if approximation:
        return warped_ir, warping_factor
    return warped_ir


def warp_filter(filter: Filter, warping_factor: float) -> Filter:
    """Warp a filter's poles/zeros (`transforms.py:1133-1197`)."""
    assert abs(warping_factor) < 1.0, "Warping factor must be less than 1."
    z, p, k = filter.get_coefficients(FilterCoefficientsType.Zpk)
    p = (warping_factor + p) / (1 + warping_factor * p)
    z = (warping_factor + z) / (1 + warping_factor * z)
    if len(p) > len(z):
        z = np.hstack([z, [warping_factor] * (len(p) - len(z))])
    elif len(z) > len(p):
        p = np.hstack([p, [warping_factor] * (len(z) - len(p))])
    return Filter.from_zpk(z, p, k, filter.sampling_rate_hz)


def lpc(
    signal: Signal,
    order: int,
    window_length_samples: int,
    synthesize_encoded_signal: bool = False,
    use_burg_method: bool = False,
    hop_size_samples: int | None = None,
    window_type: Window = Window.Hann,
):
    """Linear-predictive coding over frames (device framing + batched
    Levinson/Burg; `transforms.py:1199-1283`)."""
    from ..ops.iir_block import lfilter_block
    from ..ops.windows import get_window as get_window_np

    if hop_size_samples is None:
        hop_size_samples = window_length_samples // 2
    frames = frame_signal(
        jnp.asarray(signal.time_data.T),
        window_length_samples,
        hop_size_samples,
        True,
    )  # (C, K, L)
    window = get_window_np(window_type, window_length_samples, symmetric=False)
    frames = frames * jnp.asarray(window, frames.dtype)
    # reference layout: (L, K, C)
    td = jnp.transpose(frames, (2, 1, 0))
    a, var = (
        burg_ar(td, order) if use_burg_method else yule_walker_ar(td, order)
    )
    a = np.asarray(a)
    var = np.asarray(var)
    if not synthesize_encoded_signal:
        return a, var
    synth = np.zeros(td.shape)
    for channel in range(td.shape[2]):
        for n_window in range(td.shape[1]):
            source = np.random.normal(
                0.0, max(var[n_window, channel], 0) ** 0.5, td.shape[0]
            )
            y, _ = lfilter_block(
                np.array([1.0]),
                a[:, n_window, channel],
                jnp.asarray(source),
            )
            synth[:, n_window, channel] = np.asarray(y)
    rec = reconstruct_framed_signal(
        jnp.asarray(np.transpose(synth, (2, 1, 0))),
        hop_size_samples,
        window,
        len(signal),
    )
    return Signal.from_time_data(
        np.asarray(rec.T), signal.sampling_rate_hz
    )


def dft(signal: Signal, frequency_vector_hz: np.ndarray):
    """Arbitrary-frequency DFT as one complex matmul
    (`transforms.py:1286-1328`; numba kernel #3 → one matmul)."""
    f_normalized = np.asarray(frequency_vector_hz) * (
        signal.time_data_jax.shape[0] / signal.sampling_rate_hz
    )
    from .._config import run_jitted_complex

    spec = run_jitted_complex(
        lambda td: dft_core(td, f_normalized), signal.time_data
    )
    return np.asarray(spec)


def spectrum_via_filterbank(
    signal: Signal,
    frequency_vector_hz: np.ndarray,
    bandwidth_octaves: float | None = None,
    bandwidth_hz: float | None = None,
    order: int = 8,
    zero_phase: bool = False,
) -> Spectrum:
    """RMS magnitude spectrum via a butterworth band battery
    (`transforms.py:1330-1393`)."""
    assert (
        bandwidth_octaves is not None or bandwidth_hz is not None
    ), "At least one bandwidth parameter must be provided"
    bands = []
    if bandwidth_hz is not None:
        assert bandwidth_hz > 0, "Bandwidth must be positive"
        assert bandwidth_octaves is None, "Both bandwidths cannot be given"
        hb = bandwidth_hz / 2.0
        for freq in frequency_vector_hz:
            bands.append([freq - hb, freq + hb])
    if bandwidth_octaves is not None:
        assert bandwidth_octaves > 0, "Bandwidth must be positive"
        assert bandwidth_hz is None, "Both bandwidths cannot be given"
        factor = 2 ** (bandwidth_octaves / 2.0)
        for freq in frequency_vector_hz:
            bands.append([freq / factor, freq * factor])
    fb = FilterBank(
        [
            Filter.iir_filter(
                order,
                band,
                FilterPassType.Bandpass,
                signal.sampling_rate_hz,
            )
            for band in bands
        ]
    )
    mir = fb.filter_signal(
        signal, FilterBankMode.Parallel, zero_phase=zero_phase
    )
    from ..standard.gain_and_level import rms

    return Spectrum(frequency_vector_hz, rms(mir, False))
