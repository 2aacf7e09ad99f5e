"""Signal generators: noise, chirps, dirac, band-limited oscillators.

Behavioral reference: `dsptoolbox/generators/generators.py`. Device notes: the
spectral shaping + inverse FFT of `noise` and the harmonic stacking of
`oscillator` (the reference's Python while-loop,
`generators/generators.py:385-420`) run as batched device ops — the harmonic
series is one (samples × harmonics) broadcast-sum. Random draws use
`jax.random` with an optional explicit seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._config import default_float
from ..classes.filter_helpers import impulse
from ..classes.impulse_response import ImpulseResponse
from ..classes.signal import Signal
from ..helpers.frequency_conversion import frequency_weighting
from ..helpers.gain_and_level import fade as _fade
from ..helpers.gain_and_level import normalize as _normalize
from ..ops.pad_trim import pad_trim_axis
from ..standard.enums import FadeType
from .enums import ChirpType, NoiseType, WaveForm


def _key(seed):
    if seed is None:
        seed = np.random.randint(0, 2**31 - 1)
    if isinstance(seed, (int, np.integer)):
        return jax.random.PRNGKey(int(seed))
    return seed


def noise(
    length_seconds: float,
    sampling_rate_hz: int,
    type_of_noise: NoiseType | float = NoiseType.White,
    peak_level_dbfs: float = -10.0,
    number_of_channels: int = 1,
    fade: FadeType = FadeType.Logarithmic,
    padding_end_seconds: float = 0.0,
    seed=None,
) -> Signal:
    """Colored noise via spectral magnitude shaping with random phase
    (`generators/generators.py:20-144`). ``type_of_noise`` may be a float
    ``beta`` shaping psd ∝ f^-beta."""
    if not isinstance(type_of_noise, NoiseType):
        assert isinstance(type_of_noise, float), (
            "type_of_noise must be either NoiseType or float"
        )
    assert length_seconds > 0, "Length has to be positive"
    assert peak_level_dbfs <= 0, "Peak level cannot surpass 0 dBFS"
    assert number_of_channels >= 1, "At least one channel should be generated"

    l_samples = int(length_seconds * sampling_rate_hz + 0.5)
    f = np.fft.rfftfreq(l_samples, 1 / sampling_rate_hz)
    p_samples = 0
    if padding_end_seconds != 0:
        assert padding_end_seconds > 0, "Padding has to be a positive time"
        p_samples = int(padding_end_seconds * sampling_rate_hz + 0.5)

    k1, k2 = jax.random.split(_key(seed))
    F, C = len(f), number_of_channels
    mag = 2.0 + 0.0025 * jax.random.normal(k1, (F, C), dtype=default_float())
    ph = jax.random.uniform(
        k2, (F, C), minval=-np.pi, maxval=np.pi, dtype=default_float()
    )

    id_low = int(np.argmin(np.abs(f - 15)))
    shape = np.ones(F)
    if type_of_noise == NoiseType.Pink:
        shape[id_low:] = f[id_low:] ** -0.5
    elif type_of_noise == NoiseType.Red:
        shape[id_low:] = 1.0 / f[id_low:]
    elif type_of_noise == NoiseType.Blue:
        shape[id_low:] = f[id_low:] ** 0.5
    elif type_of_noise == NoiseType.Violet:
        shape[id_low:] = f[id_low:]
    elif type_of_noise == NoiseType.Grey:
        w = np.asarray(frequency_weighting(f, "a", db_output=False))
        shape[id_low:] = 1.0 / w[id_low:]
    elif isinstance(type_of_noise, float):
        shape[id_low:] = f[id_low:] ** (-type_of_noise * 0.5)
    if type_of_noise != NoiseType.White or type_of_noise != 0.0:
        shape[:id_low] = 1e-20
    shape[0] = 0.0

    def _synthesize(mag_in, ph_in):
        # one jitted program: the complex spectrum never leaves the device
        mag_s = mag_in * jnp.asarray(shape, default_float())[:, None]
        ph_s = ph_in.at[0, :].set(0.0)
        if l_samples % 2 == 0:
            ph_s = ph_s.at[-1, :].set(0.0)
        vec = jnp.fft.irfft(
            mag_s * jnp.exp(1j * ph_s), n=l_samples, axis=0
        )
        vec = _normalize(
            vec.T, peak_level_dbfs, peak_normalization=True,
            per_channel=True,
        ).T
        if fade is not None:
            fade_length = 0.05 * length_seconds
            vec = _fade(vec.T, fade_length, fade, sampling_rate_hz, True).T
            vec = _fade(
                vec.T, fade_length, fade, sampling_rate_hz, False
            ).T
        return pad_trim_axis(vec, l_samples + p_samples, axis=0)

    from .._config import run_jitted_complex

    time_data = run_jitted_complex(_synthesize, mag, ph)
    return Signal(None, np.asarray(time_data), sampling_rate_hz)


def sync_log_chirp(
    chirp_range_hz, length_seconds: float, sampling_rate_hz: int
):
    """Novak synchronized swept sine (`generators/_generators.py:5-45`)."""
    f1, f2 = chirp_range_hz[0], chirp_range_hz[1]
    f2f1 = np.log(f2 / f1)
    k = int(f1 * length_seconds / f2f1 + 0.5)
    T = k / f1 * f2f1
    L = int(0.5 + T * f1 / f2f1) / f1
    # The unwrapped phase reaches ~1e4 rad; fp32 eps there is ~1e-3 rad, so
    # accumulate the phase in f64 on host and wrap before the device sin.
    t = np.linspace(0.0, T, int(T * sampling_rate_hz + 0.5))
    phase = 2.0 * np.pi * f1 * L * (np.exp(t / L) - 1.0)
    phase = np.mod(phase, 2.0 * np.pi)
    return jnp.sin(jnp.asarray(phase, default_float())), T


def chirp(
    sampling_rate_hz: int,
    type_of_chirp: ChirpType = ChirpType.Logarithmic,
    range_hz=None,
    length_seconds: float = 1.0,
    peak_level_dbfs: float = -10.0,
    number_of_channels: int = 1,
    fade: FadeType = FadeType.Logarithmic,
    phase_offset: float = 0.0,
    padding_end_seconds: float = 0.0,
):
    """Sine sweeps (`generators/generators.py:147-270`). Returns
    ``(Signal, T)`` for SyncLog, else ``Signal``."""
    if range_hz is not None:
        assert len(range_hz) == 2, (
            "range_hz has to contain exactly two frequencies"
        )
        range_hz = sorted(range_hz)
        assert range_hz[0] > 0, (
            "Range has to start with positive frequencies excluding 0"
        )
        assert range_hz[1] <= sampling_rate_hz // 2, (
            "Upper limit for frequency range cannot be bigger than the "
            "nyquist frequency"
        )
    else:
        range_hz = [15, sampling_rate_hz // 2]
    p_samples = 0
    if padding_end_seconds != 0:
        assert padding_end_seconds > 0, "Padding has to be a positive time"
        p_samples = int(padding_end_seconds * sampling_rate_hz)
    l_samples = int(sampling_rate_hz * length_seconds + 0.5)

    # Phase accumulates to ~1e4 rad over a sweep; fp32 eps there is ~1e-3
    # rad, so build the phase in f64 on host, wrap mod 2pi, sin on device.
    T = None
    if type_of_chirp == ChirpType.Linear:
        t = np.linspace(0, length_seconds, l_samples)
        k = (range_hz[1] - range_hz[0]) / length_seconds
        freqs = (range_hz[0] + k / 2 * t) * 2 * np.pi
        phase = np.mod(freqs * t + phase_offset, 2 * np.pi)
        chirp_td = jnp.sin(jnp.asarray(phase, default_float()))
    elif type_of_chirp == ChirpType.Logarithmic:
        t = np.linspace(0, length_seconds, l_samples)
        k = np.exp(
            (np.log(range_hz[1]) - np.log(range_hz[0])) / length_seconds
        )
        phase = np.mod(
            2 * np.pi * range_hz[0] / np.log(k) * (k**t - 1) + phase_offset,
            2 * np.pi,
        )
        chirp_td = jnp.sin(jnp.asarray(phase, default_float()))
    elif type_of_chirp == ChirpType.SyncLog:
        chirp_td, T = sync_log_chirp(
            range_hz, length_seconds, sampling_rate_hz
        )
    else:
        raise ValueError("Unsupported chirp type")

    chirp_td = _normalize(
        chirp_td, peak_level_dbfs, peak_normalization=True, per_channel=True
    )
    if fade is not None:
        fade_length = 0.05 * length_seconds
        chirp_td = _fade(
            chirp_td, fade_length, fade, sampling_rate_hz, True
        )
        chirp_td = _fade(
            chirp_td, fade_length, fade, sampling_rate_hz, False
        )
    chirp_td = pad_trim_axis(chirp_td, l_samples + p_samples, axis=-1)
    chirp_n = np.asarray(chirp_td)[..., None]
    if number_of_channels != 1:
        chirp_n = np.repeat(chirp_n, repeats=number_of_channels, axis=1)
    sig = Signal(None, chirp_n, sampling_rate_hz)
    return (sig, T) if type_of_chirp == ChirpType.SyncLog else sig


def dirac(
    length_samples: int,
    sampling_rate_hz: int,
    delay_samples: int = 0,
    number_of_channels: int = 1,
) -> ImpulseResponse:
    """Dirac impulse IR (`generators/generators.py:272-315`)."""
    assert isinstance(length_samples, int) and length_samples > 0, (
        "Only positive lengths are valid"
    )
    assert isinstance(delay_samples, int) and delay_samples >= 0, (
        "Only positive delay is supported"
    )
    assert delay_samples < length_samples, (
        "Delay is bigger than the samples of the signal"
    )
    assert number_of_channels > 0, "At least one channel has to be created"
    assert sampling_rate_hz > 0, "Sampling rate can only be positive"
    td = np.repeat(
        impulse(length_samples, delay_samples)[:, None],
        number_of_channels,
        axis=1,
    )
    return ImpulseResponse(None, td, sampling_rate_hz)


def oscillator(
    frequency_hz: float,
    sampling_rate_hz: int,
    length_seconds: float = 1.0,
    mode: WaveForm = WaveForm.Harmonic,
    harmonic_cutoff_hz: float | None = None,
    peak_level_dbfs: float = -10.0,
    number_of_channels: int = 1,
    uncorrelated: bool = False,
    fade: FadeType = FadeType.Logarithmic,
    padding_end_seconds: float = 0.0,
    seed=None,
) -> Signal:
    """Band-limited wave tones (`generators/generators.py:317-470`).

    The harmonic synthesis is a vectorized (samples × harmonics) sum on
    device instead of the reference's accumulation loop."""
    assert frequency_hz < sampling_rate_hz // 2, (
        "Frequency must be beneath nyquist frequency"
    )
    assert frequency_hz > 0, "Frequency must be bigger than 0"
    p_samples = 0
    if padding_end_seconds != 0:
        assert padding_end_seconds > 0, "Padding has to be a positive time"
        p_samples = int(padding_end_seconds * sampling_rate_hz)
    l_samples = int(sampling_rate_hz * length_seconds + 0.5)
    if harmonic_cutoff_hz is None:
        harmonic_cutoff_hz = sampling_rate_hz // 2
    assert 0 < harmonic_cutoff_hz <= sampling_rate_hz // 2, (
        "Cutoff frequency must be between 0 and the nyquist frequency!"
    )

    if uncorrelated:
        phase_shift = jax.random.uniform(
            _key(seed),
            (1, number_of_channels),
            minval=-np.pi,
            maxval=np.pi,
            dtype=default_float(),
        )
    else:
        phase_shift = jnp.zeros((1, number_of_channels), default_float())

    # The unwrapped phase n·w0·order reaches ~1e3-1e5 rad where fp32 has
    # ~1e-4 rad resolution; wrap the cycle count mod 1 in f64 on host and
    # hand the device a bounded argument.
    n_idx = np.arange(l_samples, dtype=np.float64)[:, None]
    cycles0 = frequency_hz / sampling_rate_hz

    def wrapped_phase(orders: np.ndarray) -> jnp.ndarray:
        # (T, 1, K) wrapped phases in radians
        ph = np.mod(n_idx[..., None] * (orders * cycles0), 1.0) * (2 * np.pi)
        return jnp.asarray(ph, default_float())

    def harmonic_sum(orders: np.ndarray, weights: np.ndarray) -> jnp.ndarray:
        # (T, C, K) broadcast-sum over harmonics
        args = wrapped_phase(np.asarray(orders, np.float64)) + phase_shift[
            ..., None
        ]
        return jnp.sum(
            jnp.sin(args) * jnp.asarray(weights, default_float()), axis=-1
        )

    if mode == WaveForm.Harmonic:
        td = jnp.sin(
            wrapped_phase(np.ones(1))[:, 0, :] + phase_shift
        )
    elif mode == WaveForm.Square:
        ks = np.arange(1, int(harmonic_cutoff_hz / frequency_hz / 2) + 2)
        orders = 2 * ks - 1
        orders = orders[orders * frequency_hz < harmonic_cutoff_hz]
        td = harmonic_sum(orders, 1.0 / orders) * (4 / np.pi)
    elif mode == WaveForm.Sawtooth:
        ks = np.arange(1, int(harmonic_cutoff_hz / frequency_hz) + 2)
        ks = ks[ks * frequency_hz < harmonic_cutoff_hz]
        td = harmonic_sum(ks, ((-1.0) ** ks) / ks) * (-2 / np.pi)
    elif mode == WaveForm.Triangle:
        ks = np.arange(1, int(harmonic_cutoff_hz / frequency_hz / 2) + 2)
        orders = 2 * ks - 1
        keep = orders * frequency_hz < harmonic_cutoff_hz
        orders = orders[keep]
        signs = (-1.0) ** ks[keep]
        td = harmonic_sum(orders, signs / orders**2) * (-8 / np.pi**2)
    else:
        raise ValueError("Unsupported wave form")

    td = _normalize(
        td.T, peak_level_dbfs, peak_normalization=True, per_channel=True
    ).T
    if fade is not None:
        fade_length = 0.05 * length_seconds
        td = _fade(td.T, fade_length, fade, sampling_rate_hz, True).T
        td = _fade(td.T, fade_length, fade, sampling_rate_hz, False).T
    td = pad_trim_axis(td, l_samples + p_samples, axis=0)
    return Signal(None, np.asarray(td), sampling_rate_hz)
