"""Effects backend: waveshapers, compressor gain computer, LFOs.

Behavioral reference: `dsptoolbox/effects/_effects.py`. The compressor's
per-sample envelope/gain recursion runs as a `lax.scan` over time, batched
across channels; waveshapers are pure elementwise device math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..helpers.gain_and_level import from_db
from ..helpers.smoothing import get_smoothing_factor_ema


# ========= Distortion ========================================================
def arctan_distortion(inp, distortion_level_db, offset_db):
    offset = 10 ** (offset_db / 20)
    level = 10 ** (distortion_level_db / 20)
    peak = jnp.max(jnp.abs(inp), axis=0)
    normalized = inp / peak
    return jnp.arctan(normalized * level + offset) * (2 / np.pi)


def hard_clip_distortion(inp, distortion_level_db, offset_db):
    offset = 10 ** (offset_db / 20)
    level = 10 ** (distortion_level_db / 20)
    peak = jnp.max(jnp.abs(inp), axis=0)
    normalized = inp / peak
    return jnp.clip(normalized * level + offset, min=-1, max=1)


def soft_clip_distortion(inp, distortion_level_db, offset_db):
    offset = 10 ** (offset_db / 20)
    level = 10 ** (distortion_level_db / 20)
    peak = jnp.max(jnp.abs(inp), axis=0)
    normalized = inp / peak * (2 / 3)
    normalized = (normalized + offset) * level
    normalized = normalized - normalized**3 / 3
    return jnp.clip(normalized, min=-2 / 3, max=2 / 3)


def clean_signal(inp, distortion_level_db, offset_db):
    return inp


# ========= Compressor ========================================================
def get_knee_func(
    threshold_db: float,
    ratio: float,
    knee_factor_db: float,
    downward_compression: bool,
):
    """Soft-knee compression curve in dB space
    (`_effects.py:152-215`). Returns a jnp-compatible callable."""
    T = threshold_db
    R = ratio
    W = knee_factor_db

    if downward_compression:

        def compress_in_db(x):
            x = jnp.asarray(x)
            below = x
            knee = x + (1 / R - 1) * (x - T + W / 2) ** 2 / 2 / max(W, 1e-12)
            above = T + (x - T) / R
            y = jnp.where(x - T < -W / 2, below, jnp.where(
                jnp.abs(x - T) <= W / 2, knee, above))
            if W == 0:
                y = jnp.where(x <= T, x, T + (x - T) / R)
            return y

    else:

        def compress_in_db(x):
            x = jnp.asarray(x)
            below = T + (x - T) / R
            knee = x - (1 / R - 1) * (x - T - W / 2) ** 2 / 2 / max(W, 1e-12)
            above = x
            y = jnp.where(x - T < -W / 2, below, jnp.where(
                jnp.abs(x - T) <= W / 2, knee, above))
            if W == 0:
                y = jnp.where(x >= T, x, T + (x - T) / R)
            return y

    return compress_in_db


def compressor_core(
    x: jnp.ndarray,
    threshold_db: float,
    ratio: float,
    knee_factor_db: float,
    attack_samples: int,
    release_samples: int,
    mix_compressed: float,
    downward_compression: bool,
) -> jnp.ndarray:
    """Cached-jit wrapper around the compressor recursion: eagerly, the
    scan's surrounding ops would each be a separate dispatch."""
    from ..classes.signal import _dev_jit

    # coerce ONCE and bake exactly the key's values into the closure — a
    # key/closure mismatch would let params that coerce equal (100 vs
    # 100.9 samples) silently reuse the wrong compiled program. Each
    # distinct parameter set compiles its own program (they reach static
    # control flow in the knee function), cached for the process lifetime.
    threshold_db = float(threshold_db)
    ratio = float(ratio)
    knee_factor_db = float(knee_factor_db)
    attack_samples = int(attack_samples)
    release_samples = int(release_samples)
    mix_compressed = float(mix_compressed)
    downward_compression = bool(downward_compression)
    key = (
        "compressor",
        threshold_db,
        ratio,
        knee_factor_db,
        attack_samples,
        release_samples,
        mix_compressed,
        downward_compression,
    )
    return _dev_jit(
        key,
        lambda xv: _compressor_core_traced(
            xv,
            threshold_db,
            ratio,
            knee_factor_db,
            attack_samples,
            release_samples,
            mix_compressed,
            downward_compression,
        ),
    )(jnp.asarray(x))


def _compressor_core_traced(
    x: jnp.ndarray,
    threshold_db: float,
    ratio: float,
    knee_factor_db: float,
    attack_samples: int,
    release_samples: int,
    mix_compressed: float,
    downward_compression: bool,
) -> jnp.ndarray:
    """Sample recursion of the reference compressor
    (`_effects.py:61-149`) as one `lax.scan` over time, channels batched.
    ``x (T, C)``."""
    mix_compressed = min(mix_compressed, 1.0)
    single = x.ndim == 1
    if single:
        x = x[:, None]
    func = get_knee_func(
        threshold_db, ratio, knee_factor_db, downward_compression
    )
    attack_coeff = get_smoothing_factor_ema(max(attack_samples, 1e-12), 1)
    release_coeff = get_smoothing_factor_ema(max(release_samples, 1e-12), 1)
    min_power = float(from_db(-300.0, False))

    def step(carry, x_t):
        rms, gain = carry
        samp = x_t**2
        coeff = jnp.where(samp > rms, 1.0, 0.01)
        rms = coeff * samp + (1 - coeff) * rms
        samp_db = 10 * jnp.log10(jnp.maximum(samp, min_power))
        samp_db_comp = func(samp_db)
        gain_factor = 10 ** ((samp_db_comp - samp_db) / 20)
        coeff2 = jnp.where(gain_factor > gain, attack_coeff, release_coeff)
        gain = coeff2 * gain_factor + (1 - coeff2) * gain
        return (rms, gain), x_t * gain

    C = x.shape[1]
    init = (jnp.zeros(C, x.dtype), jnp.ones(C, x.dtype))
    # unroll amortizes the per-step loop overhead of this latency-bound
    # recursion
    _, y = jax.lax.scan(step, init, x, unroll=8)
    if single:
        y = y[:, 0]
    return y


# ========= LFO ===============================================================
def harmonic_oscillator(freq, fs, length, random_phase, smooth):
    if length is None:
        length = int(fs / freq)
    phase_shift = np.random.uniform(-np.pi, np.pi) if random_phase else 0
    return np.sin(freq / fs * 2 * np.pi * np.arange(length) + phase_shift)


def square_oscillator(freq, fs, length, random_phase, smooth):
    if length is None:
        length = int(fs / freq)
    phase_shift = np.random.uniform(-np.pi, np.pi) if random_phase else 0
    x = np.sin(freq / fs * 2 * np.pi * np.arange(length) + phase_shift)
    if smooth == 0:
        return np.sign(x)
    smooth *= 0.25 / 10
    return np.arctan(x / smooth)


def sawtooth_oscillator(freq, fs, length, random_phase, smooth):
    if length is None:
        length = int(fs / freq)
    norm_freq = freq / fs
    if smooth == 0:
        phase_shift = np.random.uniform(0, 1) if random_phase else 0
        x = norm_freq * np.arange(length) + phase_shift
        return (x % 1 - 0.5) * 2
    phase_shift = np.random.uniform(-np.pi, np.pi) if random_phase else 0
    x = np.pi * norm_freq * np.arange(length) + phase_shift
    smooth = max(1, (12 - smooth) ** 1.5)
    waveform = np.arcsin(np.tanh(np.cos(x) * smooth) * np.sin(x))
    return waveform / np.abs(np.max(waveform))


def triangle_oscillator(freq, fs, length, random_phase, smooth):
    if length is None:
        length = int(fs / freq)
    phase_shift = np.random.uniform(-np.pi, np.pi) if random_phase else 0
    x = np.sin(freq / fs * 2 * np.pi * np.arange(length) + phase_shift)
    if smooth == 0:
        waveform = 2 / np.pi * np.arcsin(x)
    else:
        smooth *= 0.08 / 10
        waveform = 1 - 2 / np.pi * np.arccos((1 - smooth) * x)
    return waveform / np.max(np.abs(waveform))


def get_frequency_from_musical_rhythm(note, bpm) -> float:
    """Musical rhythm → frequency (`_effects.py:475-532`)."""
    assert isinstance(note, str) and isinstance(bpm, (float, int)), (
        "Wrong data types for note duration and bpm"
    )
    factor = 0
    if "quarter" in note:
        factor = 1
    if "half" in note:
        factor = 2
    if "whole" in note:
        factor = 4
    if "eighth" in note:
        factor = 1 / 2
    if "sixteenth" in note:
        factor = 1 / 4
    if "32th" in note:
        factor = 1 / 8
    if "quintuplet" in note:
        factor = 1 / 5
    if "3" in note:
        factor *= 2 / 3
    if "dotted" in note:
        factor *= 1.5
    if factor == 0:
        raise ValueError("No valid note description was passed")
    return 60 / bpm / factor


def get_time_period_from_musical_rhythm(note, bpm) -> float:
    return 1 / get_frequency_from_musical_rhythm(note, bpm)


class LFO:
    """Low-frequency oscillator (`_effects.py:289-413`)."""

    def __init__(
        self,
        frequency_hz,
        waveform: str = "harmonic",
        random_phase: bool = False,
        smooth: float = 0,
    ):
        self.__set_parameters(frequency_hz, waveform, random_phase, smooth)

    def __set_parameters(self, frequency_hz, waveform, random_phase, smooth):
        if frequency_hz is not None:
            if isinstance(frequency_hz, (float, int)):
                self.frequency_hz = abs(frequency_hz)
            elif isinstance(frequency_hz, (tuple, list)):
                assert len(frequency_hz) == 2, (
                    "frequency_hz as tuple must have length 2"
                )
                self.frequency_hz = get_frequency_from_musical_rhythm(
                    frequency_hz[0], frequency_hz[1]
                )
            else:
                raise TypeError("frequency_hz does not have a valid type")
        if waveform is not None:
            waveform = waveform.lower()
            oscillators = {
                "harmonic": harmonic_oscillator,
                "sawtooth": sawtooth_oscillator,
                "square": square_oscillator,
                "triangle": triangle_oscillator,
            }
            if waveform not in oscillators:
                raise ValueError("Selected waveform is not valid")
            self.oscillator = oscillators[waveform]
        if smooth is not None:
            self.smooth = smooth
        if random_phase is not None:
            self.random_phase = random_phase

    def set_parameters(
        self,
        frequency_hz=None,
        waveform: str | None = None,
        random_phase: bool | None = None,
        smooth: float | None = None,
    ):
        self.__set_parameters(frequency_hz, waveform, random_phase, smooth)

    def get_waveform(
        self, sampling_rate_hz: int, length_samples: int | None = None
    ):
        if length_samples is None:
            length_samples = int(sampling_rate_hz / self.frequency_hz)
        return self.oscillator(
            self.frequency_hz,
            sampling_rate_hz,
            length_samples,
            self.random_phase,
            self.smooth,
        )

    def plot_waveform(self):
        from ..plots import general_plot

        osc = self.oscillator(2, 1000, 1000, self.random_phase, self.smooth)
        fig, ax = general_plot(None, osc, log_x=False, xlabel=None)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_title("Waveform")
        return fig, ax
