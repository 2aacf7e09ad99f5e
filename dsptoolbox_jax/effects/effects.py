"""Audio effects: spectral subtraction, distortion, compressor, tremolo,
chorus, digital delay.

Behavioral reference: `dsptoolbox/effects/effects.py`. Device mappings:
- spectral subtraction: batched framing + rfft; the adaptive noise-PSD
  recursion is a `lax.scan` over frames (bins vectorized).
- compressor: `lax.scan` gain computer, channels batched.
- chorus: the per-sample voice-delay loop becomes one gather over a static
  index tensor.
- digital delay: the feedback comb recursion runs as a `lax.scan` over
  delay-sized blocks (samples within a block are independent).
"""

from __future__ import annotations

from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np

from ..classes import MultiBandSignal, Signal
from ..helpers.gain_and_level import to_db
from ..helpers.other import next_power_2
from ..ops.framing import frame_signal, reconstruct_framed_signal
from ..ops.pad_trim import pad_trim_axis
from ..ops.windows import get_window as get_window_np
from ..standard.enums import SpectrumMethod, SpectrumScaling, Window
from ._backend import (
    LFO,
    arctan_distortion,
    clean_signal,
    compressor_core,
    get_knee_func,
    hard_clip_distortion,
    soft_clip_distortion,
)
from .enums import DistortionType


class AudioEffect:
    """Base class for audio effects (`effects.py:35-135`)."""

    def __init__(self, description: str | None = None):
        self.description = description

    def apply(self, signal):
        if isinstance(signal, Signal):
            return self._apply_this_effect(signal)
        if isinstance(signal, MultiBandSignal):
            new_mbs = signal.copy()
            new_mbs.bands = [self.apply(b) for b in new_mbs.bands]
            return new_mbs
        raise TypeError(
            "Audio effect can only be applied to Signal or MultiBandSignal"
        )

    def _apply_this_effect(self, signal: Signal) -> Signal:
        return signal

    def _add_gain_in_db(self, time_data, gain_db):
        if gain_db is None:
            return time_data
        return time_data * 10 ** (gain_db / 20)

    # level save/restore helpers dispatch on input location: device
    # arrays stay on device with NO host sync (shapes are host-visible
    # without a fetch), host numpy stays numpy
    def _save_peak_values(self, inp):
        if isinstance(inp, jnp.ndarray) and not isinstance(inp, np.ndarray):
            from ..classes.signal import _dev_jit

            self._peak_values = _dev_jit(
                "fx_peak0", lambda a: jnp.max(jnp.abs(a), axis=0)
            )(inp)
        else:
            self._peak_values = np.max(np.abs(inp), axis=0)

    @staticmethod
    def _n_levels(v) -> int:
        # shape metadata only — np.atleast_1d on a device array would fetch
        return v.shape[0] if getattr(v, "ndim", 0) >= 1 else 1

    def _restore_peak_values(self, inp):
        if not hasattr(self, "_peak_values"):
            return inp
        if self._n_levels(self._peak_values) != inp.shape[1]:
            warn(
                "Number of saved peak values does not match number of "
                "channels. Restoring is ignored"
            )
            return inp
        if isinstance(inp, jnp.ndarray) and not isinstance(inp, np.ndarray):
            from ..classes.signal import _dev_jit

            return _dev_jit(
                "fx_restore_peak",
                lambda a, p: a * (p / jnp.max(jnp.abs(a), axis=0)),
            )(inp, jnp.asarray(self._peak_values))
        return inp * (
            np.asarray(self._peak_values) / np.max(np.abs(inp), axis=0)
        )

    def _save_rms_values(self, inp):
        if isinstance(inp, jnp.ndarray) and not isinstance(inp, np.ndarray):
            from ..classes.signal import _dev_jit

            self._rms_values = _dev_jit(
                "fx_rms0", lambda a: jnp.std(a, axis=0)
            )(inp)
        else:
            self._rms_values = np.std(inp, axis=0)

    def _restore_rms_values(self, inp):
        if not hasattr(self, "_rms_values"):
            return inp
        if self._n_levels(self._rms_values) != inp.shape[1]:
            warn(
                "Number of saved RMS values does not match number of "
                "channels. Restoring is ignored"
            )
            return inp
        if isinstance(inp, jnp.ndarray) and not isinstance(inp, np.ndarray):
            from ..classes.signal import _dev_jit

            return _dev_jit(
                "fx_restore_rms",
                lambda a, r: a * (r / jnp.std(a, axis=0)),
            )(inp, jnp.asarray(self._rms_values))
        return inp * (
            np.asarray(self._rms_values) / np.std(inp, axis=0)
        )


class SpectralSubtractor(AudioEffect):
    """STFT-domain spectral subtraction denoiser
    (`effects.py:138-551`)."""

    def __init__(
        self,
        adaptive_mode: bool = True,
        threshold_rms_dbfs: float = -40,
        block_length_s: float = 0.1,
        spectrum_to_subtract=False,
    ):
        super().__init__(description="Spectral Subtraction (Denoiser)")
        self.__set_parameters(
            adaptive_mode,
            threshold_rms_dbfs,
            block_length_s,
            spectrum_to_subtract,
        )
        self.set_advanced_parameters()

    def __set_parameters(
        self,
        adaptive_mode,
        threshold_rms_dbfs,
        block_length_s,
        spectrum_to_subtract,
    ):
        if adaptive_mode is not None:
            assert isinstance(adaptive_mode, bool), (
                "Adaptive mode must be of boolean type"
            )
            self.adaptive_mode = adaptive_mode
        if threshold_rms_dbfs is not None:
            assert isinstance(threshold_rms_dbfs, (int, float)), (
                "Threshold must be of type int or float"
            )
            if threshold_rms_dbfs >= 0:
                warn("Threshold is positive. This might be a wrong input")
            self.threshold_rms_dbfs = threshold_rms_dbfs
        if block_length_s is not None:
            assert isinstance(block_length_s, (int, float)), (
                "Block length should be of type int or float"
            )
            self.block_length_s = block_length_s
        if spectrum_to_subtract is not None:
            if np.any(spectrum_to_subtract):
                spectrum_to_subtract = np.squeeze(
                    np.asarray(spectrum_to_subtract)
                )
                assert spectrum_to_subtract.ndim == 1, (
                    "Spectrum to subtract could not be broadcasted to a "
                    "1D-Array"
                )
                if self.adaptive_mode:
                    warn(
                        "A spectrum to subtract was passed but adaptive "
                        "mode was selected. This is unsupported. Setting "
                        "adaptive mode to False"
                    )
                    self.adaptive_mode = False
            self.spectrum_to_subtract = spectrum_to_subtract

    def set_advanced_parameters(
        self,
        overlap_percent: int = 50,
        window_type: Window = Window.Hann,
        noise_forgetting_factor: float = 0.9,
        subtraction_factor: float = 2,
        subtraction_exponent: float = 2,
        ad_attack_time_ms: float = 0.5,
        ad_release_time_ms: float = 30,
    ):
        assert 0 <= overlap_percent < 100, "Overlap should be in [0, 100["
        self.overlap = overlap_percent / 100
        self.window_type = window_type
        assert 0 < noise_forgetting_factor <= 1, (
            "Noise forgetting factor must be in ]0, 1]"
        )
        self.noise_forgetting_factor = noise_forgetting_factor
        assert subtraction_factor > 0, (
            "The subtraction factor must be positive"
        )
        self.subtraction_factor = subtraction_factor
        assert subtraction_exponent > 0, (
            "Subtraction exponent should be above zero"
        )
        self.subtraction_exponent = subtraction_exponent
        assert ad_attack_time_ms >= 0, (
            "Attack time for activity detector must be 0 or above"
        )
        self.ad_attack_time_ms = ad_attack_time_ms
        assert ad_release_time_ms >= 0, (
            "Release time for activity detector must be 0 or above"
        )
        self.ad_release_time_ms = ad_release_time_ms

    def set_parameters(
        self,
        adaptive_mode: bool | None = None,
        threshold_rms_dbfs: float | None = None,
        block_length_s: float | None = None,
        spectrum_to_subtract=False,
    ):
        self.__set_parameters(
            adaptive_mode,
            threshold_rms_dbfs,
            block_length_s,
            spectrum_to_subtract,
        )

    def _compute_window(self, sampling_rate_hz):
        if not np.any(self.spectrum_to_subtract):
            self.window_length = next_power_2(
                self.block_length_s * sampling_rate_hz
            )
        else:
            self.window_length = (len(self.spectrum_to_subtract) - 1) * 2
        self.window = np.clip(
            get_window_np(self.window_type, self.window_length, False),
            a_min=1e-6,
            a_max=None,
        )
        self.step_size = int(self.window_length * (1 - self.overlap))

    def _apply_this_effect(self, signal: Signal) -> Signal:
        if self.adaptive_mode:
            # fully fused: peak save/restore happens inside the one
            # jitted program (`_apply_adaptive_mode`)
            return self._apply_adaptive_mode(signal)
        self._save_peak_values(signal.time_data_jax)
        out = self._apply_offline(signal)
        out.time_data = self._restore_peak_values(out.time_data_jax)
        return out

    def _frame(self, signal: Signal):
        """Pad + frame (device): returns (frames (C, K, L), original
        padded length)."""
        td = signal.time_data_jax
        td = pad_trim_axis(
            td, td.shape[0] + len(self.window), axis=0, in_the_end=True
        )
        td = pad_trim_axis(
            td, td.shape[0] + len(self.window), axis=0, in_the_end=False
        )
        original_length = td.shape[0]
        frames = frame_signal(td.T, len(self.window), self.step_size, True)
        return frames, original_length

    def _reconstruct(
        self, frames, original_length, signal, safety_threshold=1e-4
    ):
        td = reconstruct_framed_signal(
            frames,
            self.step_size,
            self.window,
            original_length,
            safety_threshold=safety_threshold,
        )
        td = td[..., len(self.window) : -len(self.window)]
        return signal.copy_with_new_time_data(td.T)  # device-resident

    def _apply_offline(self, signal: Signal) -> Signal:
        from ..standard.other import activity_detector

        self._compute_window(signal.sampling_rate_hz)
        frames, original_length = self._frame(signal)  # (C, K, L)

        noise_psds = []
        for n in range(signal.number_of_channels):
            if not np.any(self.spectrum_to_subtract):
                _, noise = activity_detector(
                    signal,
                    channel=n,
                    threshold_dbfs=self.threshold_rms_dbfs,
                    attack_time_ms=self.ad_attack_time_ms,
                    release_time_ms=self.ad_release_time_ms,
                )
                noise["noise"].set_spectrum_parameters(
                    method=SpectrumMethod.WelchPeriodogram,
                    window_length_samples=len(self.window),
                    overlap_percent=self.overlap * 100,
                    window_type=self.window_type,
                    scaling=SpectrumScaling.FFTBackward,
                )
                _, noise_psd = noise["noise"].get_spectrum()
                noise_psd = np.abs(np.asarray(noise_psd)).squeeze()
            else:
                noise_psd = np.abs(self.spectrum_to_subtract.copy())
            noise_psds.append(noise_psd ** (self.subtraction_exponent / 2))
        noise_np = np.stack(noise_psds, 0)[:, None, :]  # (C, 1, F)

        from .._config import run_jitted_complex

        def _subtract(frames_in, noise_in):
            wj = jnp.asarray(self.window)
            spec = jnp.fft.rfft(frames_in * wj, axis=-1)  # (C, K, F)
            phase = jnp.angle(spec)
            power = jnp.abs(spec) ** self.subtraction_exponent
            sub = jnp.clip(
                power - self.subtraction_factor * noise_in, min=0
            )
            return jnp.fft.irfft(
                sub ** (1 / self.subtraction_exponent)
                * jnp.exp(1j * phase),
                axis=-1,
                n=len(self.window),
            )

        new_frames = run_jitted_complex(
            _subtract, frames, noise_np, materialize=False
        )  # frames stay device-resident
        # parity: the reference's offline mode reconstructs with
        # safety_threshold=None — no window-envelope clipping
        # (`effects.py:482-484`)
        return self._reconstruct(
            new_frames, original_length, signal,
            safety_threshold=None,
        )

    def _apply_adaptive_mode(self, signal: Signal) -> Signal:
        """Adaptive spectral subtraction as ONE jitted program.

        pad → frame → rfft → adaptive noise-PSD recursion → subtraction →
        irfft → overlap-add reconstruction → peak restore all run in a
        single device program: one dispatch plus the amplitude-constraint
        scalar fetch instead of ~10 separate eager dispatches."""
        self._compute_window(signal.sampling_rate_hz)
        window = self.window  # host f64 np array (static)
        L = len(window)
        step_size = self.step_size
        ff = float(self.noise_forgetting_factor)
        sub_f = float(self.subtraction_factor)
        sub_e = float(self.subtraction_exponent)
        thr = float(self.threshold_rms_dbfs)
        td0 = signal.time_data_jax  # (T, C)
        T = td0.shape[0]

        from .._config import run_jitted_complex

        def _full(td_in):
            peak0 = jnp.max(jnp.abs(td_in), axis=0)  # (C,)
            x = pad_trim_axis(td_in, T + L, axis=0, in_the_end=True)
            x = pad_trim_axis(x, T + 2 * L, axis=0, in_the_end=False)
            original_length = T + 2 * L
            frames_in = frame_signal(x.T, L, step_size, True)  # (C, K, L)

            rms_db = to_db(jnp.var(frames_in, axis=-1), False)  # (C, K)
            wj = jnp.asarray(window, dtype=frames_in.dtype)
            spec = jnp.fft.rfft(frames_in * wj, axis=-1)
            phase = jnp.angle(spec)
            mag = jnp.abs(spec)
            power = mag**sub_e

            # Adaptive noise PSD recursion over frames. The recursion
            #   noise[k] = below[k] ? ff·noise[k-1] + (1-ff)·mag[k]
            #                       : noise[k-1]
            # is a first-order affine map with coefficients known ahead of
            # the scan: A[k] = below ? ff : 1, B[k] = below ? (1-ff)·mag : 0.
            # Composed affine maps under `associative_scan` run in log
            # depth (~9 levels for ~500 frames) instead of a ~500-step
            # sequential scan — the former 25+ ms tail of this program.
            below = rms_db < thr  # (C, K)
            below_f = below[:, :, None].astype(mag.dtype)  # (C, K, 1)
            A = 1.0 - below_f * (1.0 - ff)  # (C, K, 1) broadcastable to F
            B = below_f * (1.0 - ff) * mag  # (C, K, F)

            def compose(left, right):
                a1, b1 = left
                a2, b2 = right
                return a1 * a2, a2 * b1 + b2

            A_full = jnp.broadcast_to(A, mag.shape)
            _, noise_track = jax.lax.associative_scan(
                compose, (A_full, B), axis=1
            )  # prefix B with zero init == the recursion's output (C, K, F)
            sub = jnp.clip(
                power - sub_f * noise_track**sub_e,
                min=0,
            )
            new_frames = jnp.fft.irfft(
                sub ** (1 / sub_e) * jnp.exp(1j * phase),
                axis=-1,
                n=L,
            )

            rec = reconstruct_framed_signal(
                new_frames,
                step_size,
                window,
                original_length,
                safety_threshold=1e-4,
            )
            rec = rec[..., L:-L].T  # (T, C)
            # peak restore (scale-invariant, so fusing it before the
            # amplitude-constraint step changes nothing numerically)
            peak1 = jnp.max(jnp.abs(rec), axis=0)
            return rec * (peak0 / peak1), peak0

        out_td, peak0 = run_jitted_complex(_full, td0, materialize=False)
        self._peak_values = peak0
        return signal.copy_with_new_time_data(out_td)


class Distortion(AudioEffect):
    """Waveshaping distortion, mixable stages
    (`effects.py:553-751`)."""

    def __init__(
        self,
        distortion_level: float = 20,
        post_gain_db: float = 0,
        type_of_distortion: DistortionType = DistortionType.Arctan,
    ):
        super().__init__("Distortion")
        self.set_advanced_parameters(
            type_of_distortion=type_of_distortion,
            distortion_levels_db=distortion_level,
            post_gain_db=post_gain_db,
        )

    def set_advanced_parameters(
        self,
        type_of_distortion=DistortionType.Arctan,
        distortion_levels_db=20,
        mix_percent=100,
        offset_db=-np.inf,
        post_gain_db: float = 0,
    ):
        mix_percent = np.atleast_1d(mix_percent)
        assert np.all(mix_percent <= 100), (
            "No value of mix_percent can be greater than 100"
        )
        self.__select_distortions(type_of_distortion)
        n = len(self._distortion_funcs)
        self.mix = mix_percent / 100
        self.distortion_levels = np.atleast_1d(distortion_levels_db)
        self.offset_db = np.atleast_1d(offset_db)
        if n == 1:
            self._distortion_funcs.append(clean_signal)
            self.mix = np.append(self.mix, 1 - self.mix[0])
            self.distortion_levels = np.append(self.distortion_levels, 0)
            self.offset_db = np.append(self.offset_db, -np.inf)
            n += 1
        assert n == len(self.mix), (
            "Length of mix_percent does not match distortions"
        )
        assert np.isclose(np.sum(self.mix), 1), (
            "mix_percent does not sum up to 100"
        )
        assert n == len(self.distortion_levels), (
            "Length of distortion_levels does not match distortions"
        )
        assert n == len(self.offset_db), (
            "Length of offset_db does not match distortions"
        )
        self.post_gain_db = post_gain_db

    def __select_distortions(self, type_of_distortion):
        if not isinstance(type_of_distortion, list):
            type_of_distortion = [type_of_distortion]
        mapping = {
            DistortionType.Arctan: arctan_distortion,
            DistortionType.HardClip: hard_clip_distortion,
            DistortionType.SoftClip: soft_clip_distortion,
            DistortionType.NoDistortion: clean_signal,
        }
        self._distortion_funcs = []
        for dist in type_of_distortion:
            if dist not in mapping:
                raise ValueError(
                    "The type of distortion is not implemented."
                )
            self._distortion_funcs.append(mapping[dist])

    def _apply_this_effect(self, signal: Signal) -> Signal:
        from .._config import run_maybe_jitted

        td = signal.time_data_jax
        funcs = list(self._distortion_funcs)
        mix = np.asarray(self.mix, np.float64)
        levels = np.asarray(self.distortion_levels, np.float64)
        offsets = np.asarray(self.offset_db, np.float64)
        post_gain_db = (
            0.0 if self.post_gain_db is None else float(self.post_gain_db)
        )

        def prog(tdv):
            # whole chain in one program: no per-stage host round trip
            # (two full-signal transfers each)
            peak_in = jnp.max(jnp.abs(tdv), axis=0)
            new = jnp.zeros_like(tdv)
            for i, f in enumerate(funcs):
                if mix[i] == 0.0:
                    continue
                part = f(tdv, levels[i], offsets[i]) * mix[i]
                new = new + part * (
                    peak_in / jnp.max(jnp.abs(part), axis=0)
                )
            return new * 10 ** (post_gain_db / 20), peak_in

        new_td, peak_in = run_maybe_jitted(prog, td)
        self._peak_values = np.asarray(peak_in)
        return signal.copy_with_new_time_data(new_td)


class Compressor(AudioEffect):
    """Dynamic range compressor / expander
    (`effects.py:753-1014`)."""

    def __init__(
        self,
        threshold_dbfs: float = -10,
        attack_time_ms: float = 0.5,
        release_time_ms: float = 20,
        ratio: float = 3,
        relative_to_peak_level: bool = True,
    ):
        super().__init__("Compressor")
        self.__set_parameters(
            threshold_dbfs,
            attack_time_ms,
            release_time_ms,
            ratio,
            relative_to_peak_level,
        )
        self.set_advanced_parameters()

    def __set_parameters(
        self,
        threshold_dbfs,
        attack_time_ms,
        release_time_ms,
        ratio,
        relative_to_peak_level,
    ):
        if threshold_dbfs is not None:
            if threshold_dbfs > 0:
                warn(
                    "Threshold is above 0 dBFS, this might lead to "
                    "unexpected results"
                )
            self.threshold_dbfs = threshold_dbfs
        if attack_time_ms is not None:
            assert attack_time_ms >= 0, "Attack time has to be 0 or above"
            self.attack_time_ms = attack_time_ms
        if release_time_ms is not None:
            assert release_time_ms >= 0, "Release time has to be 0 or above"
            self.release_time_ms = release_time_ms
        if ratio is not None:
            assert ratio >= 1, "Compression ratio must be above 1"
            self.ratio = ratio
        if relative_to_peak_level is not None:
            self.relative_to_peak_level = relative_to_peak_level

    def set_parameters(
        self,
        threshold_dbfs=None,
        attack_time_ms=None,
        release_time_ms=None,
        ratio=None,
        relative_to_peak_level=None,
    ):
        self.__set_parameters(
            threshold_dbfs,
            attack_time_ms,
            release_time_ms,
            ratio,
            relative_to_peak_level,
        )

    def set_advanced_parameters(
        self,
        knee_factor_db: float = 0,
        pre_gain_db: float = 0,
        post_gain_db: float = 0,
        mix_percent: float = 100,
        automatic_make_up_gain: bool = True,
        downward_compression: bool = True,
    ):
        assert knee_factor_db >= 0, "Knee factor must be 0 or above"
        self.knee_factor_db = knee_factor_db
        assert 0 < mix_percent <= 100, "Mix percent must be in ]0, 100]"
        self.mix = mix_percent / 100
        self.pre_gain_db = pre_gain_db
        self.post_gain_db = post_gain_db
        self.automatic_make_up_gain = automatic_make_up_gain
        self.downward_compression = downward_compression

    def show_compression(self):
        from ..plots import general_plot

        gains_db = np.linspace(self.threshold_dbfs - 20, 0, 2_000)
        func = get_knee_func(
            self.threshold_dbfs,
            self.ratio,
            self.knee_factor_db,
            self.downward_compression,
        )
        gains_db_after = np.asarray(func(gains_db))
        gains_mixed = 10 ** (gains_db_after / 20) * self.mix + 10 ** (
            gains_db / 20
        ) * (1 - self.mix)
        gains_mixed = 20 * np.log10(gains_mixed)
        fig, ax = general_plot(
            gains_db,
            gains_db,
            log_x=False,
            xlabel="Input Gain / dB",
            ylabel="Output Gain / dB",
        )
        ax.plot(gains_db, gains_mixed)
        ax.axvline(
            self.threshold_dbfs,
            alpha=0.5,
            color="xkcd:greenish",
            linestyle="dashed",
        )
        ax.axhline(
            self.threshold_dbfs,
            alpha=0.5,
            color="xkcd:greenish",
            linestyle="dashed",
        )
        ax.legend(["Input", "Output", "Threshold"])
        fig.tight_layout()
        return fig, ax

    def _apply_this_effect(self, signal: Signal) -> Signal:
        fs_hz = signal.sampling_rate_hz
        td = signal.time_data_jax  # whole chain device-resident
        td = self._add_gain_in_db(td, self.pre_gain_db)
        self._save_rms_values(td)
        self._save_peak_values(td)
        if self.relative_to_peak_level:
            td = td / self._peak_values
        attack_samples = int(self.attack_time_ms * 1e-3 * fs_hz)
        release_samples = int(self.release_time_ms * 1e-3 * fs_hz)
        compressed = compressor_core(
            td,
            self.threshold_dbfs,
            self.ratio,
            self.knee_factor_db,
            attack_samples,
            release_samples,
            self.mix,
            self.downward_compression,
        )
        # NB: the reference accepts `mix_compressed` but never applies it
        # (`_effects.py:119-148` ignores the argument), and its
        # "post-compression gain" re-applies `pre_gain_db`
        # (`effects.py:1011-1012`); both quirks are mirrored for parity.
        td = compressed
        if self.relative_to_peak_level:
            td = td * self._peak_values
        if self.automatic_make_up_gain:
            td = self._restore_rms_values(td)
        td = self._add_gain_in_db(td, self.pre_gain_db)
        return signal.copy_with_new_time_data(td)


class Tremolo(AudioEffect):
    """LFO amplitude modulation (`effects.py:1016-1103`)."""

    def __init__(self, depth: float = 0.5, modulator=None):
        super().__init__("Modulation effect: Tremolo")
        if modulator is None:
            modulator = LFO(1, "harmonic")
        self.__set_parameters(depth, modulator)

    def __set_parameters(self, depth, modulator):
        if modulator is not None:
            assert isinstance(modulator, (LFO, np.ndarray)), (
                "Unsupported modulator type. Use LFO or numpy.ndarray"
            )
            if isinstance(modulator, np.ndarray):
                modulator = modulator.squeeze()
                assert modulator.ndim == 1, (
                    "Modulator signal can have only one channel"
                )
            self.modulator = modulator
        if depth is not None:
            if isinstance(self.modulator, LFO):
                assert 0 < depth <= 1, "Depth must be in ]0, 1]"
            self.depth = depth

    def set_parameters(self, depth=None, modulator=None):
        self.__set_parameters(depth, modulator)

    def _apply_this_effect(self, signal: Signal) -> Signal:
        if isinstance(self.modulator, LFO):
            modulation = self.modulator.get_waveform(
                signal.sampling_rate_hz, len(signal)
            )
        else:
            modulation = np.asarray(
                pad_trim_axis(
                    jnp.asarray(self.modulator.copy()), len(signal), axis=-1
                )
            )
        modulation = np.abs(modulation * self.depth + 1)
        return signal.copy_with_new_time_data(
            signal.time_data * modulation[..., None]
        )


class Chorus(AudioEffect):
    """Multi-voice modulated delay (`effects.py:1105-1323`). The per-sample
    voice loop becomes one gather over a static (T, V) delay-index tensor."""

    def __init__(
        self,
        depths_ms=5,
        base_delays_ms=15,
        modulators=None,
        mix_percent: float = 100,
    ):
        super().__init__("Modulation effect: Chorus/Flanger")
        if modulators is None:
            modulators = LFO(2, "harmonic", random_phase=True)
        self.__set_parameters(
            depths_ms, base_delays_ms, modulators, mix_percent
        )

    def __set_parameters(
        self, depths_ms, base_delays_ms, modulators, mix_percent
    ):
        nv_base = nv_depths = nv_mod = 0
        if base_delays_ms is not None:
            base_delays_ms = np.atleast_1d(base_delays_ms)
            nv_base = len(base_delays_ms)
        else:
            nv_base = len(self.base_delays_ms)
        if depths_ms is not None:
            depths_ms = np.atleast_1d(depths_ms)
            nv_depths = len(depths_ms)
        else:
            nv_depths = len(self.depths_ms)
        if modulators is not None:
            if isinstance(modulators, (list, tuple)):
                nv_mod = len(modulators)
            elif isinstance(modulators, np.ndarray):
                # docstring contract: (time samples, voice) — a 1D array
                # is ONE voice's modulation, not T voices
                if modulators.ndim == 1:
                    modulators = modulators[:, None]
                nv_mod = modulators.shape[1]
            else:
                nv_mod = 1
        else:
            nv_mod = (
                self.modulators.shape[1]
                if isinstance(self.modulators, np.ndarray)
                else len(self.modulators)
            )
        self.number_of_voices = max(nv_base, nv_depths, nv_mod)

        if base_delays_ms is not None:
            assert np.all(base_delays_ms > 0), "Base delays must be above 0"
            assert len(base_delays_ms) in (1, self.number_of_voices), (
                "Base delays can only be length 1 or number of voices"
            )
            self.base_delays_ms = base_delays_ms
            if len(self.base_delays_ms) == 1:
                self.base_delays_ms = np.repeat(
                    self.base_delays_ms, self.number_of_voices
                )
        if modulators is not None:
            assert isinstance(modulators, (LFO, list, tuple, np.ndarray)), (
                "Unsupported modulators type. Use LFO or numpy.ndarray"
            )
            if isinstance(modulators, np.ndarray):
                self.modulators = modulators
            elif isinstance(modulators, LFO):
                self.modulators = [modulators] * self.number_of_voices
            else:
                assert len(modulators) in (1, self.number_of_voices), (
                    "The number of modulators signals does not match the "
                    f"number of voices {self.number_of_voices}"
                )
                assert all(isinstance(i, LFO) for i in modulators), (
                    "All modulators signals have to be of type LFO"
                )
                self.modulators = list(modulators)
                if len(self.modulators) == 1:
                    self.modulators = (
                        [self.modulators[0]] * self.number_of_voices
                    )
        if depths_ms is not None:
            self.depths_ms = np.atleast_1d(depths_ms)
            assert len(self.depths_ms) in (1, self.number_of_voices), (
                "Depth must be of length 1 or number of voices "
                f"{self.number_of_voices}"
            )
            if len(self.depths_ms) == 1:
                self.depths_ms = np.repeat(
                    self.depths_ms, self.number_of_voices
                )
        if mix_percent is not None:
            mix_percent /= 100
            assert 0 < mix_percent <= 1, (
                "Mix percent must be below 100 and above 0"
            )
            self.mix = mix_percent

    def set_parameters(
        self,
        depths_ms=None,
        base_delays_ms=None,
        modulators=None,
        mix_percent=None,
    ):
        self.__set_parameters(
            depths_ms, base_delays_ms, modulators, mix_percent
        )

    def _apply_this_effect(self, signal: Signal) -> Signal:
        fs = signal.sampling_rate_hz
        le = len(signal)
        if not isinstance(self.modulators, np.ndarray):
            modulation = np.zeros((le, self.number_of_voices))
            for ind, m in enumerate(self.modulators):
                modulation[:, ind] = (
                    m.get_waveform(fs, le) * self.depths_ms[ind]
                    + self.base_delays_ms[ind]
                )
        else:
            modulation = np.asarray(
                pad_trim_axis(
                    jnp.asarray(self.modulators.copy()), le, axis=0
                )
            )
        modulation = np.round(modulation * 1e-3 * fs).astype(int)
        max_delay = int(np.abs(modulation).max())

        td = pad_trim_axis(signal.time_data_jax, le + max_delay, axis=0)
        self._save_peak_values(np.asarray(td))
        T_eff = td.shape[0] - max_delay
        idx = np.arange(T_eff)[:, None] + modulation[:T_eff]  # (T_eff, V)
        gathered = td[jnp.asarray(idx), :]  # (T_eff, V, C)
        new_head = td[:T_eff] + jnp.sum(gathered, axis=1)
        new_td = jnp.concatenate(
            [new_head, jnp.zeros_like(td[T_eff:])], axis=0
        )
        new_td = new_td * self.mix + td * (1 - self.mix)
        out = self._restore_peak_values(
            np.asarray(pad_trim_axis(new_td, le, axis=0))
        )
        return signal.copy_with_new_time_data(out)


def _sat_digital(x):
    return x


def _sat_arctan(x):
    return 0.5 * jnp.arctan(2 * x)


class DigitalDelay(AudioEffect):
    """Feedback delay line (`effects.py:1326-1473`). The comb recursion runs
    as a `lax.scan` over delay-sized blocks."""

    def __init__(self, delay_time_ms: float = 300, feedback: float = 0.1):
        super().__init__("Digital Delay")
        self.__set_parameters(delay_time_ms, feedback)
        self.set_advanced_parameters()

    def __set_parameters(self, delay_time_ms, feedback):
        assert delay_time_ms > 0, "Delay time must be larger than 0"
        self.delay_ms = delay_time_ms
        assert feedback > 0, "Feedback must be larger than one"
        self.feedback = feedback

    def set_parameters(self, delay_time_ms=None, feedback=None):
        if delay_time_ms is None:
            delay_time_ms = self.delay_ms
        if feedback is None:
            feedback = self.feedback
        self.__set_parameters(delay_time_ms, feedback)

    def set_advanced_parameters(self, saturation: str | None = None):
        if saturation is None:
            saturation = "digital"
        if callable(saturation):
            # store the user callable itself: the delay's compiled program
            # is cached keyed on this object, and a wrapping lambda would
            # defeat the cache (and leak an entry) on every reassignment
            self.saturation_func = saturation
            return
        saturation = saturation.lower()
        # module-level functions, NOT per-instance lambdas: the delay's
        # compiled program is cached keyed on the saturator object, so all
        # instances using a named saturation share one compilation
        if saturation == "digital":
            self.saturation_func = _sat_digital
        elif saturation == "arctan":
            self.saturation_func = _sat_arctan
        else:
            raise ValueError("Saturation function might not be valid")

    def plot_delay(self):
        from ..plots import general_plot

        fs = 2_000
        delay_samples = int(round(self.delay_ms * 1e-3 * fs))
        imp = np.zeros(delay_samples * 10)
        imp[0] = 1
        for i in np.arange(delay_samples, len(imp)):
            imp[i] = imp[i] + self.feedback * float(
                np.asarray(self.saturation_func(imp[i - delay_samples]))
            )
        imp = np.asarray(to_db(jnp.asarray(imp), True))
        x = np.arange(len(imp)) / fs * 1e3
        fig, ax = general_plot(
            x,
            imp[..., None],
            log_x=False,
            xlabel="Time / ms",
            ylabel="Amplitude [dB]",
        )
        ax.set_ylim([-100, 1])
        ax.set_title("Delay – Repetitions decay")
        fig.tight_layout()
        return fig, ax

    def _apply_this_effect(self, signal: Signal) -> Signal:
        D = int(round(self.delay_ms * 1e-3 * signal.sampling_rate_hz))
        assert D >= 1, (
            f"delay_time_ms={self.delay_ms} rounds to zero samples at "
            f"{signal.sampling_rate_hz} Hz"
        )
        td = signal.time_data_jax
        self._save_peak_values(td)
        padding = int(D * (1 + self.feedback * 15))
        total = td.shape[0] + padding
        n_blocks = int(np.ceil(total / D))
        x = pad_trim_axis(td, n_blocks * D, axis=0)
        xb = x.reshape(n_blocks, D, -1)
        fb = self.feedback
        sat = self.saturation_func
        try:
            jax.eval_shape(
                sat, jax.ShapeDtypeStruct((2, 2), jnp.float32)
            )
        except Exception as e:
            raise ValueError(
                "The saturation function must be traceable over jax "
                "arrays (use jnp operations — it is applied to whole "
                f"delay blocks on device): {e}"
            ) from None

        from ..classes.signal import _dev_jit

        def _prog(xb_in):
            def step(prev_block, x_blk):
                y_blk = x_blk + fb * sat(prev_block)
                return y_blk, y_blk

            _, yb = jax.lax.scan(step, jnp.zeros_like(xb_in[0]), xb_in)
            return yb.reshape(-1, xb_in.shape[-1])

        # cached jit (the eager scan re-traced on every call); keying on
        # the saturation function object keeps it alive and correct for
        # user-swapped saturators
        y = _dev_jit(
            ("digital_delay", D, n_blocks, float(fb), sat), _prog
        )(xb)[:total]
        y = self._restore_peak_values(y)
        return signal.copy_with_new_time_data(y)  # device-resident
