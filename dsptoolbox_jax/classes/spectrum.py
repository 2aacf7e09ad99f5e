"""Spectrum: frequency-domain container with interpolation engine.

Behavioral reference: `dsptoolbox/classes/spectrum.py`. Frequency vectors are
static host numpy (they define shapes/grids); spectral data is a jax array.
Interpolations onto new grids are static linear operators (gather+lerp for
linear, cached spline operator matmuls for cubic, native PCHIP kernel),
applied on device.
"""

from __future__ import annotations

from copy import deepcopy
from functools import lru_cache
from pickle import HIGHEST_PROTOCOL, dump

import jax.numpy as jnp
import numpy as np

from .._config import default_complex, default_float
from ..helpers.gain_and_level import from_db, to_db
from ..helpers.interpolation import linear_interpolate, pchip_interpolate
from ..helpers.other import check_format_in_path
from ..helpers.smoothing import fractional_octave_smoothing
from ..helpers.spectrum_utilities import warp_frequency_vector
from ..standard.enums import (
    FilterBankMode,
    FrequencySpacing,
    InterpolationDomain,
    InterpolationEdgeHandling,
    InterpolationScheme,
    MagnitudeNormalization,
    SpectrumType,
    Window,
)
from ._multichannel import MultichannelData


@lru_cache(maxsize=32)
def _cubic_operator(f_key: tuple, fq_key: tuple) -> np.ndarray:
    """Static CubicSpline (not-a-knot) interpolation operator."""
    from scipy.interpolate import CubicSpline

    f = np.asarray(f_key)
    fq = np.asarray(fq_key)
    eye = np.eye(len(f))
    return np.asarray(CubicSpline(f, eye, axis=0)(fq))


class Spectrum(MultichannelData):
    def __init__(self, frequency_vector_hz, spectral_data):
        """Complex or magnitude spectrum over an arbitrary frequency grid
        (`classes/spectrum.py:32-54`)."""
        self.frequency_vector_hz = frequency_vector_hz
        self.spectral_data = spectral_data
        self.set_interpolator_parameters()

    # ======== Constructors ==================================================
    @staticmethod
    def from_signal(sig, complex: bool = False) -> "Spectrum":
        """Spectrum of a Signal via its `get_spectrum()`
        (`classes/spectrum.py:56-89`)."""
        if complex:
            assert sig.spectrum_scaling.outputs_complex_spectrum(
                sig.spectrum_method
            ), "Method or scaling do not deliver a complex spectrum"

        f, sp = sig.get_spectrum()
        # keep host/device placement as-is: the spectral_data setter decides
        # where the data lives (no eager jnp.asarray here)
        if complex:
            assert np.iscomplexobj(sp) or jnp.iscomplexobj(sp), (
                "Spectrum of signal is not complex"
            )
            return Spectrum(f, sp)
        mag = np.abs(np.asarray(sp))
        return Spectrum(
            f,
            (
                mag
                if sig.spectrum_scaling.is_amplitude_scaling()
                else mag**0.5
            ),
        )

    @staticmethod
    def from_filter(
        frequency_vector_hz, filt, complex: bool = False
    ) -> "Spectrum":
        data = filt.get_transfer_function(np.asarray(frequency_vector_hz))
        return Spectrum(
            frequency_vector_hz, data if complex else np.abs(data)
        )

    @staticmethod
    def from_filterbank(
        frequency_vector_hz,
        filter_bank,
        mode: FilterBankMode,
        complex: bool = False,
    ) -> "Spectrum":
        freqs = np.asarray(frequency_vector_hz)
        tfs = np.stack(
            [f.get_transfer_function(freqs) for f in filter_bank.filters],
            axis=1,
        )
        if mode == FilterBankMode.Summed:
            tfs = np.sum(tfs, axis=1, keepdims=True)
        elif mode == FilterBankMode.Sequential:
            tfs = np.prod(tfs, axis=1, keepdims=True)
        return Spectrum(freqs, tfs if complex else np.abs(tfs))

    # ======== Properties ====================================================
    @property
    def frequency_vector_hz(self) -> np.ndarray:
        return self.__frequency_vector_hz

    @frequency_vector_hz.setter
    def frequency_vector_hz(self, new_freqs):
        new_freqs = np.asarray(new_freqs, dtype=np.float64).reshape(-1)
        assert np.all(np.ediff1d(new_freqs) > 0), (
            "Frequency vector must be strictly increasing"
        )
        self.__frequency_vector_hz = new_freqs
        self.__freq_type = Spectrum.__check_frequency_vector_type(new_freqs)

    @property
    def frequency_vector_type(self) -> FrequencySpacing:
        return self.__freq_type

    @property
    def number_frequency_bins(self) -> int:
        return len(self.frequency_vector_hz)

    @property
    def length_frequency_bins(self) -> int:
        return len(self.frequency_vector_hz)

    @staticmethod
    def _host2d(x) -> np.ndarray:
        """Host 2-D numpy view of spectral data."""
        return np.atleast_2d(np.asarray(x))

    @property
    def spectral_data(self) -> np.ndarray:
        """Spectral data ``(F, C)`` as the internal WRITABLE host numpy
        array — in-place mutation writes through, exactly like the
        reference getter (`classes/spectrum.py:219-230`; its own tests
        mutate it, `tests/test_filterbanks.py:105`). Device consumers
        upload on use (the arrays are small analysis containers)."""
        return self.__spectral_data

    @spectral_data.setter
    def spectral_data(self, new_data):
        data = self._host2d(new_data)
        assert data.ndim == 2, "Spectral data must have two dimensions"
        if data.shape[0] < data.shape[1]:
            data = data.T
        assert data.shape[0] == len(self.frequency_vector_hz), (
            "Spectral data does not match frequency vector length"
        )
        # reference dtypes: float64 magnitude / complex128 spectra
        self.__spectral_data = data.astype(
            np.complex128 if np.iscomplexobj(data) else np.float64
        )

    @property
    def is_magnitude(self) -> bool:
        return not jnp.iscomplexobj(self.spectral_data)

    @property
    def is_complex(self) -> bool:
        return not self.is_magnitude

    @property
    def spectrum_type(self) -> SpectrumType:
        return (
            SpectrumType.Complex
            if self.is_complex
            else SpectrumType.Magnitude
        )

    @property
    def has_coherence(self) -> bool:
        return hasattr(self, "coherence")

    @staticmethod
    def __check_frequency_vector_type(f_vec_hz) -> FrequencySpacing:
        try:
            if np.all(
                np.isclose(np.ediff1d(f_vec_hz), f_vec_hz[-1] - f_vec_hz[-2])
            ):
                return FrequencySpacing.Linear
            if np.all(
                np.isclose(
                    f_vec_hz[2:] / f_vec_hz[1:-1], f_vec_hz[-1] / f_vec_hz[-2]
                )
            ):
                return FrequencySpacing.Logarithmic
        except Exception:
            pass
        return FrequencySpacing.Other

    # ======== Conversion ====================================================
    def to_signal(
        self, sampling_rate_hz: int, length_seconds: float | None = None
    ):
        """Inverse rFFT back to a Signal, interpolating onto a linear grid if
        needed (`classes/spectrum.py:333-405`)."""
        from ..ops.pad_trim import pad_trim_axis
        from .signal import Signal

        assert not self.is_magnitude, "Spectrum must be complex"

        def td_from_spec(spec):
            time_data = jnp.fft.irfft(spec, axis=0)
            if length_seconds is not None:
                length_samples = int(length_seconds * sampling_rate_hz + 0.5)
                time_data = pad_trim_axis(time_data, length_samples, axis=0)
            return Signal.from_time_data(
                np.asarray(time_data), sampling_rate_hz
            )

        if self.frequency_vector_type == FrequencySpacing.Linear:
            delta_f = self.frequency_vector_hz[1] - self.frequency_vector_hz[0]
            cond_sr = (
                abs(sampling_rate_hz / 2 - self.frequency_vector_hz[-1])
                > delta_f
            )
            cond_start = not np.isclose(self.frequency_vector_hz[0], 0.0)
            if not (cond_sr or cond_start):
                return td_from_spec(self.spectral_data)
            requested = np.arange(
                0.0, sampling_rate_hz / 2 + delta_f / 2.0, delta_f
            )
        else:
            assert length_seconds is not None, "A length must be provided"
            requested = np.fft.rfftfreq(
                int(length_seconds * sampling_rate_hz + 0.5),
                1 / sampling_rate_hz,
            )
        self.set_interpolator_parameters(
            InterpolationDomain.MagnitudePhase,
            InterpolationScheme.Pchip,
            InterpolationEdgeHandling.ZeroPad,
        )
        spectrum = self.get_interpolated_spectrum(
            requested, SpectrumType.Complex
        )
        return td_from_spec(spectrum)

    # ======== In-place transforms ===========================================
    def __freqs_to_slice(
        self, f_lower_hz, f_upper_hz, inclusive: bool
    ) -> slice:
        """Reference-exact boundary handling (`spectrum.py:1030-1057`):
        inclusive extends one bin outward at each given boundary (even past
        a non-exact upper frequency); exclusive always advances past the
        lower boundary bin."""
        f = self.frequency_vector_hz
        n = len(f)
        ind_low = (
            int(np.searchsorted(f, f_lower_hz))
            if f_lower_hz is not None
            else 0
        )
        ind_high = (
            int(np.searchsorted(f, f_upper_hz))
            if f_upper_hz is not None
            else n
        )
        if inclusive:
            if f_upper_hz is not None:
                ind_high = min(ind_high + 1, n)
            if f_lower_hz is not None and f[ind_low] != f_lower_hz:
                ind_low = max(ind_low - 1, 0)
        else:
            if f_lower_hz is not None:
                ind_low += 1
        assert ind_low < ind_high, "Slice is invalid"
        return slice(ind_low, ind_high)

    def trim(
        self,
        f_lower_hz: float | None,
        f_upper_hz: float | None,
        inclusive: bool = True,
    ) -> "Spectrum":
        s = self.__freqs_to_slice(f_lower_hz, f_upper_hz, inclusive)
        data = self.spectral_data[s, ...]
        self.frequency_vector_hz = self.frequency_vector_hz[s]
        self.__spectral_data = data
        return self

    def sum_channels(self, power_sum: bool = True) -> "Spectrum":
        """Power-sum (default) or linear sum over channels
        (`classes/spectrum.py:435-462`)."""
        if power_sum:
            return self._create_copy_with_new_data(
                jnp.sum(
                    jnp.abs(self.spectral_data) ** 2.0, axis=1, keepdims=True
                )
                ** 0.5
            )
        return super().sum_channels()

    def resample(self, new_freqs_hz) -> "Spectrum":
        """Interpolate (inplace) onto a new frequency vector
        (`classes/spectrum.py:463-493`)."""
        self.set_interpolator_parameters(
            (
                InterpolationDomain.Power
                if self.is_magnitude
                else InterpolationDomain.MagnitudePhase
            ),
            self.__int_scheme,
            self.__int_edges,
        )
        new_sp = self.get_interpolated_spectrum(
            np.asarray(new_freqs_hz),
            (
                SpectrumType.Magnitude
                if self.is_magnitude
                else SpectrumType.Complex
            ),
        )
        self.frequency_vector_hz = new_freqs_hz
        self.__spectral_data = self._host2d(new_sp).astype(
            np.complex128 if np.iscomplexobj(new_sp) else np.float64
        )
        return self

    def normalize(
        self,
        reference_frequency_hz: float,
        reference_channel: int | None = None,
    ) -> "Spectrum":
        values = self.get_interpolated_spectrum(
            np.array([reference_frequency_hz]), SpectrumType.Magnitude
        )
        norm = (
            values
            if reference_channel is None
            else values[0, reference_channel]
        )
        self.__spectral_data = self.spectral_data / self._host2d(norm)
        return self

    def apply_gain(self, gain_db) -> "Spectrum":
        gains = np.atleast_1d(gain_db)
        assert len(gains) == 1 or len(gains) == self.number_of_channels, (
            "Number of gains is not compatible"
        )
        self.__spectral_data = self.spectral_data * np.asarray(
            from_db(gains, True), dtype=self.spectral_data.real.dtype
        )
        return self

    # ======== Interpolation engine ==========================================
    def set_interpolator_parameters(
        self,
        domain: InterpolationDomain = InterpolationDomain.Power,
        scheme: InterpolationScheme = InterpolationScheme.Linear,
        edges_handling: InterpolationEdgeHandling = (
            InterpolationEdgeHandling.ZeroPad
        ),
    ) -> "Spectrum":
        if domain in (
            InterpolationDomain.Complex,
            InterpolationDomain.MagnitudePhase,
        ):
            assert not self.is_magnitude, (
                "No complex interpolation is possible with this data"
            )
        self.__int_domain = domain
        self.__int_scheme = scheme
        self.__int_edges = edges_handling
        return self

    def _interp_1(self, data: jnp.ndarray, fq: np.ndarray) -> jnp.ndarray:
        """One real-valued interpolation pass onto static ``fq`` (edges are
        handled by the caller)."""
        f = self.frequency_vector_hz
        if self.__int_scheme == InterpolationScheme.Linear:
            return linear_interpolate(f, data, fq, axis=0)
        if self.__int_scheme == InterpolationScheme.Pchip:
            return pchip_interpolate(f, data, fq, axis=0)
        if len(f) <= 4096:
            # small grids: static (Fq, F) operator -> one device matmul
            A = _cubic_operator(tuple(f.tolist()), tuple(fq.tolist()))
            return jnp.asarray(A, dtype=data.dtype) @ data
        # large (FFT-resolution) grids: the dense operator would be O(F^2)
        # memory (tens of GB at 100k bins) — evaluate the spline directly
        from scipy.interpolate import CubicSpline

        out = CubicSpline(f, np.asarray(data), axis=0)(fq)
        return jnp.asarray(out, dtype=data.dtype)

    def get_interpolated_spectrum(
        self, requested_frequency, output_type: SpectrumType
    ):
        """Interpolated spectrum at given frequencies
        (`classes/spectrum.py:544-686`)."""
        fq = np.asarray(requested_frequency, dtype=np.float64).reshape(-1)
        f = self.frequency_vector_hz
        if output_type == SpectrumType.Complex:
            assert not self.is_magnitude, "Complex output is not supported"

        outside_left = fq < f[0]
        outside_right = fq > f[-1]
        if self.__int_edges == InterpolationEdgeHandling.Error:
            assert 0 == np.sum(outside_left | outside_right), (
                "Frequencies are not in the given range and edge handling "
                "does not support it"
            )

        dom = self.__int_domain
        data_imag = None
        if dom == InterpolationDomain.Power:
            data = (
                self.spectral_data**2.0
                if self.is_magnitude
                else jnp.abs(self.spectral_data) ** 2.0
            )
        elif dom == InterpolationDomain.Magnitude:
            data = (
                self.spectral_data
                if self.is_magnitude
                else jnp.abs(self.spectral_data)
            )
        elif dom == InterpolationDomain.Complex:
            data = jnp.real(self.spectral_data)
            data_imag = jnp.imag(self.spectral_data)
        else:  # MagnitudePhase
            data = jnp.abs(self.spectral_data)
            data_imag = jnp.unwrap(jnp.angle(self.spectral_data), axis=0)

        out = self._interp_1(data, fq)
        out_imag = (
            self._interp_1(data_imag, fq) if data_imag is not None else None
        )

        # edge fill
        if self.__int_edges == InterpolationEdgeHandling.ZeroPad:
            left_val = right_val = jnp.zeros_like(data[0])
        elif self.__int_edges == InterpolationEdgeHandling.OnePad:
            left_val = right_val = jnp.ones_like(data[0])
        else:  # Extend / Error (already validated)
            left_val = data[0]
            right_val = data[-1]
        lmask = jnp.asarray(outside_left)[:, None]
        rmask = jnp.asarray(outside_right)[:, None]
        out = jnp.where(lmask, left_val[None], out)
        out = jnp.where(rmask, right_val[None], out)
        if out_imag is not None:
            # parity: the reference overwrites the *combined* output with the
            # edge value after combining — reproduce by combining first
            if dom == InterpolationDomain.Complex:
                comb = out + 1j * out_imag
            else:
                comb = out * jnp.exp(1j * out_imag)
            comb = jnp.where(lmask, left_val[None].astype(comb.dtype), comb)
            comb = jnp.where(rmask, right_val[None].astype(comb.dtype), comb)
            output = comb
        else:
            output = out

        if output_type == SpectrumType.Complex:
            return output
        if output_type == SpectrumType.Db:
            if dom.is_complex():
                return to_db(jnp.abs(output), True)
            return to_db(output, dom.is_linear())
        if output_type == SpectrumType.Power:
            if dom.is_complex():
                return jnp.abs(output) ** 2.0
            if dom.is_linear():
                return output**2.0
            return output
        if output_type == SpectrumType.Magnitude:
            if dom.is_complex():
                return jnp.abs(output)
            if dom.is_linear():
                return output
            return output**0.5
        raise ValueError("Some unexpected case happened!")

    # ======== Analysis ======================================================
    def get_energy(
        self, f_lower_hz: float | None = None, f_upper_hz: float | None = None
    ):
        """Trapezoidal energy integral over a frequency region
        (`classes/spectrum.py:726-761`)."""
        region = self.__freqs_to_slice(f_lower_hz, f_upper_hz, True)
        power = (
            self.spectral_data[region] ** 2.0
            if self.is_magnitude
            else jnp.abs(self.spectral_data[region]) ** 2.0
        )
        x = jnp.asarray(self.frequency_vector_hz[region])
        dx = (x[1:] - x[:-1])[:, None]
        return jnp.sum((power[1:] + power[:-1]) / 2.0 * dx, axis=0)

    def warp(
        self, warping_factor: float, sampling_rate_hz: int
    ) -> "Spectrum":
        """Warp the frequency vector (`classes/spectrum.py:762-804`)."""
        if not np.isclose(
            sampling_rate_hz / 2, self.frequency_vector_hz[-1]
        ):
            assert sampling_rate_hz / 2 >= self.frequency_vector_hz[-1], (
                "Invalid sampling rate for frequency vector"
            )
        self.frequency_vector_hz = warp_frequency_vector(
            self.frequency_vector_hz, sampling_rate_hz, warping_factor
        )
        return self

    def apply_octave_smoothing(
        self, octave_fraction: float, window_type: Window = Window.Hann
    ) -> "Spectrum":
        """Fractional-octave smoothing in place
        (`classes/spectrum.py:805-869`)."""
        beta = (
            np.log2(
                self.frequency_vector_hz[-1] / self.frequency_vector_hz[-2]
            )
            if self.frequency_vector_type == FrequencySpacing.Logarithmic
            else None
        )
        if self.frequency_vector_type in (
            FrequencySpacing.Linear,
            FrequencySpacing.Logarithmic,
        ):
            data = self.spectral_data
        else:
            new_f = np.linspace(
                self.frequency_vector_hz[0],
                self.frequency_vector_hz[-1],
                int(
                    self.frequency_vector_hz[-1] - self.frequency_vector_hz[0]
                ),
                endpoint=True,
            )
            data = self.get_interpolated_spectrum(
                new_f,
                (
                    SpectrumType.Magnitude
                    if self.is_magnitude
                    else SpectrumType.Complex
                ),
            )
            self.frequency_vector_hz = new_f
        wt = window_type.to_scipy_format()
        if self.is_magnitude:
            self.__spectral_data = self._host2d(
                fractional_octave_smoothing(data, beta, octave_fraction, wt)
            ).astype(np.float64)
            return self
        mag = fractional_octave_smoothing(
            jnp.abs(data), beta, octave_fraction, wt
        )
        ph = fractional_octave_smoothing(
            jnp.unwrap(jnp.angle(data), axis=0), beta, octave_fraction, wt
        )
        from .._config import run_jitted_complex

        re_s, im_s = run_jitted_complex(
            lambda m, p_: (lambda c: (c.real, c.imag))(
                m * jnp.exp(1j * p_)
            ),
            mag,
            ph,
            materialize=False,
        )
        self.__spectral_data = (
            np.asarray(re_s) + 1j * np.asarray(im_s)
        ).astype(np.complex128)
        return self

    def set_coherence(self, coherence) -> "Spectrum":
        coherence = np.asarray(coherence)
        assert coherence.shape == self.spectral_data.shape, (
            "Length of signals and given coherence do not match"
        )
        assert not np.iscomplexobj(coherence), "Coherence cannot be complex"
        self.coherence = coherence
        return self

    # ======== Plots =========================================================
    def plot_magnitude(
        self,
        in_db: bool = True,
        normalization: MagnitudeNormalization = (
            MagnitudeNormalization.NoNormalization
        ),
        dynamic_range_db=None,
    ):
        """Magnitude plot (`classes/spectrum.py:887-946`)."""
        range_hz = None
        range_db = dynamic_range_db
        from ..helpers.spectrum_utilities import get_normalized_spectrum
        from ..plots import general_plot

        f, mag_db = get_normalized_spectrum(
            self.frequency_vector_hz,
            (
                self.spectral_data
                if self.is_complex
                else self.spectral_data.astype(default_float())
            ),
            True,
            range_hz,
            normalization,
            0,
            False,
            False,
        )
        mat = np.asarray(mag_db)
        if not in_db:
            mat = 10 ** (mat / 20)
        return general_plot(
            f,
            np.atleast_2d(mat.T).T,
            range_hz,
            range_y=range_db,
            ylabel="Magnitude / " + ("dB" if in_db else "1"),
            labels=[
                f"Channel {n}" for n in range(self.number_of_channels)
            ],
        )

    def plot_coherence(self):
        """Per-channel coherence subplots (`classes/spectrum.py:947-973`)."""
        from ..plots import general_subplots_line

        assert self.has_coherence, "No coherence has been saved"
        return general_subplots_line(
            self.frequency_vector_hz,
            np.asarray(self.coherence),
            sharey=True,
            log_x=True,
            ylabels=[
                rf"$\gamma^2$ Coherence {n}"
                for n in range(self.number_of_channels)
            ],
            xlabels="Frequency / Hz",
            range_y=[-0.1, 1.1],
        )

    # ======== Saving / copying ==============================================
    def save_spectrum(self, path: str):
        path = check_format_in_path(path, "pkl")
        with open(path, "wb") as data_file:
            dump(self, data_file, HIGHEST_PROTOCOL)
        return self

    def copy(self) -> "Spectrum":
        return deepcopy(self)

    # ======== MultichannelData hooks ========================================
    def _get_data(self) -> jnp.ndarray:
        return self.spectral_data

    def _set_data(self, data) -> None:
        self.spectral_data = data

    def _create_copy_with_new_data(self, data) -> "Spectrum":
        new = self.copy()
        new.spectral_data = data
        return new

    def _update_state(self) -> None:
        pass
