"""Signal: the central time-series container.

Behavioral reference: `dsptoolbox/classes/signal.py` (API surface, data
conventions, amplitude constraining, spectrum/CSM/spectrogram parameter
handling). Device redesign:

- ``time_data`` lives as a jax device array ``(T, C)``; all heavy getters
  (`get_spectrum`, `get_csm`, `get_spectrogram`) dispatch to the functional
  ops in `dsptoolbox_jax.ops` (channels-first kernels, jitted & cached by
  static config) and transpose at this boundary.
- No hidden mutable cache flags: a monotonic state counter keys a small memo
  per getter (equivalent observable behavior to the reference's
  ``activate_cache`` logic, `classes/signal.py:163-171`).
- IO and plotting stay host-side.
"""

from __future__ import annotations

from copy import deepcopy
from pickle import HIGHEST_PROTOCOL, dump
from warnings import warn

import jax.numpy as jnp
import numpy as np

from .._config import default_float
from ..helpers.other import check_format_in_path
from ..helpers.spectrum_utilities import get_normalized_spectrum, wrap_phase
from ..ops.pad_trim import pad_trim_axis
from ..ops.spectral import csm_from_spectrum, csm_welch, stft, welch
from ..standard.enums import (
    MagnitudeNormalization,
    SpectrumMethod,
    SpectrumScaling,
    Window,
)
from ._multichannel import MultichannelData

from typing import NamedTuple


class DeviceTimeData(NamedTuple):
    """Real/imaginary device-array pair for device-resident Signal
    construction. The class layer accepts (real, imag) device arrays
    directly, so a device producer hands its result over without a host
    copy.

    ``peak`` optionally carries the precomputed ``max(|real|, |imag|)`` so
    the amplitude-constraint check needs no device fetch (a producing
    program can reduce the peaks of a whole filter bank in one shot)."""

    real: jnp.ndarray
    imag: jnp.ndarray | None = None
    peak: float | None = None


class DeviceSpectralData(NamedTuple):
    """Complex spectral matrix held on the device as a (real, imag) pair.

    Returned by ``cwt``/``vqt``/``Signal.get_spectrogram`` with
    ``return_device=True`` so device-side consumers (synchrosqueezing,
    feature stacks, mel projections) never pay the host fetch — a full
    (bins × T × C) complex scalogram is ~100 MB for a 4 s signal. The
    host-matrix API (the default, reference parity:
    `transforms/transforms.py:687,812`) is unchanged. Composing the
    complex array happens host-side in :meth:`to_numpy`.
    """

    real: jnp.ndarray
    imag: jnp.ndarray

    @property
    def shape(self) -> tuple:
        return self.real.shape

    @property
    def dtype(self):
        return jnp.result_type(self.real.dtype, 1j)

    @property
    def ndim(self) -> int:
        return self.real.ndim

    def complex_device(self) -> jnp.ndarray:
        """Compose the complex array on device."""
        return _dev_jit("compose_complex", lambda r, i: r + 1j * i)(
            self.real, self.imag
        )

    def to_numpy(self) -> np.ndarray:
        """Materialize to a host complex matrix (complex-transfer-safe)."""
        return np.asarray(self.real) + 1j * np.asarray(self.imag)

    def __array__(self, dtype=None):
        out = self.to_numpy()
        return out.astype(dtype) if dtype is not None else out


# Cached device helpers for the setter fast path (module-level jits:
# one compile per shape, not one per call).
_DEV_JIT: dict = {}


def _dev_jit(name, fn):
    import jax

    got = _DEV_JIT.get(name)
    if got is None:
        jitted = jax.jit(fn)

        def call(*args, _jitted=jitted, **kwargs):
            # force-boundary: pending deferred program outputs compute
            # here (one composite launch) before entering a plain jit —
            # keeps every _dev_jit site correct without deferral edits
            from .._defer import DeferredArray, force_value

            if any(isinstance(a, DeferredArray) for a in args):
                args = tuple(force_value(a) for a in args)
            return _jitted(*args, **kwargs)

        got = _DEV_JIT[name] = call
    return got


def _cache_leaf(a):
    """Copy mutable (numpy) leaves before caching — callers may mutate the
    returned arrays; jax device arrays are immutable and alias safely."""
    return np.copy(a) if isinstance(a, np.ndarray) else a


def _deepcopy_alias_device(v, memo):
    """Deepcopy a value tree, ALIASING immutable jax device arrays
    instead of copying them (jax's `Array.__deepcopy__` round-trips the
    buffer through the host)."""
    if isinstance(v, jnp.ndarray) and not isinstance(v, np.ndarray):
        return v
    from .._defer import DeferredArray

    if isinstance(v, DeferredArray):
        # deferred program outputs are immutable once computed; aliasing
        # keeps copies in the same pending DAG instead of cloning nodes
        return v
    if isinstance(v, dict):
        return {k: _deepcopy_alias_device(x, memo) for k, x in v.items()}
    if isinstance(v, list):
        return [_deepcopy_alias_device(x, memo) for x in v]
    if isinstance(v, tuple):
        items = [_deepcopy_alias_device(x, memo) for x in v]
        # NamedTuples (DeviceTimeData/DeviceSpectralData) rebuild by type
        return (
            type(v)(*items) if hasattr(v, "_fields") else tuple(items)
        )
    return deepcopy(v, memo)


class _AliasedTimeData(np.ndarray):
    """Writable host mirror of a Signal's device time data.

    The reference getter returns its internal numpy buffer
    (`classes/signal.py:220`), so callers mutate signals in place
    (``sig.time_data[50, :] = 1.0`` in its own tests,
    `tests/test_transfer_functions.py:333`). A device container cannot
    alias jax memory, so this subclass emulates the contract: item
    assignment and in-place ufuncs on the mirror (or any view of it) push
    the whole buffer back to the device and invalidate the signal's
    spectral caches. Plain reads cost nothing; out-of-place ops return
    ordinary numpy arrays.

    Known gap vs true aliasing (documented in docs/parity_notes.md):
    C-level writes that bypass ``__setitem__``/ufuncs-with-``out``
    (e.g. ``np.copyto``/``nan_to_num(copy=False)``) mutate only the host
    mirror until the next tracked write.
    """

    _owner = None  # root mirror's Signal; propagated to views

    def __array_finalize__(self, obj):
        if obj is not None:
            self._owner = getattr(obj, "_owner", None)

    def _writeback(self):
        owner = self._owner
        if owner is not None:
            owner._sync_host_mirror()

    def __setitem__(self, key, value):
        np.ndarray.__setitem__(self, key, value)
        self._writeback()

    def __array_ufunc__(self, ufunc, method, *inputs, out=None, **kwargs):
        # compute on plain ndarrays, then write back when an output
        # buffer is (a view of) the mirror
        def _plain(x):
            return (
                x.view(np.ndarray) if isinstance(x, _AliasedTimeData) else x
            )

        if out is not None:
            kwargs["out"] = tuple(_plain(o) for o in out)
        results = getattr(ufunc, method)(
            *(_plain(i) for i in inputs), **kwargs
        )
        if out is not None:
            for o in out:
                if isinstance(o, _AliasedTimeData):
                    o._writeback()
            return out[0] if len(out) == 1 else out
        return results


class Signal(MultichannelData):
    """General multichannel audio signal container backed by a device array.

    Time data is stored as ``(time samples, channels)`` like the reference
    (`classes/signal.py:209-222`), in the package default float (fp32 by
    default).
    """

    # ======== Constructor ===================================================
    def __init__(
        self,
        path: str | None = None,
        time_data=None,
        sampling_rate_hz: int | None = None,
        constrain_amplitude: bool = False,
        activate_cache: bool = False,
    ):
        self.constrain_amplitude = constrain_amplitude
        self.calibrated_signal = False
        self.activate_cache = activate_cache
        self._state_counter = 0
        self._cache: dict = {}
        self._host_mirror = None
        self._host_mirror_state = -1
        if path is not None:
            assert time_data is None, (
                "Constructor cannot take a path and a vector at the same time"
            )
            assert sampling_rate_hz is None, (
                "Constructor cannot take a path and a sampling rate at the "
                "same time"
            )
            from ..io import read_audio

            time_data, sampling_rate_hz = read_audio(path)
        else:
            assert time_data is not None, (
                "Either a path to an audio file or a time vector has to be "
                "passed"
            )
            assert sampling_rate_hz is not None, (
                "A sampling rate should be passed!"
            )
        self.sampling_rate_hz = sampling_rate_hz
        self.time_data = time_data
        self.set_spectrum_parameters()
        self.set_spectrogram_parameters()

    @staticmethod
    def from_file(path: str) -> "Signal":
        return Signal(path)

    @staticmethod
    def from_time_data(
        time_data,
        sampling_rate_hz: int,
        constrain_amplitude: bool = True,
    ) -> "Signal":
        return Signal(None, time_data, sampling_rate_hz, constrain_amplitude)

    # ======== State =========================================================
    def __update_state(self):
        self._state_counter += 1
        self._cache.clear()

    # ======== Properties ====================================================
    @property
    def time_data(self) -> np.ndarray:
        """Time data ``(T, C)`` as a writable host MIRROR of the device
        array (API parity with the reference's aliasing getter,
        `classes/signal.py:220`): item assignment and in-place ufuncs on
        the returned array (or views of it) write back to the device and
        invalidate spectral caches — see :class:`_AliasedTimeData` and
        docs/parity_notes.md. Use ``time_data_jax`` for the device
        array."""
        # getattr: objects unpickled from older snapshots lack the slots
        if (
            getattr(self, "_host_mirror", None) is not None
            and self._host_mirror_state == self._state_counter
        ):
            return self._host_mirror
        arr = np.array(self._time_data)  # writable host copy
        mirror = arr.view(_AliasedTimeData)
        mirror._owner = self
        self._host_mirror = mirror
        self._host_mirror_state = self._state_counter
        return mirror

    def _sync_host_mirror(self) -> None:
        """Upload the (mutated) host mirror back to the device.

        Mirrors the reference's aliasing semantics: no amplitude
        re-constraining, the time window is kept; spectral caches are
        invalidated (the reference silently serves stale caches here —
        invalidating is strictly safer)."""
        m = getattr(self, "_host_mirror", None)
        if m is None:
            return
        self._time_data = jnp.asarray(
            np.ascontiguousarray(np.asarray(m)), dtype=default_float()
        )
        self._state_counter += 1
        self._cache.clear()
        self._host_mirror_state = self._state_counter

    @property
    def time_data_jax(self) -> jnp.ndarray:
        """Time data ``(T, C)`` as the underlying jax device array.

        If the data is a pending deferred program output (default lazy
        mode, see :mod:`dsptoolbox_jax._defer`), this forces the flush —
        deferral-aware internal consumers read ``_time_data`` directly to
        keep the chain fused."""
        td = self._time_data
        from .._defer import DeferredArray

        if isinstance(td, DeferredArray):
            td = td.force()
            self._time_data = td
            if isinstance(self._time_data_imag, DeferredArray):
                self._time_data_imag = self._time_data_imag.force()
        return td

    def _assign_device_time_data(self, data) -> None:
        """Setter fast path: the arrays never leave the device (no host
        round trip; semantics identical to the host path below)."""
        from .._defer import DeferredArray, defer_call

        peak_hint = None
        if isinstance(data, DeviceTimeData):
            td, td_imag, peak_hint = data.real, data.imag, data.peak
        elif isinstance(data, DeferredArray):
            # pending program output (real by construction: deferred
            # producers emit split real leaves)
            td, td_imag = data, None
        elif jnp.iscomplexobj(data):
            td, td_imag = _dev_jit("split", lambda z: (z.real, z.imag))(data)
        else:
            td, td_imag = data, None
        assert td.ndim <= 2, (
            f"{td.ndim} are too many dimensions for time data. Dimensions "
            "should be [time samples, channels]"
        )
        if td.ndim < 2:
            td = td.reshape(-1, 1)
        if td.shape[1] > td.shape[0]:
            td = td.T
        if td_imag is not None:
            if td_imag.ndim < 2:
                td_imag = td_imag.reshape(-1, 1)
            if td_imag.shape[1] > td_imag.shape[0]:
                td_imag = td_imag.T
        import jax

        scale = 1.0
        deferred = isinstance(td, DeferredArray) or isinstance(
            td_imag, DeferredArray
        )
        if self.constrain_amplitude and deferred:
            # keep the chain fused: constrain in-program inside the
            # deferred DAG (same arithmetic as the eager path). The host
            # scale-factor metadata stays 1.0 and no over-0-dBFS warning
            # can be emitted — shared semantics with `dsp.pipeline`
            # traces, documented there and in `_defer`.
            if td_imag is None:

                def _constrain1(a):
                    s = jnp.minimum(1.0, 1.0 / jnp.max(jnp.abs(a)))
                    return a * s.astype(a.dtype)

                td = defer_call("assign_constrain1", _constrain1, td)
            else:

                def _constrain2(a, b):
                    peak = jnp.maximum(
                        jnp.max(jnp.abs(a)), jnp.max(jnp.abs(b))
                    )
                    s = jnp.minimum(1.0, 1.0 / peak).astype(a.dtype)
                    return a * s, b * s

                td, td_imag = defer_call(
                    "assign_constrain2", _constrain2, td, td_imag
                )
        elif self.constrain_amplitude and isinstance(td, jax.core.Tracer):
            # under a pipeline trace the peak is not concrete: constrain
            # in-program (same arithmetic, no host fetch). The host-side
            # scale-factor metadata stays 1.0 and no over-0-dBFS warning
            # can be emitted — documented in `dsptoolbox_jax.pipeline`.
            def _constrain(a, b):
                peak = jnp.max(jnp.abs(a))
                if b is not None:
                    peak = jnp.maximum(peak, jnp.max(jnp.abs(b)))
                s = jnp.minimum(1.0, 1.0 / peak).astype(a.dtype)
                return a * s, (None if b is None else b * s)

            td, td_imag = _constrain(td, td_imag)
        elif self.constrain_amplitude:
            if peak_hint is not None:
                peak = float(peak_hint)
            elif td_imag is None:
                peak = float(
                    _dev_jit("peak1", lambda a: jnp.max(jnp.abs(a)))(td)
                )
            else:
                peak = float(
                    _dev_jit(
                        "peak2",
                        lambda a, b: jnp.maximum(
                            jnp.max(jnp.abs(a)), jnp.max(jnp.abs(b))
                        ),
                    )(td, td_imag)
                )
            if peak > 1.0:
                scale = 1.0 / peak
                warn(
                    "Signal was over 0 dBFS, normalizing to 0 dBFS "
                    "peak level was triggered"
                )
                s32 = np.asarray(scale, np.float32)
                mul = _dev_jit("scale", lambda a, s: a * s)
                td = mul(td, s32)
                if td_imag is not None:
                    td_imag = mul(td_imag, s32)
        self.__amplitude_scale_factor = scale
        dt = default_float()
        if deferred:
            cast = lambda a: a.astype(dt)  # noqa: E731 - deferred node
        else:
            cast = _dev_jit(
                ("cast", jnp.dtype(dt).name), lambda a: a.astype(dt)
            )
        self._time_data = td if td.dtype == dt else cast(td)
        self._time_data_imag = (
            None
            if td_imag is None
            else (td_imag if td_imag.dtype == dt else cast(td_imag))
        )
        self.clear_time_window()
        self.__update_state()

    @time_data.setter
    def time_data(self, new_time_data):
        from .._defer import DeferredArray

        if (
            isinstance(new_time_data, (DeviceTimeData, DeferredArray))
            or (
                isinstance(new_time_data, jnp.ndarray)
                and not isinstance(new_time_data, np.ndarray)
            )
        ):
            self._assign_device_time_data(new_time_data)
            return
        td = np.atleast_2d(np.asarray(new_time_data)).squeeze()
        assert td.ndim <= 2, (
            f"{td.ndim} are too many dimensions for time data. Dimensions "
            "should be [time samples, channels]"
        )
        if td.ndim < 2:
            td = td[..., None]
        if td.shape[1] > td.shape[0]:
            td = td.T
        if np.iscomplexobj(td):
            td_imag = np.imag(td)
            td = np.real(td)
        else:
            td_imag = None
        if self.constrain_amplitude:
            td_max = np.max(np.abs(td))
            if td_imag is not None:
                td_max = max(td_max, np.max(np.abs(td_imag)))
            if td_max > 1.0:
                td = td / td_max
                warn(
                    "Signal was over 0 dBFS, normalizing to 0 dBFS "
                    "peak level was triggered"
                )
                if td_imag is not None:
                    td_imag = td_imag / td_max
                self.__amplitude_scale_factor = 1.0 / td_max
            else:
                self.__amplitude_scale_factor = 1.0
        else:
            self.__amplitude_scale_factor = 1.0
        self._time_data = jnp.asarray(td, dtype=default_float())
        self._time_data_imag = (
            jnp.asarray(td_imag, dtype=default_float())
            if td_imag is not None
            else None
        )
        self.clear_time_window()
        self.__update_state()

    @property
    def time_data_imaginary(self) -> np.ndarray | None:
        if self._time_data_imag is None:
            return None
        out = np.asarray(self._time_data_imag)
        if not out.flags.writeable:
            out = out.copy()
        return out

    @time_data_imaginary.setter
    def time_data_imaginary(self, new_imag):
        if new_imag is None:
            self._time_data_imag = None
        elif isinstance(new_imag, jnp.ndarray) and not isinstance(
            new_imag, np.ndarray
        ):
            # device fast path: no host round trip
            if new_imag.ndim < 2:
                new_imag = new_imag.reshape(-1, 1)
            if new_imag.shape[0] < new_imag.shape[1]:
                new_imag = new_imag.T
            assert new_imag.shape == self._time_data.shape, (
                "Imaginary part must match time data shape"
            )
            dt = default_float()
            if new_imag.dtype != dt:
                new_imag = _dev_jit(
                    ("cast", jnp.dtype(dt).name), lambda a: a.astype(dt)
                )(new_imag)
            self._time_data_imag = new_imag
        else:
            new_imag = np.atleast_2d(np.asarray(new_imag))
            if new_imag.shape[0] < new_imag.shape[1]:
                new_imag = new_imag.T
            assert new_imag.shape == self._time_data.shape, (
                "Imaginary part must match time data shape"
            )
            self._time_data_imag = jnp.asarray(new_imag, dtype=default_float())
        self.__update_state()

    @property
    def is_complex_signal(self) -> bool:
        return self._time_data_imag is not None

    @property
    def amplitude_scale_factor(self) -> float:
        return self.__amplitude_scale_factor

    @property
    def sampling_rate_hz(self) -> int:
        return self.__sampling_rate_hz

    @sampling_rate_hz.setter
    def sampling_rate_hz(self, new_sampling_rate_hz):
        assert isinstance(new_sampling_rate_hz, (int, np.integer)), (
            "Sampling rate can only be an integer"
        )
        self.__sampling_rate_hz = int(new_sampling_rate_hz)

    @property
    def length_samples(self) -> int:
        return self._time_data.shape[0]

    @property
    def length_seconds(self) -> float:
        return self.length_samples / self.sampling_rate_hz

    @property
    def time_vector_s(self) -> np.ndarray:
        return np.linspace(
            0,
            self.length_samples / self.sampling_rate_hz,
            self.length_samples,
        )

    @property
    def constrain_amplitude(self) -> bool:
        return self.__constrain_amplitude

    @constrain_amplitude.setter
    def constrain_amplitude(self, nca):
        assert isinstance(nca, bool)
        self.__constrain_amplitude = nca

    @property
    def calibrated_signal(self) -> bool:
        return self.__calibrated_signal

    @calibrated_signal.setter
    def calibrated_signal(self, ncs):
        assert isinstance(ncs, bool)
        self.__calibrated_signal = ncs

    @property
    def metadata(self) -> dict:
        return {
            "sampling_rate_hz": self.sampling_rate_hz,
            "number_of_channels": self.number_of_channels,
            "signal_length_samples": self.length_samples,
            "signal_length_seconds": self.length_seconds,
            "constrain_amplitude": self.constrain_amplitude,
            "amplitude_scale_factor": self.amplitude_scale_factor,
            "is_complex_signal": self.is_complex_signal,
        }

    @property
    def metadata_str(self) -> str:
        txt = "\n"
        for k, v in self.metadata.items():
            txt += f"{str(k).replace('_', ' ').capitalize()}: {v}\n"
        return txt

    def __str__(self):
        return self.metadata_str

    def __iter__(self):
        """Iterate over per-channel column arrays like the reference
        (`classes/signal.py:492-495`). The columns slice one writable host
        copy — mutations do not write back (see docs/parity_notes.md)."""
        td = self.time_data
        return iter(
            [td[:, x] for x in range(self.number_of_channels)]
        )

    # ======== Spectrum configuration ========================================
    def set_spectrum_parameters(
        self,
        method: SpectrumMethod = SpectrumMethod.WelchPeriodogram,
        smoothing: int = 0,
        pad_to_fast_length: bool = True,
        window_length_samples: int = 1024,
        window_type: Window = Window.Hann,
        overlap_percent: float = 50,
        detrend: bool = True,
        average: str = "mean",
        scaling: SpectrumScaling = SpectrumScaling.FFTBackward,
    ) -> "Signal":
        """Configure `get_spectrum` (defaults match the reference,
        `classes/signal.py:497-588`)."""
        new = dict(
            method=method,
            smoothing=smoothing,
            pad_to_fast_length=pad_to_fast_length,
            window_length_samples=window_length_samples,
            window_type=window_type,
            overlap_percent=overlap_percent,
            detrend=detrend,
            average=average,
            scaling=scaling,
        )
        if getattr(self, "_spectrum_parameters", None) != new:
            self._spectrum_parameters = new
            self._cache.pop("spectrum", None)
            self._cache.pop("csm", None)
        return self

    @property
    def spectrum_method(self) -> SpectrumMethod:
        return self._spectrum_parameters["method"]

    @spectrum_method.setter
    def spectrum_method(self, new_method: SpectrumMethod):
        assert isinstance(new_method, SpectrumMethod)
        if self._spectrum_parameters["method"] is new_method:
            return  # unchanged: cached spectra stay valid
        self._spectrum_parameters["method"] = new_method
        self._cache.pop("spectrum", None)
        self._cache.pop("csm", None)

    @property
    def spectrum_scaling(self) -> SpectrumScaling:
        return self._spectrum_parameters["scaling"]

    @spectrum_scaling.setter
    def spectrum_scaling(self, new_scaling: SpectrumScaling):
        assert isinstance(new_scaling, SpectrumScaling)
        self._spectrum_parameters["scaling"] = new_scaling
        self._cache.pop("spectrum", None)
        self._cache.pop("csm", None)

    @property
    def spectrum_smoothing(self) -> int:
        return self._spectrum_parameters["smoothing"]

    @spectrum_smoothing.setter
    def spectrum_smoothing(self, new_smoothing):
        self._spectrum_parameters["smoothing"] = new_smoothing
        self._cache.pop("spectrum", None)

    def set_spectrogram_parameters(
        self,
        window_length_samples: int = 1024,
        window_type: Window = Window.Hann,
        overlap_percent: float = 50.0,
        fft_length_samples: int | None = None,
        detrend: bool = False,
        padding: bool = True,
        scaling: SpectrumScaling = SpectrumScaling.FFTBackward,
    ) -> "Signal":
        """Configure `get_spectrogram` (defaults as in
        `classes/signal.py:706-773`)."""
        new = dict(
            window_length_samples=window_length_samples,
            window_type=window_type,
            overlap_percent=overlap_percent,
            fft_length_samples=fft_length_samples,
            detrend=detrend,
            padding=padding,
            scaling=scaling,
        )
        if getattr(self, "_spectrogram_parameters", None) != new:
            self._spectrogram_parameters = new
            self._cache.pop("spectrogram", None)
            self._cache.pop("spectrogram_power_dev", None)
        return self

    # ======== Channels ======================================================
    def add_channel(
        self,
        path: str | None = None,
        new_time_data=None,
        sampling_rate_hz: int | None = None,
        allow_padding_trimming: bool = True,
    ) -> "Signal":
        """Append channels from a file or an array
        (`classes/signal.py:776-852`)."""
        if path is not None:
            assert new_time_data is None, (
                "Only path or new time data is accepted, not both."
            )
            from ..io import read_audio

            new_time_data, sampling_rate_hz = read_audio(path)
        assert sampling_rate_hz == self.sampling_rate_hz, (
            f"{sampling_rate_hz} does not match {self.sampling_rate_hz} "
            "as the sampling rate"
        )
        td = np.asarray(new_time_data)
        if td.ndim > 2:
            td = td.squeeze()
        assert td.ndim <= 2, "Too many dimensions for time data"
        if td.ndim < 2:
            td = td[..., None]
        if td.shape[1] > td.shape[0]:
            td = td.T
        diff = td.shape[0] - self.length_samples
        if diff != 0:
            txt = "Padding" if diff < 0 else "Trimming"
            if allow_padding_trimming:
                td = np.asarray(
                    pad_trim_axis(jnp.asarray(td), self.length_samples, axis=0)
                )
                warn(
                    f"{txt} has been performed on the end of the new signal "
                    "to match original one."
                )
            else:
                raise AttributeError(
                    f"{td.shape[0]} does not match {self.length_samples}. "
                    "Activate allow_padding_trimming for allowing this "
                    "channel to be added"
                )
        self.time_data = np.concatenate([self.time_data, td], axis=1)
        return self

    def clear_time_window(self) -> "Signal":
        if hasattr(self, "window"):
            del self.window
        return self

    # ======== Heavy getters (device compute) ================================
    def _welch_spectrum_closure(self):
        """Welch spectrum program ``td (T, C) -> (F, C)`` capturing only
        freezable locals (no ``self``) so run_jitted_complex reuses the
        compiled program across calls. Shared by the host and device
        spectrum getters — keep them consistent by construction."""
        p = self._spectrum_parameters
        fs_hz = self.sampling_rate_hz
        wl = p["window_length_samples"]
        wt = p["window_type"]
        ol = p["overlap_percent"]
        det = p["detrend"]
        avg = p["average"]
        scal = p["scaling"]

        def _welch_sp(td):
            return welch(
                td.T,
                None,
                sampling_rate_hz=fs_hz,
                window_length_samples=wl,
                window_type=wt,
                overlap_percent=ol,
                detrend=det,
                average=avg,
                scaling=scal,
            ).T

        return _welch_sp

    def _fft_spectrum_closure(self):
        """FFT spectrum program ``td (T, C) -> (F, C) complex`` plus its
        fft length (shared by host/device getters)."""
        from scipy.fft import next_fast_len

        p = self._spectrum_parameters
        fft_length = (
            next_fast_len(self.length_samples, True)
            if p["pad_to_fast_length"]
            else self.length_samples
        )
        fft_norm = self.spectrum_scaling.fft_norm()
        smoothing = p["smoothing"]
        scaling = self.spectrum_scaling
        has_phys = scaling.has_physical_units()
        fs_hz = self.sampling_rate_hz
        win = np.asarray(self.window) if hasattr(
            self, "window"
        ) and self.window is not None else None

        def _fft_spectrum(td):
            # parity: the reference rfft's `self.time_data`, which is
            # the REAL part only — complex signals keep their imaginary
            # part out of the spectrum (`classes/signal.py:906-911`)
            sp = jnp.fft.rfft(
                td.T,
                axis=-1,
                norm=fft_norm,
                n=fft_length,
            ).T
            if smoothing != 0:
                from ..helpers.smoothing import (
                    fractional_octave_smoothing,
                )

                mag = fractional_octave_smoothing(
                    jnp.abs(sp), None, smoothing, clip_values=True
                )
                ph = fractional_octave_smoothing(
                    jnp.unwrap(jnp.angle(sp), axis=0), None,
                    smoothing,
                )
                sp = mag * jnp.exp(1j * ph)
            if has_phys:
                from ..helpers.spectrum_utilities import scale_spectrum

                sp = scale_spectrum(
                    sp,
                    scaling,
                    fft_length,
                    fs_hz,
                    win,
                )
            return sp

        return _fft_spectrum, fft_length

    def get_spectrum(self, force_computation=False, return_device=False):
        """(freqs, spectrum ``(F, C)``) per the stored parameters.

        Welch → real spectrum; FFT → complex backward-normalized rfft with
        optional smoothing/physical scaling (`classes/signal.py:861-946`).

        ``return_device=True`` leaves the spectrum on the device (complex
        FFT spectra come back as a :class:`DeviceSpectralData` real/imag
        pair, without the mono squeeze) so device-side consumers skip the
        host fetch and its synchronization.
        """
        if return_device:
            if force_computation:
                self._cache.pop("spectrum_dev", None)
            f, re, im = self._get_spectrum_device()
            from .._defer import force_value

            # return_device contract: CONCRETE device arrays
            re, im = force_value(re), force_value(im)
            return f, (re if im is None else DeviceSpectralData(re, im))
        from .._config import lazy_host_returns

        if lazy_host_returns():
            # default API, device-backed: the spectrum stays on the device
            # behind a LazyHostArray that fetches on first host access, so
            # reference-identical chains never pay the round trip for
            # intermediates (fp32 mode only; f64 compat mode stays eager)
            from .lazy_array import LazyHostArray

            if force_computation:
                self._cache.pop("spectrum_dev", None)
                self._cache.pop("spectrum_dev_mono", None)
            f, re, im = self._get_spectrum_device()
            if (
                self.spectrum_method == SpectrumMethod.WelchPeriodogram
                and self.number_of_channels == 1
            ):
                # parity: mono Welch spectra are 1-D (reference squeezes)
                key = self._spectrum_param_key()
                ent = self._cache.get("spectrum_dev_mono")
                if ent is None or ent[0] != key:
                    from .._defer import defer_call

                    ent = (
                        key,
                        defer_call("mono_col0", lambda a: a[:, 0], re),
                    )
                    self._cache["spectrum_dev_mono"] = ent
                re = ent[1]
            return f, LazyHostArray(re, im)
        if not force_computation and "spectrum" in self._cache:
            f, sp = self._cache["spectrum"]
            return f.copy(), sp.copy()
        p = self._spectrum_parameters
        if self.spectrum_method == SpectrumMethod.WelchPeriodogram:
            sp = self._welch_spectrum_closure()(self._time_data)
            # parity: the reference's _welch squeezes its input
            # (`_spectral_methods.py:69`), so mono Welch spectra are 1-D
            # while the FFT branch stays (F, 1)
            if self.number_of_channels == 1:
                sp = sp[:, 0]
            fft_length = p["window_length_samples"]
        else:
            _fft_spectrum, fft_length = self._fft_spectrum_closure()
            sp = _fft_spectrum(self._time_data)
        freqs = np.fft.rfftfreq(fft_length, 1 / self.sampling_rate_hz)
        if self.activate_cache:
            # cache copies of mutable (numpy) leaves: callers may mutate
            # the returned arrays; jax arrays are immutable
            self._cache["spectrum"] = (freqs.copy(), _cache_leaf(sp))
        return freqs, sp

    def _spectrum_param_key(self):
        """Self-validating cache key for the device spectrum/CSM caches:
        parameter dict + window content (the host caches are invalidated
        by the setters; these caches revalidate instead)."""
        p = self._spectrum_parameters
        win = getattr(self, "window", None)
        win_tok = (
            None if win is None else hash(np.asarray(win).tobytes())
        )
        return (tuple(sorted((k, str(v)) for k, v in p.items())), win_tok)

    def _get_spectrum_device(self):
        """Device-resident spectrum: ``(freqs, real (F, C), imag | None)``
        with the arrays left on the device. Internal consumers that keep
        computing on-device (spectral deconvolution) use this instead of
        `get_spectrum` to skip the complex host materialization. Welch
        spectra are real (imag is None);
        no mono squeeze is applied (always ``(F, C)``)."""
        pk = self._spectrum_param_key()
        entry = self._cache.get("spectrum_dev")
        if entry is not None and entry[0] == pk:
            _, f, re, im = entry
            return f.copy(), re, im
        from .._config import run_jitted_complex

        fs = self.sampling_rate_hz
        if self.spectrum_method == SpectrumMethod.WelchPeriodogram:
            _welch_sp = self._welch_spectrum_closure()
            re = run_jitted_complex(
                _welch_sp,
                self._time_data,
                materialize=False,
                defer=True,
                key=("sig_welch_spectrum", fs, pk),
            )
            im = None
            fft_length = self._spectrum_parameters["window_length_samples"]
        else:
            _fft_spectrum, fft_length = self._fft_spectrum_closure()

            def _fft_spectrum_split(td):
                sp = _fft_spectrum(td)
                return sp.real, sp.imag

            re, im = run_jitted_complex(
                _fft_spectrum_split,
                self._time_data,
                materialize=False,
                defer=True,
                key=("sig_fft_spectrum", fs, pk),
            )
        freqs = np.fft.rfftfreq(fft_length, 1 / fs)
        self._cache["spectrum_dev"] = (pk, freqs, re, im)
        return freqs.copy(), re, im

    def _csm_welch_closure(self):
        """Welch CSM program ``td (T, C) -> (f, (F, C, C))`` capturing only
        freezable locals (shared by the host and device CSM getters)."""
        p = self._spectrum_parameters
        fs_hz = self.sampling_rate_hz
        wl = p["window_length_samples"]
        wt = p["window_type"]
        ol = p["overlap_percent"]
        det = p["detrend"]
        avg = p["average"]
        scal = p["scaling"]

        def _csm(td):
            return csm_welch(
                td.T,
                sampling_rate_hz=fs_hz,
                window_length_samples=wl,
                window_type=wt,
                overlap_percent=ol,
                detrend=det,
                average=avg,
                scaling=scal,
            )

        return _csm

    def get_csm(self, force_computation=False, mesh=None,
                return_device=False):
        """(freqs, csm ``(F, C, C)``) — one batched einsum on device
        (`classes/signal.py:948-1007`; kernel `ops/spectral.py`).

        ``mesh``: optional `jax.sharding.Mesh`. With more than one device,
        the Welch CSM runs channel-parallel across the mesh's first axis
        (row-parallel Gram matrix, `parallel.ops.parallel_csm`): each
        device computes its channel block's windowed spectra locally,
        `all_gather`s them, and forms its rows with one local
        einsum. Multi-chip is a kwarg, not a rewrite.

        ``return_device=True`` returns the CSM as a
        :class:`DeviceSpectralData` (real/imag device pair) — no host
        fetch at all for device-side consumers."""
        assert self.number_of_channels > 1, (
            "Cross spectral matrix can only be computed when at least two "
            "channels are available"
        )
        if return_device:
            if force_computation:
                self._cache.pop("csm_dev", None)
            f, re, im = self._get_csm_device()
            from .._defer import force_value

            # return_device contract: CONCRETE device arrays
            return f, DeviceSpectralData(force_value(re), force_value(im))
        if mesh is not None and mesh.devices.size > 1:
            return self._get_csm_mesh(mesh)
        from .._config import lazy_host_returns

        if (
            lazy_host_returns()
            and self.spectrum_method == SpectrumMethod.WelchPeriodogram
        ):
            from .lazy_array import LazyHostArray

            if force_computation:
                self._cache.pop("csm_dev", None)
            f, re, im = self._get_csm_device()
            return f, LazyHostArray(re, im)
        if not force_computation and "csm" in self._cache:
            f, csm = self._cache["csm"]
            return f.copy(), csm.copy()
        if self.spectrum_method == SpectrumMethod.WelchPeriodogram:
            f, csm = self._csm_welch_closure()(self._time_data)
        else:
            old_scaling = self.spectrum_scaling
            self._spectrum_parameters["scaling"] = SpectrumScaling.FFTBackward
            self._cache.pop("spectrum", None)
            f, sp = self.get_spectrum()
            self._spectrum_parameters["scaling"] = old_scaling
            self._cache.pop("spectrum", None)

            win = getattr(self, "window", None)
            win = np.asarray(win) if win is not None else None
            fs_hz = self.sampling_rate_hz

            csm = csm_from_spectrum(sp, old_scaling, win, fs_hz)
        if self.activate_cache:
            self._cache["csm"] = (_cache_leaf(f), _cache_leaf(csm))
        return f, csm

    def _get_csm_mesh(self, mesh):
        """Channel-parallel Welch CSM over a device mesh. The channel axis
        is zero-padded to a mesh-divisible count (zero channels produce
        zero CSM rows/columns) and the result is trimmed back. Bypasses
        the host cache — callers opting into mesh execution recompute.
        Mean averaging only (median needs the global frame population)."""
        p = self._spectrum_parameters
        assert (
            self.spectrum_method == SpectrumMethod.WelchPeriodogram
        ), "mesh-parallel CSM is only available for the Welch method"
        assert str(p["average"]).lower().endswith("mean"), (
            "mesh-parallel CSM supports mean averaging only (median needs "
            "every frame on every device)"
        )
        from ..parallel.ops import parallel_csm

        n = int(mesh.shape[mesh.axis_names[0]])
        x = self._time_data.T  # (C, T), device-resident
        pad = (-x.shape[0]) % n
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros((pad, x.shape[1]), x.dtype)], axis=0
            )
        f, csm = parallel_csm(
            x,
            mesh,
            sampling_rate_hz=self.sampling_rate_hz,
            window_length_samples=p["window_length_samples"],
            window_type=p["window_type"],
            overlap_percent=p["overlap_percent"],
            detrend=p["detrend"],
            scaling=p["scaling"],
        )

        C = self.number_of_channels
        return f, np.asarray(csm)[:, :C, :C]

    def _get_csm_device(self):
        """Device-resident CSM: ``(freqs, real (F,C,C), imag (F,C,C))``
        with the matrices left on the device. Consumers that need only a
        frequency slice (beamformers pick ~15 bins of a 513-bin CSM) fetch
        their slice instead of the full matrix. Welch method only; other
        methods fall back to `get_csm`."""
        entry = self._cache.get("csm_dev")
        if entry is not None and entry[0] == self._spectrum_param_key():
            _, f, re, im = entry
            return f.copy(), re, im
        if self.spectrum_method != SpectrumMethod.WelchPeriodogram:
            f, csm = self.get_csm()
            re = jnp.asarray(np.real(csm), default_float())
            im = jnp.asarray(np.imag(csm), default_float())
            self._cache["csm_dev"] = (
                self._spectrum_param_key(), np.asarray(f), re, im
            )
            return np.asarray(f).copy(), re, im
        from .._config import run_jitted_complex

        _csm = self._csm_welch_closure()

        def _csm_split(td):
            _, c = _csm(td)
            return c.real, c.imag

        re, im = run_jitted_complex(
            _csm_split,
            self._time_data,
            materialize=False,
            defer=True,
            key=("sig_csm", self.sampling_rate_hz,
                 self._spectrum_param_key()),
        )
        # freqs host-side: no fetch of the device-built vector
        f = np.fft.rfftfreq(
            self._spectrum_parameters["window_length_samples"],
            1 / self.sampling_rate_hz,
        )
        self._cache["csm_dev"] = (self._spectrum_param_key(), f, re, im)
        return f.copy(), re, im

    def get_spectrogram(
        self,
        force_computation: bool = False,
        return_device: bool = False,
    ):
        """(t, f, stft ``(F, n_frames, C)``) (`classes/signal.py:1009-1057`).

        ``return_device=True`` returns the complex STFT as a
        :class:`DeviceSpectralData` (real/imag device pair) so downstream
        device consumers skip the host fetch of the full matrix."""
        if return_device:
            re, im = self._get_complex_spectrogram_device()
            from .._defer import force_value

            # return_device contract: CONCRETE device arrays
            re, im = force_value(re), force_value(im)
            p = self._spectrogram_parameters
            overlap = int(
                p["overlap_percent"] / 100 * p["window_length_samples"]
                + 0.5
            )
            length_padded = self._time_data.shape[0] + (
                2 * overlap if p["padding"] else 0
            )
            t = np.linspace(
                0, length_padded / self.sampling_rate_hz, re.shape[1]
            )
            f = np.fft.rfftfreq(
                (
                    p["fft_length_samples"]
                    or p["window_length_samples"]
                ),
                1 / self.sampling_rate_hz,
            )
            return t, f, DeviceSpectralData(re, im)
        from .._config import lazy_host_returns

        if lazy_host_returns():
            from .lazy_array import LazyHostArray

            if force_computation:
                self._cache.pop("spectrogram_complex_dev", None)
            re, im = self._get_complex_spectrogram_device()
            p = self._spectrogram_parameters
            overlap = int(
                p["overlap_percent"] / 100 * p["window_length_samples"]
                + 0.5
            )
            length_padded = self._time_data.shape[0] + (
                2 * overlap if p["padding"] else 0
            )
            t = np.linspace(
                0, length_padded / self.sampling_rate_hz, re.shape[1]
            )
            f = np.fft.rfftfreq(
                (
                    p["fft_length_samples"]
                    or p["window_length_samples"]
                ),
                1 / self.sampling_rate_hz,
            )
            return t, f, LazyHostArray(re, im)
        if not force_computation and "spectrogram" in self._cache:
            t, f, S = self._cache["spectrogram"]
            return t.copy(), f.copy(), S.copy()
        p = self._spectrogram_parameters
        fs_hz = self.sampling_rate_hz
        wl = p["window_length_samples"]
        wt = p["window_type"]
        ol = p["overlap_percent"]
        fl = p["fft_length_samples"]
        det = p["detrend"]
        pad = p["padding"]
        scal = p["scaling"]

        def _stft(td):
            t, f, S = stft(
                td.T,
                sampling_rate_hz=fs_hz,
                window_length_samples=wl,
                window_type=wt,
                overlap_percent=ol,
                fft_length_samples=fl,
                detrend=det,
                padding=pad,
                scaling=scal,
            )
            # (C, frames, F) -> (F, frames, C)
            return t, f, jnp.transpose(S, (2, 1, 0))

        t, f, S = _stft(self._time_data)
        if self.activate_cache:
            self._cache["spectrogram"] = (
                _cache_leaf(t), _cache_leaf(f), _cache_leaf(S)
            )
        return t, f, S

    def _get_complex_spectrogram_device(self):
        """Complex STFT ``(F, n_frames, C)`` as a (real, imag) device-array
        pair — never crosses the host boundary. Shares the spectrogram
        parameter set with `get_spectrogram`."""
        if self.activate_cache and "spectrogram_complex_dev" in self._cache:
            return self._cache["spectrogram_complex_dev"]
        p = self._spectrogram_parameters
        from .._config import run_jitted_complex

        fs_hz = self.sampling_rate_hz
        wl = p["window_length_samples"]
        wt = p["window_type"]
        ol = p["overlap_percent"]
        fl = p["fft_length_samples"]
        det = p["detrend"]
        pad = p["padding"]
        scal = p["scaling"]

        def _stft_pair(td):
            _, _, S = stft(
                td.T,
                sampling_rate_hz=fs_hz,
                window_length_samples=wl,
                window_type=wt,
                overlap_percent=ol,
                fft_length_samples=fl,
                detrend=det,
                padding=pad,
                scaling=scal,
            )
            S = jnp.transpose(S, (2, 1, 0))  # (F, frames, C)
            return S.real, S.imag

        re, im = run_jitted_complex(
            _stft_pair,
            self._time_data,
            materialize=False,
            defer=True,
            key=(
                "sig_stft_pair",
                self.sampling_rate_hz,
                tuple(sorted((k, str(v)) for k, v in p.items())),
            ),
        )
        if self.activate_cache:
            self._cache["spectrogram_complex_dev"] = (re, im)
        return re, im

    def _get_power_spectrogram_device(self):
        """(t, f, |STFT|² device ``(F, n_frames, C)``) — the power
        spectrogram stays on the device for feature extractors
        (mel/MFCC/chroma projections consume it as a matmul operand), so
        the complex STFT never crosses the host boundary."""
        if self.activate_cache and "spectrogram_power_dev" in self._cache:
            t, f, P = self._cache["spectrogram_power_dev"]
            return t.copy(), f.copy(), P
        p = self._spectrogram_parameters
        from .._config import run_jitted_complex

        fs_hz = self.sampling_rate_hz
        wl = p["window_length_samples"]
        wt = p["window_type"]
        ol = p["overlap_percent"]
        fl = p["fft_length_samples"]
        det = p["detrend"]
        pad = p["padding"]
        scal = p["scaling"]

        def _stft_power(td):
            _, _, S = stft(
                td.T,
                sampling_rate_hz=fs_hz,
                window_length_samples=wl,
                window_type=wt,
                overlap_percent=ol,
                fft_length_samples=fl,
                detrend=det,
                padding=pad,
                scaling=scal,
            )
            # (C, frames, F) -> (F, frames, C), squared magnitude (real)
            return jnp.transpose(jnp.abs(S) ** 2, (2, 1, 0))

        P = run_jitted_complex(
            _stft_power, self._time_data, materialize=False
        )
        # t/f host-side from static shapes (returning them from the trace
        # would make them device outputs that need a fetch). Mirrors
        # `ops.spectral.stft`'s construction.
        overlap = int(ol / 100 * wl + 0.5)
        length_padded = self._time_data.shape[0] + (2 * overlap if pad else 0)
        t = np.linspace(0, length_padded / fs_hz, P.shape[1])
        f = np.fft.rfftfreq(wl, 1 / fs_hz)
        if self.activate_cache:
            self._cache["spectrogram_power_dev"] = (t.copy(), f.copy(), P)
        return t, f, P

    # ======== Plots =========================================================
    def plot_magnitude(
        self,
        range_hz=[20.0, 20e3],
        normalize: MagnitudeNormalization = MagnitudeNormalization.NoNormalization,
        range_db=None,
        smoothing: int = 0,
        show_info_box: bool = False,
    ):
        """Magnitude spectrum plot (`classes/signal.py:1059-1161`)."""
        from ..plots import general_plot

        prior = self._spectrum_parameters["smoothing"]
        self._spectrum_parameters["smoothing"] = 0
        f, sp = self.get_spectrum()
        self._spectrum_parameters["smoothing"] = prior
        f, mag_db = get_normalized_spectrum(
            f=f,
            spectra=sp,
            is_amplitude_scaling=self.spectrum_scaling.is_amplitude_scaling(),
            f_range_hz=range_hz,
            normalize=normalize,
            smoothing=smoothing,
            phase=False,
            calibrated_data=self.calibrated_signal,
        )
        txt = None
        if show_info_box:
            txt = (
                f"Info\nMode: {self._spectrum_parameters['method']}"
                f"\nRange: {range_hz}\nNormalized: {normalize}"
                f"\nSmoothing: {smoothing}"
            )
        suffix = {
            MagnitudeNormalization.NoNormalization: (
                "" if self.calibrated_signal else "FS"
            ),
            MagnitudeNormalization.OneKhz: " (normalized @ 1 kHz)",
            MagnitudeNormalization.OneKhzFirstChannel: (
                " (normalized @ 1 kHz for first channel)"
            ),
            MagnitudeNormalization.Max: " (normalized @ peak)",
            MagnitudeNormalization.MaxFirstChannel: (
                " (normalized @ peak for first channel)"
            ),
            MagnitudeNormalization.Energy: " (normalized with average energy)",
            MagnitudeNormalization.EnergyFirstChannel: (
                " (normalized with average energy of first channel)"
            ),
        }[normalize]
        return general_plot(
            f,
            np.asarray(mag_db),
            range_hz,
            range_y=range_db,
            ylabel="Magnitude / dB" + suffix,
            info_box=txt,
            labels=[f"Channel {n}" for n in range(self.number_of_channels)],
        )

    def plot_time(self):
        """Per-channel waveform plot (`classes/signal.py:1163-1192`)."""
        from ..plots import general_subplots_line

        td = self.time_data
        fig, ax = general_subplots_line(
            self.time_vector_s,
            td,
            sharex=True,
            ylabels=[f"Channel {n}" for n in range(self.number_of_channels)],
            xlabels="Time / s",
        )
        td_im = self.time_data_imaginary
        for n in range(self.number_of_channels):
            mx = np.max(np.abs(td[:, n])) * 1.1 if td.size else 1.0
            if td_im is not None:
                ax[n].plot(
                    self.time_vector_s, td_im[:, n], alpha=0.9, linestyle="dotted"
                )
            if mx > 0:
                ax[n].set_ylim([-mx, mx])
        return fig, ax

    def plot_spl(
        self,
        normalize_at_peak: bool = False,
        dynamic_range_db: float | None = 100.0,
        window_length_s: float = 0.0,
    ):
        """Momentary SPL (dB / dBFS / dB(Pa)) per channel
        (`classes/signal.py:1194-1294`)."""
        from ..helpers.gain_and_level import to_db
        from ..helpers.smoothing import time_smoothing
        from ..plots import general_subplots_line

        td = self._time_data
        p0 = 20e-6 if self.calibrated_signal and not normalize_at_peak else 1.0
        x = td / p0
        if normalize_at_peak:
            x = x / jnp.max(jnp.abs(x))
        power = x**2
        if window_length_s > 0:
            power = time_smoothing(
                power.T, self.sampling_rate_hz, window_length_s
            ).T
        spl = np.asarray(to_db(power, False))
        if dynamic_range_db is not None:
            spl = np.clip(spl, np.max(spl) - abs(dynamic_range_db), None)
        unit = (
            "dBFS"
            if not self.calibrated_signal or normalize_at_peak
            else "dB SPL"
        )
        fig, ax = general_subplots_line(
            self.time_vector_s,
            spl,
            sharex=True,
            ylabels=[
                f"Channel {n} / {unit}"
                for n in range(self.number_of_channels)
            ],
            xlabels="Time / s",
        )
        return fig, ax

    def plot_group_delay(
        self,
        range_hz=[20.0, 20e3],
        smoothing: int = 0,
        remove_ir_latency=None,
    ):
        """Group delay plot (FFT spectrum, -dφ/dω;
        `classes/signal.py:1296-1382`). ``remove_ir_latency``: None,
        "peak", "min_phase" or per-channel delays in samples."""
        from ..plots import general_plot
        from ..standard.backend import group_delay_direct

        prior = self._spectrum_parameters.copy()
        self.set_spectrum_parameters(
            method=SpectrumMethod.FFT,
            scaling=SpectrumScaling.FFTBackward,
            pad_to_fast_length=False,
        )
        f, sp = self.get_spectrum(force_computation=True)
        self._spectrum_parameters = prior
        self._cache.pop("spectrum", None)
        ph = np.angle(np.asarray(sp))
        if ph.ndim == 1:
            ph = ph[:, None]
        if remove_ir_latency is not None:
            from ..helpers.latency import (
                get_fractional_impulse_peak_index,
                remove_ir_latency_from_phase,
            )

            if isinstance(remove_ir_latency, str):
                mode_ = remove_ir_latency.lower()
                if mode_ == "peak":
                    delays = get_fractional_impulse_peak_index(
                        self.time_data, 1
                    )
                elif mode_ == "min_phase":
                    from ..helpers.latency import fractional_latency
                    from ..helpers.minimum_phase import (
                        min_phase_ir_from_real_cepstrum,
                    )

                    min_ir = np.asarray(
                        min_phase_ir_from_real_cepstrum(
                            jnp.asarray(self.time_data.T), 8
                        )
                    ).T[: len(self), :]
                    delays = fractional_latency(
                        self.time_data, min_ir, 1
                    )
                else:
                    raise ValueError("No valid latency removal")
            else:
                delays = np.atleast_1d(remove_ir_latency)
            ph = np.asarray(
                remove_ir_latency_from_phase(
                    f, jnp.asarray(ph), np.asarray(delays),
                    self.sampling_rate_hz,
                )
            )
        gd = group_delay_direct(jnp.asarray(ph), f[1] - f[0], axis=0)
        if smoothing != 0:
            from ..helpers.smoothing import fractional_octave_smoothing

            gd = fractional_octave_smoothing(gd, None, smoothing)
        return general_plot(
            f,
            np.asarray(gd) * 1e3,
            range_hz,
            ylabel="Group delay / ms",
            labels=[f"Channel {n}" for n in range(self.number_of_channels)],
        )

    def plot_spectrogram(
        self, channel_number: int = 0, log_freqs: bool = True, dynamic_range_db=50
    ):
        """Spectrogram heatmap of one channel
        (`classes/signal.py:1384-1449`)."""
        from ..plots import general_matrix_plot

        t, f, S = self.get_spectrogram()
        mag = np.abs(np.asarray(S[..., channel_number]))
        eps = np.finfo(np.float64).eps
        mag_db = 20 * np.log10(mag + eps)
        fig, ax = general_matrix_plot(
            mag_db,
            range_x=(t[0], t[-1]),
            range_y=(max(f[0], 1.0), f[-1]),
            range_z=dynamic_range_db,
            xlabel="Time / s",
            ylabel="Frequency / Hz",
            zlabel="Magnitude / dB",
            ylog=log_freqs,
        )
        return fig, ax

    def plot_phase(
        self,
        range_hz=[20.0, 20e3],
        unwrap: bool = False,
        smoothing: int = 0,
        remove_ir_latency=None,
    ):
        """Phase plot; requires an FFT-type spectrum.

        ``remove_ir_latency``: None, "peak", "min_phase" or per-channel
        delays in samples (`classes/signal.py:1451-1545`)."""
        from ..plots import general_plot

        assert self.spectrum_method == SpectrumMethod.FFT, (
            "Phase cannot be plotted since the spectrum is not complex. Set "
            "the spectrum method to FFT"
        )

        prior_smoothing = self._spectrum_parameters["smoothing"]
        self._spectrum_parameters["smoothing"] = 0
        f, sp = self.get_spectrum()
        self._spectrum_parameters["smoothing"] = prior_smoothing
        # presentation boundary: host math
        ph = np.angle(np.asarray(sp))
        if remove_ir_latency is not None:
            from ..helpers.latency import (
                get_fractional_impulse_peak_index,
                remove_ir_latency_from_phase,
            )

            if isinstance(remove_ir_latency, str):
                mode_ = remove_ir_latency.lower()
                if mode_ == "peak":
                    delays = get_fractional_impulse_peak_index(
                        self.time_data, 1
                    )
                elif mode_ == "min_phase":
                    from ..helpers.latency import fractional_latency
                    from ..helpers.minimum_phase import (
                        min_phase_ir_from_real_cepstrum,
                    )

                    min_ir = np.asarray(
                        min_phase_ir_from_real_cepstrum(
                            jnp.asarray(self.time_data.T), 8
                        )
                    ).T[: len(self), :]
                    delays = fractional_latency(
                        self.time_data, min_ir, 1
                    )
                else:
                    raise ValueError("No valid latency removal")
            else:
                delays = np.atleast_1d(remove_ir_latency)
            ph = np.asarray(
                remove_ir_latency_from_phase(
                    f, jnp.asarray(ph), np.asarray(delays),
                    self.sampling_rate_hz,
                )
            )
        if smoothing != 0:
            from ..helpers.smoothing import fractional_octave_smoothing

            ph = np.asarray(
                fractional_octave_smoothing(
                    np.unwrap(ph, axis=0), None, smoothing
                )
            )
            ph = (ph + np.pi) % (2 * np.pi) - np.pi
        if unwrap:
            ph = np.unwrap(ph, axis=0)
        return general_plot(
            f,
            np.asarray(ph),
            range_hz,
            ylabel="Phase / rad",
            labels=[f"Channel {n}" for n in range(self.number_of_channels)],
        )

    def plot_csm(self, range_hz=[20.0, 20e3], with_phase=True):
        """Lower-triangle CSM magnitude (+phase) matrix plot
        (`classes/signal.py:1547-1569`, `classes/plots.py:_csm_plot`)."""
        from ._plots import csm_plot

        f, csm = self.get_csm()
        return csm_plot(f, np.asarray(csm), range_hz, True, with_phase)

    # ======== Saving / copying ==============================================
    def save_signal(self, path: str, mode: str = "wav", bit_depth: int = 32):
        """Save as wav (our RIFF writer), flac (native encoder) or pickle
        (`classes/signal.py:1572-1611`)."""
        mode = mode.lower()
        path = check_format_in_path(path, mode)
        if mode == "wav":
            from ..io import write_wav

            subtype = {
                16: "PCM_16",
                24: "PCM_24",
                32: "FLOAT",
                64: "DOUBLE",
            }.get(bit_depth)
            if subtype is None:
                raise ValueError(
                    "Selected bit depth is not valid. Use either 16, 24, 32 "
                    "or 64"
                )
            write_wav(path, self.time_data, self.sampling_rate_hz, subtype)
        elif mode == "flac":
            from ..io.flac import write_flac

            bits = bit_depth if bit_depth in (8, 16, 24) else 24
            write_flac(path, self.time_data, self.sampling_rate_hz, bits)
        elif mode == "pkl":
            with open(path, "wb") as data_file:
                dump(self, data_file, HIGHEST_PROTOCOL)
        else:
            raise ValueError(
                f"{mode} is not a supported saving mode. Use wav, flac "
                "or pkl"
            )
        return self

    def copy(self) -> "Signal":
        return deepcopy(self)

    def __getstate__(self):
        """Pickle without the host mirror (a rebuildable cache that would
        double the serialized size and carry an owner cycle). Pending
        deferred buffers are forced first — program handles don't
        survive a process boundary — and value caches holding deferred
        entries are dropped."""
        from .._defer import DeferredArray, force_value

        d = dict(self.__dict__)
        d["_host_mirror"] = None
        d["_host_mirror_state"] = -1
        if isinstance(d.get("_time_data"), DeferredArray):
            d["_time_data"] = force_value(d["_time_data"])
        if isinstance(d.get("_time_data_imag"), DeferredArray):
            d["_time_data_imag"] = force_value(d["_time_data_imag"])
        if d.get("_cache"):
            d["_cache"] = {}
        return d

    def __deepcopy__(self, memo):
        """Deepcopy that (a) drops the host mirror (a rebuildable cache —
        copying it would duplicate the full time data on the host and
        carry a stale owner link) and (b) ALIASES jax device arrays
        instead of copying them: they are immutable, and jax's own
        ``__deepcopy__`` round-trips the buffer through the host."""
        cls = self.__class__
        new = cls.__new__(cls)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k == "_host_mirror":
                new.__dict__[k] = None
            elif k == "_host_mirror_state":
                new.__dict__[k] = -1
            elif k == "_cache":
                # self-validating recompute caches: walking their value
                # trees was the dominant Python cost of hot-path copies
                # (append_signals copies per call); a fresh dict changes
                # no observable value
                new.__dict__[k] = {}
            else:
                new.__dict__[k] = _deepcopy_alias_device(v, memo)
        return new

    def copy_with_new_time_data(self, new_time_data) -> "Signal":
        from .._defer import DeferredArray

        if not isinstance(
            new_time_data, (jnp.ndarray, DeviceTimeData, DeferredArray)
        ):
            new_time_data = np.asarray(new_time_data)
        new_signal = Signal.from_time_data(
            new_time_data,
            self.sampling_rate_hz,
            self.constrain_amplitude,
        )
        new_signal.calibrated_signal = self.calibrated_signal
        new_signal.activate_cache = self.activate_cache
        # shallow copies: parameter values are scalars/enums/tuples (see
        # set_spectrum_parameters), and deepcopy here was the single
        # largest Python cost in filter-bank pipelines (~20 copies/call)
        new_signal._spectrum_parameters = dict(self._spectrum_parameters)
        new_signal._spectrogram_parameters = dict(
            self._spectrogram_parameters
        )
        return new_signal

    # ======== MultichannelData hooks ========================================
    def _get_data(self):
        if self.is_complex_signal:
            # compose on host from the two real parts
            return np.asarray(self._time_data) + 1j * np.asarray(
                self._time_data_imag
            )
        return self._time_data

    def _data_shape(self) -> tuple:
        return self._time_data.shape

    def _set_data(self, data) -> None:
        self.time_data = np.asarray(data)

    def _create_copy_with_new_data(self, data) -> "Signal":
        # Keep device arrays on the device: np.asarray here would be a
        # synchronous host fetch + re-upload. copy_with_new_time_data
        # handles both kinds.
        return self.copy_with_new_time_data(data)

    def _update_state(self) -> None:
        self.__update_state()

    def show_info(self):
        print(self.metadata_str)
        return self
