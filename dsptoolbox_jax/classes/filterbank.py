"""FilterBank: ordered list of Filters with Parallel/Sequential/Summed modes.

Behavioral reference: `dsptoolbox/classes/filterbank.py`.
"""

from __future__ import annotations

from copy import deepcopy
from pickle import HIGHEST_PROTOCOL, dump
from warnings import warn

import jax.numpy as jnp
import numpy as np

from ..helpers.other import check_format_in_path
from ..standard.enums import FilterBankMode
from .filter import Filter
from .multibandsignal import MultiBandSignal
from .signal import Signal


_BANK_STACK_CACHE: dict = {}


def _sos_bank_or_none(filters: list) -> "np.ndarray | None":
    """Stacked ``(B, S_max, 6)`` cascade bank when every filter is SOS and
    the bank is dtype-homogeneous (all real or all complex, so no band is
    silently promoted); shorter cascades are padded with exact identity
    sections. ``None`` when the bank cannot be stacked.

    Memoized on the identity of the member ``sos`` arrays (replaced, never
    mutated, by the Filter API): restacking a 17-band gammatone cost
    ~0.3 ms per filter call. Use `_bank_hash` for a content token."""
    if not filters or not all(
        getattr(f, "has_sos", False) for f in filters
    ):
        return None
    sos_list = [np.asarray(f.sos) for f in filters]
    token = tuple(id(s) for s in sos_list)
    hit = _BANK_STACK_CACHE.get(token)
    if hit is not None and all(
        a is b for a, b in zip(hit[0], sos_list)
    ):
        return hit[1]
    flags = [np.iscomplexobj(s) for s in sos_list]
    if any(flags) and not all(flags):
        return None
    identity = np.array([1.0, 0, 0, 1.0, 0, 0])
    if flags[0]:
        identity = identity.astype(np.complex128)
    max_s = max(s.shape[0] for s in sos_list)
    bank = np.stack(
        [
            np.vstack([s] + [identity[None]] * (max_s - s.shape[0]))
            for s in sos_list
        ]
    )
    h = hash(bank.tobytes())
    if len(_BANK_STACK_CACHE) > 64:
        _BANK_STACK_CACHE.clear()
    _BANK_STACK_CACHE[token] = (sos_list, bank, h)
    return bank


def _bank_hash(bank: np.ndarray) -> int:
    """Content token for a stacked bank; hits the stack cache when the
    bank came from `_sos_bank_or_none`."""
    for refs, cached, h in _BANK_STACK_CACHE.values():
        if cached is bank:
            return h
    return hash(bank.tobytes())


def _banked_filter_apply_mesh(
    signal: Signal, bank: "np.ndarray", summed: bool, mesh
):
    """Band-parallel bank application over a device mesh
    (`parallel.ops.parallel_filterbank`): the band axis shards across the
    mesh's first axis, each device runs the blocked-IIR kernel for its
    bands. The bank is padded to a mesh-divisible band count with silent
    (zero-numerator) sections — safe for both Parallel (trimmed) and
    Summed (adds zero). Returns the same per-band triples contract as
    `_banked_filter_apply`."""
    from ..parallel.ops import parallel_filterbank

    B = bank.shape[0]
    n = int(mesh.shape[mesh.axis_names[0]])
    pad = (-B) % n
    if pad:
        silent = np.zeros((pad, bank.shape[1], 6), bank.dtype)
        silent[:, :, 3] = 1.0  # a0 = 1: valid sections, zero output
        bank = np.concatenate([bank, silent], axis=0)

    x = signal.time_data_jax.T  # (C, T)
    y = parallel_filterbank(bank, x, mesh)[:B]  # (B, C, T), band-sharded
    yt = jnp.swapaxes(y, -1, -2)  # (B, T, C)
    need_peaks = bool(signal.constrain_amplitude)

    def _peak(v):
        if jnp.iscomplexobj(v):
            return float(
                jnp.maximum(
                    jnp.max(jnp.abs(v.real)), jnp.max(jnp.abs(v.imag))
                )
            )
        return float(jnp.max(jnp.abs(v)))

    if summed:
        ys = jnp.sum(yt, axis=0)  # (T, C)
        peak = _peak(ys) if need_peaks else None
        if jnp.iscomplexobj(ys):
            return ys.real, ys.imag, peak
        return ys, None, peak
    triples = []
    for b in range(B):
        yb = yt[b]
        peak = _peak(yb) if need_peaks else None
        if jnp.iscomplexobj(yb):
            triples.append((yb.real, yb.imag, peak))
        else:
            triples.append((yb, None, peak))
    return triples


def _banked_filter_apply(
    signal: Signal, bank: "np.ndarray", summed: bool = False, mesh=None
):
    """All bands in ONE cached jitted program on the device: the 16-band
    gammatone (or N-way crossover) runs as a single band-batched blocked-IIR
    dispatch instead of one program per filter.

    Returns per-band ``(real (T, C), imag (T, C) | None)`` device pairs (a
    single pair when ``summed``); the data never leaves the device."""
    from .._config import run_jitted_complex
    from ..ops.iir_block import sosfilt_bank_apply, sosfilt_bank_operators

    if mesh is not None and mesh.devices.size > 1:
        return _banked_filter_apply_mesh(signal, bank, summed, mesh)
    x = signal.time_data_jax.T  # (C, T)

    # Zero-state bank application dispatch: the blocked state-space path
    # is the default — narrow bands make the frequency-sampling path's
    # decay margin (and FFT length) explode. `_config.set_bank_path`
    # re-enables frequency sampling.
    from .._config import bank_path

    T = x.shape[-1]
    freq_nfft = None
    if bank_path() == "freq" and T >= 4096:
        from ..ops.iir_freq import decay_margin, plan_nfft

        margins = [decay_margin(bank[b]) for b in range(bank.shape[0])]
        if all(m is not None for m in margins):
            from ..ops.fft_conv import next_fast_len

            nfft = int(next_fast_len(T + max(margins), real=True))
            if nfft <= 4 * T:
                freq_nfft = nfft
    ops = (
        None
        if freq_nfft is not None
        else sosfilt_bank_operators(bank, x.shape[-1])
    )
    # the peaks reduction is only consumed by the amplitude constraint; when
    # the signal does not constrain, skip it — fetching the (B,) peaks array
    # is the ONLY host sync on this path, and dropping it lets successive
    # filter-bank calls pipeline fully asynchronously on the device
    need_peaks = bool(signal.constrain_amplitude)

    def fn(xv):
        if freq_nfft is not None:
            from ..ops.iir_freq import sosfilt_bank_freq

            y = sosfilt_bank_freq(bank, xv, nfft=freq_nfft)  # (B, C, T)
        else:
            y = sosfilt_bank_apply(ops, xv)  # (B, C, T)
        if summed:
            y = jnp.sum(y, axis=0)  # (C, T)
            yt = y.T
            if jnp.iscomplexobj(yt):
                peak = (
                    jnp.maximum(
                        jnp.max(jnp.abs(yt.real)), jnp.max(jnp.abs(yt.imag))
                    )
                    if need_peaks
                    else None
                )
                return (yt.real, yt.imag), peak
            return (yt, None), (
                jnp.max(jnp.abs(yt)) if need_peaks else None
            )
        yt = jnp.swapaxes(y, -1, -2)  # (B, T, C)
        if jnp.iscomplexobj(yt):
            # per-band max(|re|, |im|) — the amplitude-constraint peaks for
            # the whole bank in one (B,) fetch instead of B scalar fetches
            peaks = (
                jnp.maximum(
                    jnp.max(jnp.abs(yt.real), axis=(1, 2)),
                    jnp.max(jnp.abs(yt.imag), axis=(1, 2)),
                )
                if need_peaks
                else None
            )
            return (
                tuple(
                    (yt[b].real, yt[b].imag) for b in range(yt.shape[0])
                ),
                peaks,
            )
        peaks = (
            jnp.max(jnp.abs(yt), axis=(1, 2)) if need_peaks else None
        )
        return tuple((yt[b], None) for b in range(yt.shape[0])), peaks

    pairs, peaks = run_jitted_complex(
        fn,
        x,
        materialize=False,
        # explicit program identity (skips the closure freezer): the
        # traced program depends on the bank content, the dispatch
        # decision, and the output contract flags
        key=(
            "bank_apply",
            _bank_hash(bank),
            bool(summed),
            bool(need_peaks),
            freq_nfft,
        ),
    )
    if need_peaks:
        peaks = np.atleast_1d(np.asarray(peaks))
    if summed:
        re, im = pairs
        return re, im, float(peaks[0]) if need_peaks else None
    return [
        (re, im, float(peaks[b]) if need_peaks else None)
        for b, (re, im) in enumerate(pairs)
    ]


def filterbank_on_signal(
    signal: Signal,
    filters: list[Filter],
    mode: FilterBankMode,
    activate_zi: bool = False,
    zero_phase: bool = False,
    same_sampling_rate: bool = True,
    mesh=None,
):
    """Apply a list of filters in the selected mode
    (`classes/filter_helpers.py:385-451`).

    ``mesh``: optional `jax.sharding.Mesh` — when the bank is stackable
    (all-SOS, no zi, no zero-phase) the band axis shards across the mesh
    (`_banked_filter_apply_mesh`); otherwise the hint is ignored and the
    single-device path runs."""
    from .filter_helpers import _replace_channels

    n_filt = len(filters)
    bankable = (
        not activate_zi
        and not zero_phase
        and same_sampling_rate
        and n_filt > 1
    )
    if mode == FilterBankMode.Parallel:
        if bankable:
            bank = _sos_bank_or_none(filters)
            if bank is not None:
                triples = _banked_filter_apply(signal, bank, mesh=mesh)
                channels = np.arange(signal.number_of_channels)
                from .signal import DeviceTimeData

                bands = [
                    _replace_channels(
                        signal,
                        DeviceTimeData(re, im, peak),
                        channels,
                        filters[b].warning_if_complex,
                    )
                    for b, (re, im, peak) in enumerate(triples)
                ]
                return MultiBandSignal(
                    bands, same_sampling_rate=same_sampling_rate
                )
        bands = [
            filters[n].filter_signal(
                signal, activate_zi=activate_zi, zero_phase=zero_phase
            )
            for n in range(n_filt)
        ]
        return MultiBandSignal(bands, same_sampling_rate=same_sampling_rate)
    if mode == FilterBankMode.Sequential:
        out_sig = signal.copy()
        for n in range(n_filt):
            out_sig = filters[n].filter_signal(
                out_sig, activate_zi=activate_zi, zero_phase=zero_phase
            )
        return out_sig
    if mode == FilterBankMode.Summed:
        if bankable:
            bank = _sos_bank_or_none(filters)
            if bank is not None:
                re, im, peak = _banked_filter_apply(
                    signal, bank, summed=True, mesh=mesh
                )
                from .signal import DeviceTimeData

                return signal.copy_with_new_time_data(
                    DeviceTimeData(re, im, peak)
                )
        total = None
        for n in range(n_filt):
            s = filters[n].filter_signal(
                signal, activate_zi=activate_zi, zero_phase=zero_phase
            )
            total = s.time_data if total is None else total + s.time_data
        return signal.copy_with_new_time_data(total)
    raise ValueError("Invalid filter bank apply mode")


class FilterBank:
    def __init__(
        self,
        filters: list | None = None,
        same_sampling_rate: bool = True,
        info: dict | None = None,
    ):
        """Bank of filters applied in parallel, sequentially or summed
        (`classes/filterbank.py:36-72`)."""
        if info is None:
            info = {}
        self.same_sampling_rate = same_sampling_rate
        self.filters = filters if filters is not None else []
        self.info: dict = info

    # ======== Properties ====================================================
    @property
    def filters(self) -> list[Filter]:
        return self.__filters

    @filters.setter
    def filters(self, new_filters):
        if new_filters is None:
            new_filters = []
        if isinstance(new_filters, tuple):
            new_filters = list(new_filters)
        assert isinstance(new_filters, list), "filters must be a list"
        if new_filters:
            for f in new_filters:
                assert isinstance(f, Filter), (
                    f"{type(f)} is not a valid filter type. Use Filter "
                    "objects"
                )
            if self.same_sampling_rate:
                self.sampling_rate_hz = new_filters[0].sampling_rate_hz
                for f in new_filters:
                    assert f.sampling_rate_hz == self.sampling_rate_hz, (
                        "Not all filters have the same sampling rate. For "
                        "a multirate bank set same_sampling_rate to False"
                    )
            else:
                self.sampling_rate_hz = [
                    f.sampling_rate_hz for f in new_filters
                ]
        self.__filters = new_filters

    @property
    def same_sampling_rate(self) -> bool:
        return self.__same_sampling_rate

    @same_sampling_rate.setter
    def same_sampling_rate(self, new_same):
        assert isinstance(new_same, bool)
        self.__same_sampling_rate = new_same

    @property
    def sampling_rate_hz(self):
        return self.__sampling_rate_hz

    @sampling_rate_hz.setter
    def sampling_rate_hz(self, new_sampling_rate_hz):
        if self.same_sampling_rate:
            self.__sampling_rate_hz = int(np.squeeze(new_sampling_rate_hz))
        else:
            self.__sampling_rate_hz = [
                int(s) for s in np.atleast_1d(new_sampling_rate_hz)
            ]

    @property
    def number_of_filters(self) -> int:
        return len(self.filters)

    def __len__(self):
        return self.number_of_filters

    def __iter__(self):
        return iter(self.filters)

    def __str__(self):
        return self.metadata_str

    @property
    def metadata(self) -> dict:
        info = {
            "number_of_filters": self.number_of_filters,
            "same_sampling_rate": self.same_sampling_rate,
        }
        if self.same_sampling_rate and self.filters:
            info["sampling_rate_hz"] = self.sampling_rate_hz
        info["types_of_filters"] = tuple(
            set(f.metadata["filter_type"] for f in self.filters)
        )
        return info

    @property
    def metadata_str(self) -> str:
        txt = "Filter bank:"
        for k, v in (self.metadata | self.info).items():
            txt += f" | {str(k).replace('_', ' ').capitalize()}: {v}"
        txt += "\n" + "–" * len(txt)
        for ind, f in enumerate(self.filters):
            txt += f"\nFilter {ind}:"
            for kf, vf in f.metadata.items():
                txt += f" | {str(kf).replace('_', ' ').capitalize()}: {vf}"
        return txt

    # ======== Filter management =============================================
    def add_filter(self, filt: Filter, index: int = -1) -> "FilterBank":
        filters = self.filters
        if index == -1:
            filters = filters + [filt]
        else:
            filters = filters[:index] + [filt] + filters[index:]
        self.filters = filters
        return self

    def remove_filter(self, index: int = -1, return_filter: bool = False):
        assert self.filters, "There are no filters to remove"
        filters = list(self.filters)
        f = filters.pop(index)
        self.filters = filters
        if return_filter:
            return self, f
        return self

    def swap_filters(self, new_order) -> "FilterBank":
        new_order = np.atleast_1d(np.asarray(new_order).squeeze())
        assert len(new_order) == self.number_of_filters, (
            "The number of filters does not match"
        )
        assert all(new_order < self.number_of_filters) and all(
            new_order >= 0
        ), (
            "Indexes of new filters have to be in "
            f"[0, {self.number_of_filters - 1}]"
        )
        assert len(np.unique(new_order)) == len(new_order), (
            "There are repeated indexes in the new order vector"
        )
        self.filters = [self.filters[i] for i in new_order]
        return self

    def initialize_zi(self, number_of_channels: int = 1) -> "FilterBank":
        for f in self.filters:
            f.initialize_zi(number_of_channels)
        return self

    # ======== Filtering =====================================================
    def filter_signal(
        self,
        signal: Signal,
        mode: FilterBankMode,
        activate_zi: bool = False,
        zero_phase: bool = False,
        mesh=None,
    ):
        """Apply the bank (`classes/filterbank.py:396-478`): Parallel →
        MultiBandSignal, Sequential/Summed → Signal.

        ``mesh``: optional `jax.sharding.Mesh` for band-parallel execution
        across devices (Parallel/Summed SOS banks without zi/zero-phase);
        ignored where the bank cannot shard."""
        if isinstance(signal, MultiBandSignal):
            raise TypeError(
                "This method only supports Signal objects. Use "
                "filter_multiband_signal() for multirate parallel filtering"
            )
        if mode in (FilterBankMode.Sequential, FilterBankMode.Summed):
            assert self.same_sampling_rate, (
                "Multirate filtering is not valid for sequential or summed "
                "filtering"
            )
        assert np.all(signal.sampling_rate_hz == self.sampling_rate_hz), (
            "Sampling rates do not match"
        )
        if zero_phase:
            assert not activate_zi, (
                "Zero-phase filtering and zi cannot be used at the same time"
            )
        if activate_zi:
            if not hasattr(self.filters[0], "zi") or len(
                self.filters[0].zi
            ) != signal.number_of_channels:
                self.initialize_zi(signal.number_of_channels)
        return filterbank_on_signal(
            signal,
            self.filters,
            mode=mode,
            activate_zi=activate_zi,
            zero_phase=zero_phase,
            same_sampling_rate=self.same_sampling_rate,
            mesh=mesh,
        )

    def filter_multiband_signal(
        self,
        mbsignal: MultiBandSignal,
        activate_zi: bool = False,
        zero_phase: bool = False,
    ) -> MultiBandSignal:
        """Per-band parallel filtering of a MultiBandSignal
        (`classes/filterbank.py:479-533`)."""
        assert np.all(mbsignal.sampling_rate_hz == self.sampling_rate_hz), (
            "Sampling rates do not match"
        )
        if zero_phase:
            assert not activate_zi, (
                "Zero-phase filtering and zi cannot be used at the same time"
            )
        if activate_zi:
            if not hasattr(self.filters[0], "zi") or len(
                self.filters[0].zi
            ) != mbsignal.number_of_channels:
                self.initialize_zi(mbsignal.number_of_channels)
        new_sig = mbsignal.copy()
        for n in range(mbsignal.number_of_bands):
            new_sig.bands[n] = self.filters[n].filter_signal(
                mbsignal.bands[n],
                channels=None,
                activate_zi=activate_zi,
                zero_phase=zero_phase,
            )
        return new_sig

    # ======== Getters =======================================================
    @staticmethod
    def firs_from_file(path: str) -> "FilterBank":
        """Each channel of an audio file becomes an FIR filter
        (`classes/filterbank.py:74-88`)."""
        from .impulse_response import ImpulseResponse

        ir = ImpulseResponse.from_file(path)
        return FilterBank(
            [
                Filter.from_ba(
                    ir.time_data[:, ch], [1.0], ir.sampling_rate_hz
                )
                for ch in range(ir.number_of_channels)
            ]
        )

    def get_transfer_function(
        self, frequency_vector_hz: np.ndarray, mode: FilterBankMode
    ) -> np.ndarray:
        """Complex transfer function of the bank per filtering mode
        (`classes/filterbank.py:614-655`). Parallel → (frequency, filter);
        Sequential/Summed → (frequency,). NB: the reference initializes the
        Summed accumulator with ones (not zeros) — mirrored for parity."""
        if mode == FilterBankMode.Parallel:
            h = np.zeros(
                (len(frequency_vector_hz), self.number_of_filters),
                dtype=np.complex128,
            )
            for ind, f in enumerate(self.filters):
                h[:, ind] = f.get_transfer_function(frequency_vector_hz)
            return h
        if mode == FilterBankMode.Sequential:
            h = np.ones(len(frequency_vector_hz), dtype=np.complex128)
            for f in self.filters:
                h = h * f.get_transfer_function(frequency_vector_hz)
            return h
        if mode == FilterBankMode.Summed:
            h = np.ones(len(frequency_vector_hz), dtype=np.complex128)
            for f in self.filters:
                h = h + f.get_transfer_function(frequency_vector_hz)
            return h
        raise ValueError("No valid mode")

    def get_ir(
        self,
        length_samples: int = 1024,
        mode: FilterBankMode = FilterBankMode.Parallel,
        zero_phase: bool = False,
    ):
        """Impulse responses of the bank (`classes/filterbank.py:534-600`).

        Multirate banks deliver a parallel `MultiBandSignal` with one
        dirac per filter at that filter's own rate
        (`classes/filterbank.py:572-586`)."""
        from .filter_helpers import impulse
        from .impulse_response import ImpulseResponse

        if not self.same_sampling_rate:
            assert mode == FilterBankMode.Parallel, (
                "Multirate filter bank can only deliver an IR in parallel "
                "mode"
            )
            mb = MultiBandSignal(same_sampling_rate=False)
            for ind, filt in enumerate(self.filters):
                d = ImpulseResponse(
                    None,
                    impulse(length_samples),
                    self.sampling_rate_hz[ind],
                    constrain_amplitude=False,
                )
                mb.add_band(filt.filter_signal(d, zero_phase=zero_phase))
            return mb
        d = ImpulseResponse(
            None,
            impulse(length_samples),
            self.sampling_rate_hz,
            constrain_amplitude=False,
        )
        return self.filter_signal(d, mode, zero_phase=zero_phase)

    # ======== Plots =========================================================
    def _multirate_plot_skip(self) -> bool:
        """The reference skips response plots for multirate banks with a
        warning (`classes/filterbank.py:694-700`)."""
        if not self.same_sampling_rate:
            warn(
                "Plotting for multirate FilterBank is not supported, "
                "skipping plots"
            )
            return True
        return False

    def _response_irs(
        self, length_samples: int, mode, zero_phase: bool = False
    ):
        """Single-channel IRs for the response plots: Parallel → one per
        band; Sequential/Summed → one combined IR (the reference filters a
        dirac in the requested mode, `classes/filterbank.py:721-770`)."""
        out = self.get_ir(length_samples, mode, zero_phase=zero_phase)
        if mode == FilterBankMode.Parallel:
            return [b.time_data[:, 0] for b in out.bands]
        return [out.time_data[:, 0]]

    def plot_magnitude(
        self,
        length_samples: int = 1024,
        mode: FilterBankMode = FilterBankMode.Parallel,
        range_hz=[20, 20e3],
        zero_phase: bool = False,
    ):
        """Magnitude responses of all bands
        (`classes/filterbank.py:662-770`)."""
        if self._multirate_plot_skip():
            return None
        from ..helpers.gain_and_level import to_db
        from ..plots import general_plot

        irs = self._response_irs(length_samples, mode, zero_phase)
        fs = (
            self.sampling_rate_hz
            if self.same_sampling_rate
            else self.sampling_rate_hz[0]
        )
        f = np.fft.rfftfreq(length_samples, 1 / fs)
        # host magnitude of the host spectra
        mat = np.stack(
            [
                np.asarray(to_db(np.abs(np.fft.rfft(ir)), True))
                for ir in irs
            ],
            axis=1,
        )
        labels = [f"Filter {n}" for n in range(mat.shape[1])]
        return general_plot(
            f, mat, range_hz, ylabel="Magnitude / dB", labels=labels
        )

    def plot_phase(
        self,
        length_samples: int = 1024,
        mode: FilterBankMode = FilterBankMode.Parallel,
        range_hz=[20, 20e3],
        unwrap: bool = False,
    ):
        """Phase responses (`classes/filterbank.py:771-870`)."""
        if self._multirate_plot_skip():
            return None
        from ..plots import general_plot

        irs = self._response_irs(length_samples, mode)
        fs = (
            self.sampling_rate_hz
            if self.same_sampling_rate
            else self.sampling_rate_hz[0]
        )
        f = np.fft.rfftfreq(length_samples, 1 / fs)
        phases = []
        for ir in irs:
            ph = np.angle(np.fft.rfft(ir))
            if unwrap:
                ph = np.unwrap(ph)
            phases.append(ph)
        mat = np.stack(phases, axis=1)
        return general_plot(
            f,
            mat,
            range_hz,
            ylabel="Phase / rad",
            labels=[f"Filter {n}" for n in range(mat.shape[1])],
        )

    def plot_group_delay(
        self,
        length_samples: int = 1024,
        mode: FilterBankMode = FilterBankMode.Parallel,
        range_hz=[20, 20e3],
    ):
        """Group delays (`classes/filterbank.py:871-1008`)."""
        if self._multirate_plot_skip():
            return None
        import jax.numpy as jnp

        from ..plots import general_plot
        from ..standard.backend import group_delay_direct

        irs = self._response_irs(length_samples, mode)
        fs = (
            self.sampling_rate_hz
            if self.same_sampling_rate
            else self.sampling_rate_hz[0]
        )
        f = np.fft.rfftfreq(length_samples, 1 / fs)
        gds = []
        for ir in irs:
            sp = np.fft.rfft(ir)
            gd = np.asarray(
                group_delay_direct(jnp.asarray(np.angle(sp)), f[1] - f[0])
            )
            gds.append(gd * 1e3)
        mat = np.stack(gds, axis=1)
        return general_plot(
            f,
            mat,
            range_hz,
            ylabel="Group delay / ms",
            labels=[f"Filter {n}" for n in range(mat.shape[1])],
        )

    # ======== Saving / copying ==============================================
    def save_filterbank(self, path: str):
        path = check_format_in_path(path, "pkl")
        with open(path, "wb") as data_file:
            dump(self, data_file, HIGHEST_PROTOCOL)
        return self

    def copy(self) -> "FilterBank":
        return deepcopy(self)

    def show_info(self):
        print(self.metadata_str)
        return self
