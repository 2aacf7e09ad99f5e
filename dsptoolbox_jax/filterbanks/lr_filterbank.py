"""Linkwitz-Riley crossover filter bank.

Behavioral reference: `dsptoolbox/filterbanks/_filterbank.py:45-663`
(`LRFilterBank`). The band-split cascade with allpass phase correction is
applied with the blocked IIR kernel, batched over channels; per-sample state
streaming keeps scipy's zi conventions.
"""

from __future__ import annotations

from warnings import warn

import jax.numpy as jnp
import numpy as np
from scipy.signal import butter, sosfilt_zi

from ..classes.multibandsignal import MultiBandSignal
from ..classes.signal import Signal
from ..ops.iir import sosfilt, sosfiltfilt
from ..standard.enums import FilterBankMode


def _get_2nd_order_linkwitz_riley(freq: float, fs: int):
    """Sallen-Key (Q=0.5) 2nd-order LR crossover SOS pair; the high band is
    phase-inverted (`_filterbank.py:1307-1346`)."""
    w0 = 2 * np.pi * freq / fs
    K = np.tan(w0 / 2)
    q = 0.5
    denom = K**2 * q + K + q
    a = np.array([1.0, 2 * q * (K**2 - 1) / denom, (K**2 * q - K + q) / denom])
    b_lp = np.array([K**2 * q / denom, 2 * K**2 * q / denom, K**2 * q / denom])
    b_hp = np.array([q / denom, -2 * q / denom, q / denom])
    # invert high band polarity (LR2 convention)
    lp = np.hstack([b_lp, a])[None, :]
    hp = np.hstack([-b_hp, a])[None, :]
    return lp, hp


class LRFilterBank:
    """Near-perfect-magnitude-reconstruction crossover bank."""

    def __init__(
        self,
        freqs,
        order=4,
        sampling_rate_hz: int = 48000,
        info: dict | None = None,
    ):
        if info is None:
            info = {}
        freqs = np.atleast_1d(np.asarray(freqs).squeeze())
        order = np.atleast_1d(np.asarray(order).squeeze())
        if len(order) == 1:
            order = np.ones(len(freqs)) * order
        assert np.max(freqs) <= sampling_rate_hz // 2, (
            "Highest frequency is above nyquist frequency for the given "
            "sampling rate"
        )
        assert len(freqs) == len(order), (
            "Number of frequencies and number of order of the crossovers "
            "do not match"
        )
        for o in order:
            if o % 2 != 0 and o != 1:
                warn(
                    "Order of the crossovers is recommended to be even. "
                    "Odd orders have band crossing at -3 dB and are not "
                    "really Linkwitz-Riley crossovers, although they have "
                    "perfect magnitude reconstruction."
                )
        idx = freqs.argsort()
        self.freqs = freqs[idx]
        self.order = order[idx]
        self.number_of_cross = len(freqs)
        self.number_of_bands = self.number_of_cross + 1
        self.sampling_rate_hz = sampling_rate_hz
        self._compute_center_frequencies()
        self._create_filters_sos()
        self._generate_metadata()
        self.info: dict = self.info | info

    def _compute_center_frequencies(self):
        val = 0
        centers = []
        for cr in self.freqs:
            centers.append((val + cr) / 2)
            val = cr
        centers.append((val + self.sampling_rate_hz // 2) / 2)
        self.center_frequencies = np.asarray(centers)

    def _generate_metadata(self):
        if not hasattr(self, "info"):
            self.info = {}
        self.info["crossover_frequencies"] = self.freqs
        self.info["crossover_orders"] = self.order
        self.info["number_of_crossovers"] = self.number_of_cross
        self.info["number_of_bands"] = self.number_of_bands
        self.info["sampling_rate_hz"] = self.sampling_rate_hz

    def _create_filters_sos(self):
        self.sos = []
        for i in range(self.number_of_cross):
            if self.order[i] == 2:
                lp, hp = _get_2nd_order_linkwitz_riley(
                    self.freqs[i], self.sampling_rate_hz
                )
                self.sos.append([lp, hp])
                continue
            if self.order[i] % 2 == 0:
                assert self.order[i] % 4 == 0, (
                    f"{self.order[i]} order is not supported for crossover"
                )
                order = int(self.order[i] // 2)
            else:
                order = int(self.order[i])
            lp = butter(
                order,
                self.freqs[i],
                btype="lowpass",
                fs=self.sampling_rate_hz,
                output="sos",
            )
            hp = butter(
                order,
                self.freqs[i],
                btype="highpass",
                fs=self.sampling_rate_hz,
                output="sos",
            )
            if self.order[i] % 2 == 0:
                lp = np.vstack([lp, lp])
                hp = np.vstack([hp, hp])
            self.sos.append([lp, hp])

    # ======== streaming state ==============================================
    def initialize_zi(self, number_of_channels: int = 1):
        """Per-channel zi trees matching the reference layout
        (`_filterbank.py:231-258`)."""
        self.channels_zi = []
        for _ in range(number_of_channels):
            cross_zi = []
            allpass_zi = []
            for i in range(self.number_of_cross):
                cross_zi.append(
                    [sosfilt_zi(self.sos[i][0]), sosfilt_zi(self.sos[i][1])]
                )
                al = []
                for i2 in range(self.number_of_cross):
                    al.append(
                        [
                            sosfilt_zi(self.sos[i2][0]),
                            sosfilt_zi(self.sos[i2][1]),
                        ]
                    )
                allpass_zi.append(al)
            self.channels_zi.append([cross_zi, allpass_zi])
        return self

    # ======== filtering =====================================================
    def filter_signal(
        self,
        s: Signal,
        mode: FilterBankMode = FilterBankMode.Parallel,
        activate_zi: bool = False,
        zero_phase: bool = False,
        mesh=None,
    ):
        """Split into bands with allpass corrections
        (`_filterbank.py:222-320`). Channels run batched on device.

        ``mesh`` is accepted for API uniformity with `FilterBank` but
        ignored: the LR crossover tree is sequential across stages (each
        band is the previous stage's output), so the band axis cannot
        shard."""
        if mode == FilterBankMode.Sequential:
            warn(
                "sequential mode is not supported for this filter bank. "
                "It is automatically changed to summed"
            )
            mode = FilterBankMode.Summed
        assert s.sampling_rate_hz == self.sampling_rate_hz, (
            "Sampling rates do not match"
        )
        assert not (activate_zi and zero_phase), (
            "Zero phase filtering and activating zi is a valid setting"
        )
        C = s.number_of_channels
        in_sig = s.time_data_jax.T  # (C, T)
        bands = []

        if activate_zi:
            if (
                not hasattr(self, "channels_zi")
                or len(self.channels_zi) != C
            ):
                self.initialize_zi(C)
            out_np = np.zeros((s.length_samples, C, self.number_of_bands))
            in_np = np.asarray(in_sig)
            for ch in range(C):
                x = jnp.asarray(in_np[ch])
                for cn in range(self.number_of_cross):
                    band, x = self._two_way_split_zi(x, ch, cn)
                    for ap_n in range(cn + 1, self.number_of_cross):
                        band = self._allpass_zi(band, ch, cn, ap_n)
                    out_np[:, ch, cn] = np.asarray(band)
                out_np[:, ch, self.number_of_cross] = np.asarray(x)
            new_time_data = out_np
            bands = [
                s.copy_with_new_time_data(new_time_data[:, :, n])
                for n in range(self.number_of_bands)
            ]
        else:
            # One jitted program for the whole split cascade instead of one
            # dispatch per op, and the band outputs stay device-resident.
            # jit caches per (T, C) shape on the instance.
            band_arrays = self._band_split_program(zero_phase)(in_sig)
            bands = [s.copy_with_new_time_data(b) for b in band_arrays]
        d = dict(
            readme="MultiBandSignal made using Linkwitz-Riley filter bank",
            filterbank_freqs=self.freqs,
            filterbank_order=self.order,
        )
        out_sig = MultiBandSignal(bands=bands, same_sampling_rate=True, info=d)
        if mode == FilterBankMode.Summed:
            return out_sig.collapse()
        return out_sig

    def _two_way_split_zi(self, x, ch, cn):
        cross_zi = self.channels_zi[ch][0][cn]
        s_l, zf_l = sosfilt(
            self.sos[cn][0], x, zi=jnp.asarray(cross_zi[0])
        )
        s_h, zf_h = sosfilt(
            self.sos[cn][1], x, zi=jnp.asarray(cross_zi[1])
        )
        cross_zi[0] = np.asarray(zf_l)
        cross_zi[1] = np.asarray(zf_h)
        return s_l, s_h

    def _allpass_zi(self, x, ch, cn, ap_n):
        ap_zi = self.channels_zi[ch][1][cn][ap_n]
        s_l, zf_l = sosfilt(self.sos[ap_n][0], x, zi=jnp.asarray(ap_zi[0]))
        s_h, zf_h = sosfilt(self.sos[ap_n][1], x, zi=jnp.asarray(ap_zi[1]))
        ap_zi[0] = np.asarray(zf_l)
        ap_zi[1] = np.asarray(zf_h)
        return s_l + s_h

    def _composite_band_responses(self, nfft: int) -> np.ndarray:
        """Per-band composite crossover+allpass responses on the rfft
        grid, host-f64, cached per nfft → complex64 ``(B, F)``."""
        cache = self.__dict__.setdefault("_resp_cache", {})
        got = cache.get(nfft)
        if got is None:
            from ..ops.iir_freq import sos_freq_response_host

            lp = [
                sos_freq_response_host(self.sos[c][0], nfft, False)
                for c in range(self.number_of_cross)
            ]
            hp = [
                sos_freq_response_host(self.sos[c][1], nfft, False)
                for c in range(self.number_of_cross)
            ]
            spectra = []
            cur = np.ones_like(lp[0])
            for cn in range(self.number_of_cross):
                band = cur * lp[cn]
                cur = cur * hp[cn]
                for ap_n in range(cn + 1, self.number_of_cross):
                    band = band * (lp[ap_n] + hp[ap_n])
                spectra.append(band)
            spectra.append(cur)
            got = np.stack(spectra).astype(np.complex64)
            cache[nfft] = got
        return got

    def __getstate__(self):
        # jitted programs are runtime caches: not picklable/deepcopyable
        state = self.__dict__.copy()
        state.pop("_jit_filtered", None)
        state.pop("_jit_zero_phase", None)
        state.pop("_resp_cache", None)
        return state

    def _band_split_program(self, zero_phase: bool):
        """Jitted band-split cascade ``x (C, T) → (B, C, T)``; built once
        per mode and cached on the instance (jit handles shape variants)."""
        import jax

        key = "_jit_zero_phase" if zero_phase else "_jit_filtered"
        cached = self.__dict__.get(key)
        if cached is not None:
            return cached

        if zero_phase:

            def program(x):
                outs = []
                for cn in range(self.number_of_cross):
                    factor = (
                        1
                        if self.order[cn] % 2 == 1 or self.order[cn] == 2
                        else 2
                    )
                    valid = self.sos[cn][0].shape[0] // factor
                    outs.append(sosfiltfilt(self.sos[cn][0][:valid], x))
                    x = sosfiltfilt(self.sos[cn][1][:valid], x)
                outs.append(x)
                # per-band (T, C) device arrays (no host round trip)
                return tuple(jnp.swapaxes(b, 0, 1) for b in outs)

        else:

            def _freq_nfft(T: int):
                # the whole split tree is zero-state: one forward rfft and
                # composite per-band responses replace the sosfilt chain
                # (exact frequency sampling, `ops.iir_freq`)
                from ..ops.iir_freq import decay_margin

                margins = []
                for pair in self.sos:
                    for sos in pair:
                        margins.append(decay_margin(sos))
                if any(m is None for m in margins):
                    return None
                from ..ops.fft_conv import next_fast_len

                nfft = int(next_fast_len(T + max(margins), real=True))
                return nfft if nfft <= 4 * T else None

            def program(x):
                T = x.shape[-1]
                nfft = _freq_nfft(T)
                if nfft is not None:
                    # the per-band composite responses are
                    # INPUT-INDEPENDENT: evaluated once on the host in
                    # f64 (cached per nfft) and baked in as literals —
                    # on-device evaluation cost ~9 GFLOP/call that XLA
                    # does not constant-fold at these sizes (round-4
                    # trace, docs/STATUS.md)
                    resp = self._composite_band_responses(nfft)
                    X = jnp.fft.rfft(x, n=nfft, axis=-1)
                    resp_j = jax.lax.complex(
                        jnp.asarray(resp.real), jnp.asarray(resp.imag)
                    )  # (B, F)
                    stacked = X[None, :, :] * resp_j[:, None, :]
                    # ONE batched inverse FFT for every band instead of
                    # k+1 separate irffts
                    td = jnp.fft.irfft(stacked, n=nfft, axis=-1)[..., :T]
                    return tuple(
                        jnp.swapaxes(td[b], 0, 1)
                        for b in range(td.shape[0])
                    )
                outs = []
                for cn in range(self.number_of_cross):
                    band, _ = sosfilt(self.sos[cn][0], x)
                    x, _ = sosfilt(self.sos[cn][1], x)
                    for ap_n in range(cn + 1, self.number_of_cross):
                        lo, _ = sosfilt(self.sos[ap_n][0], band)
                        hi, _ = sosfilt(self.sos[ap_n][1], band)
                        band = lo + hi
                    outs.append(band)
                outs.append(x)
                # per-band (T, C) device arrays (no host round trip)
                return tuple(jnp.swapaxes(b, 0, 1) for b in outs)

        jitted = jax.jit(program)
        self.__dict__[key] = jitted
        return jitted

    # ======== getters / plots ===============================================
    def get_ir(
        self,
        length_samples: int,
        mode: FilterBankMode = FilterBankMode.Parallel,
        zero_phase: bool = False,
    ):
        from ..generators import dirac

        d = dirac(
            length_samples=length_samples,
            number_of_channels=1,
            sampling_rate_hz=self.sampling_rate_hz,
        )
        return self.filter_signal(
            d, mode=mode, zero_phase=zero_phase, activate_zi=False
        )

    def plot_magnitude(
        self,
        length_samples: int = 2048,
        mode: FilterBankMode = FilterBankMode.Parallel,
        range_hz=[20.0, 20e3],
        zero_phase: bool = False,
    ):
        from ..helpers.gain_and_level import to_db
        from ..plots import general_plot

        ir = self.get_ir(
            length_samples, FilterBankMode.Parallel, zero_phase=zero_phase
        )
        f = np.fft.rfftfreq(length_samples, 1 / self.sampling_rate_hz)
        # host magnitude of the host spectra
        specs = [
            np.asarray(to_db(np.abs(np.fft.rfft(b.time_data[:, 0])), True))
            for b in ir.bands
        ]
        mat = np.stack(specs, axis=1)
        if mode == FilterBankMode.Summed:
            total = np.sum(
                np.stack([b.time_data[:, 0] for b in ir.bands], 1), axis=1
            )
            mat = np.asarray(to_db(np.abs(np.fft.rfft(total)), True))[
                :, None
            ]
        return general_plot(
            f,
            mat,
            range_hz,
            ylabel="Magnitude / dB",
            labels=[f"Band {n}" for n in range(mat.shape[1])],
        )

    def plot_phase(self, length_samples: int = 2048, range_hz=[20.0, 20e3]):
        from ..plots import general_plot

        ir = self.get_ir(length_samples, FilterBankMode.Parallel)
        f = np.fft.rfftfreq(length_samples, 1 / self.sampling_rate_hz)
        mat = np.stack(
            [
                np.angle(np.fft.rfft(b.time_data[:, 0]))
                for b in ir.bands
            ],
            axis=1,
        )
        return general_plot(
            f,
            mat,
            range_hz,
            ylabel="Phase / rad",
            labels=[f"Band {n}" for n in range(mat.shape[1])],
        )

    def plot_group_delay(
        self, length_samples: int = 2048, range_hz=[20.0, 20e3]
    ):
        import jax.numpy as jnp2

        from ..plots import general_plot
        from ..standard.backend import group_delay_direct

        ir = self.get_ir(length_samples, FilterBankMode.Parallel)
        f = np.fft.rfftfreq(length_samples, 1 / self.sampling_rate_hz)
        mats = []
        for b in ir.bands:
            ph = np.angle(np.fft.rfft(b.time_data[:, 0]))
            mats.append(
                np.asarray(
                    group_delay_direct(jnp2.asarray(ph), f[1] - f[0])
                )
                * 1e3
            )
        return general_plot(
            f,
            np.stack(mats, axis=1),
            range_hz,
            ylabel="Group delay / ms",
            labels=[f"Band {n}" for n in range(len(mats))],
        )

    def show_info(self):
        print(self.info)
        return self

    def save_filterbank(self, path: str = "filterbank"):
        """Pickle persistence (`_filterbank.py:635-660`)."""
        from pickle import HIGHEST_PROTOCOL, dump

        from ..helpers.other import check_format_in_path

        path = check_format_in_path(path, "pkl")
        with open(path, "wb") as data_file:
            dump(self, data_file, HIGHEST_PROTOCOL)
        return self

    def copy(self):
        from copy import deepcopy

        return deepcopy(self)
