"""Transforms backend: wavelets, VQT kernels, warping, arbitrary DFT.

Behavioral reference: `dsptoolbox/transforms/_transforms.py`.

Device notes:
- the arbitrary-frequency DFT (numba kernel #3 in the reference,
  `_transforms.py:466-500`) is one chunked complex matmul.
- synchrosqueezing's triple reassignment loop becomes a one-hot scatter-add
  over the frequency axis on device.
- time-series warping keeps the reference's allpass-chain recursion but runs
  it as a `lax.scan` whose step applies the blocked first-order allpass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from scipy.signal import get_window


def pitch2frequency(tuning_a_hz: float = 440) -> np.ndarray:
    """MIDI pitches 0..127 → Hz (`_transforms.py:10-26`)."""
    N = 128
    return tuning_a_hz * 2 ** ((np.arange(N) - 69) / 12)


class Wavelet:
    """Base wavelet (API parity with `_transforms.py:29-83`)."""

    def get_base_wavelet(self):
        raise NotImplementedError("Wavelet function has not been implemented")

    def get_wavelet(self, f, fs):
        raise NotImplementedError("Wavelet function has not been implemented")

    def get_center_frequency(self):
        x, func = self.get_base_wavelet()
        ind = np.argmax(np.abs(np.fft.fft(func)))
        domain = x[-1] - x[0]
        return ind / domain

    def get_scale_lengths(self, frequencies, fs: int):
        scales = np.atleast_1d(
            self.get_center_frequency() / frequencies * fs
        )
        x, _ = self.get_base_wavelet()
        return (scales * (x[-1] - x[0]) + 1).astype(int)


class MorletWavelet(Wavelet):
    """Complex Morlet wavelet (`_transforms.py:86-225`)."""

    def __init__(
        self,
        b: float | None = None,
        h: float | None = None,
        scale: float = 1.0,
        precision_bounds: float = 1e-5,
        step: float = 5e-3,
        interpolation: bool = True,
    ):
        assert b is not None or h is not None, "Either b or h must be passed"
        self.b = h**2 / np.log(2) / 4 if h is not None else b
        self.scale = scale
        t = np.sqrt(self.b * np.log(1 / precision_bounds))
        self.bounds = [-t, t]
        self.step = step
        self.interpolation = interpolation

    def _get_x(self) -> np.ndarray:
        return np.arange(
            self.bounds[0], self.bounds[1] + self.step, self.step
        )

    def get_base_wavelet(self):
        x = self._get_x()
        return x, 1 / np.sqrt(np.pi * self.b) * np.exp(
            2j * np.pi / self.scale * x
        ) * np.exp(-(x**2) / self.b)

    def get_center_frequency(self) -> float:
        return 1 / self.scale

    def get_wavelet(self, f, fs: int):
        scales = np.atleast_1d(self.get_center_frequency() / f * fs)
        x, base = self.get_base_wavelet()
        wave = []
        for scale in scales:
            inds = np.arange(scale * (x[-1] - x[0]) + 1) / (
                scale * self.step
            )
            trunc = inds.astype(int)
            trunc = trunc[trunc < len(base)]
            if self.interpolation:
                # vectorized linear interpolation (reference does a loop,
                # `_transforms.py:205-225`)
                frac = inds[: len(trunc)] - trunc
                nxt = np.minimum(trunc + 1, len(base) - 1)
                wavef = base[trunc] + (base[nxt] - base[trunc]) * frac
                wavef[-1] = base[trunc[-1]]
            else:
                wavef = base[trunc]
            if len(scales) == 1:
                return wavef
            wave.append(wavef)
        return wave


def squeeze_scalogram(
    scalogram: np.ndarray,
    freqs: np.ndarray,
    fs: int,
    delta_w: float = 0.05,
    apply_frequency_normalization: bool = False,
) -> np.ndarray:
    """Synchrosqueezing via phase-transform reassignment
    (`_transforms.py:227-301`). The per-(f,t,ch) Python loop becomes a
    one-hot scatter over frequency bins, run as ONE jitted device
    program instead of ~20 eager dispatches."""
    from .._config import run_jitted_complex

    freqs = np.asarray(freqs)
    return run_jitted_complex(
        lambda sc: _squeeze_core(
            sc, freqs, fs, delta_w, apply_frequency_normalization
        ),
        scalogram,
    )


def _squeeze_core(
    sc: jnp.ndarray,
    freqs: np.ndarray,
    fs: int,
    delta_w: float = 0.05,
    apply_frequency_normalization: bool = False,
) -> jnp.ndarray:
    """Traceable synchrosqueezing body: complex scalogram ``(F, T, C)`` →
    complex synchrosqueezed matrix, all inside the caller's trace."""
    scalpow = jnp.abs(sc) ** 2
    valid = scalpow > 1e-40

    # phase transform: d/dt of the scalogram (np.gradient semantics)
    inner = (sc[:, 2:] - sc[:, :-2]) / 2.0
    first = (sc[:, 1] - sc[:, 0])[:, None]
    last = (sc[:, -1] - sc[:, -2])[:, None]
    ph = jnp.concatenate([first, inner, last], axis=1)
    ph = jnp.where(valid, (ph / jnp.where(valid, sc, 1.0)).imag / 2 / np.pi, 0.0)
    ph = jnp.abs(ph.real) * fs

    # nearest query bin via searchsorted on the (host-sorted) frequency
    # grid — the dense |freqs - ph| distance tensor would be O(F²·T·C)
    # (tens of GB at audio sizes); this is O(F·T·C·log F)
    order = np.argsort(np.asarray(freqs))
    freqs_sorted = np.asarray(freqs)[order]
    fs_j = jnp.asarray(freqs_sorted)
    pos = jnp.searchsorted(fs_j, ph)
    lo = jnp.clip(pos - 1, 0, len(freqs) - 1)
    hi = jnp.clip(pos, 0, len(freqs) - 1)
    pick_hi = jnp.abs(fs_j[hi] - ph) < jnp.abs(fs_j[lo] - ph)
    ind_sorted = jnp.where(pick_hi, hi, lo)
    min_diff = jnp.abs(fs_j[ind_sorted] - ph)
    ind = jnp.asarray(order)[ind_sorted]  # back to original bin order
    keep = (min_diff <= jnp.asarray(delta_w * freqs)[:, None, None]) & valid

    contrib = sc
    if apply_frequency_normalization:
        normalizations = (freqs / fs) ** (3 / 2)
        contrib = sc * jnp.asarray(normalizations)[:, None, None]
    contrib = jnp.where(keep, contrib, 0.0)

    # scatter-add each (f, t, c) cell's energy onto its nearest query bin
    Tn, C = contrib.shape[1], contrib.shape[2]
    tt = jnp.arange(Tn)[None, :, None]
    cc = jnp.arange(C)[None, None, :]
    sync = jnp.zeros((len(freqs), Tn, C), contrib.dtype)
    sync = sync.at[ind, tt, cc].add(contrib)
    return sync


def get_kernels_vqt(
    q: float,
    highest_f: float,
    bins_per_octave: int,
    sampling_rate_hz: int,
    window_type,
    gamma: float,
):
    """Complex VQT kernels, high→low frequency
    (`_transforms.py:327-384`)."""
    freqs = highest_f * 2 ** (
        -1 / bins_per_octave * np.arange(bins_per_octave)
    )
    factor = 2 ** (1 / bins_per_octave) - 1
    lengths = np.round(
        q * sampling_rate_hz / ((freqs * factor) + gamma)
    ).astype(int)
    kernels = []
    for ind in range(len(lengths)):
        w = get_window(window_type, lengths[ind], fftbins=False)
        w = w / w.sum()
        kernels.append(
            w
            * np.exp(
                1j
                * freqs[ind]
                * 2
                * np.pi
                / sampling_rate_hz
                * np.arange(-lengths[ind] // 2, lengths[ind] // 2)
            )
        )
    return kernels


def warp_time_series(td: np.ndarray, warping_factor: float) -> np.ndarray:
    """Warp/unwarp a time series through the cascaded-allpass expansion
    (`_transforms.py:386-430`). The outer sample loop runs as one
    `lax.scan`; the inner allpass is closed-form per step."""
    T, C = td.shape
    lam = warping_factor
    tdj = jnp.asarray(td)

    # allpass A(z) = (-lam + z^-1) / (1 - lam z^-1) applied to the running
    # dirac state; first-order recursion evaluated with an inner scan over
    # time (carried state, one multiply-add per element)
    b = np.array([-lam, 1.0])
    a = np.array([1.0, -lam])

    from ..ops.iir_block import lfilter_block

    dirac0 = jnp.zeros(T).at[0].set(1.0)
    # warped = sum_n dirac_n * td[n, :]; accumulate inside scan to avoid
    # materializing the full (T, T) dirac matrix
    def step_acc(carry, x_n):
        dirac, acc = carry
        new_dirac, _ = lfilter_block(b, a, dirac)
        acc = acc + new_dirac[:, None] * x_n[None, :]
        return (new_dirac, acc), None

    acc0 = dirac0[:, None] * tdj[0][None, :]
    (_, warped), _ = jax.lax.scan(step_acc, (dirac0, acc0), tdj[1:])
    return np.asarray(warped)


def get_warping_factor(warping_factor, fs_hz: int) -> float:
    """Bark/ERB bilinear warping factors (Smith & Abel 1999;
    `_transforms.py:433-464`)."""
    if isinstance(warping_factor, float):
        assert np.abs(warping_factor) < 1.0, (
            "Warping factor has to be in ]-1; 1["
        )
        return warping_factor
    if isinstance(warping_factor, str):
        wf = warping_factor.lower()
        invert = wf[-1] not in ("k", "b")
        if "bark" in wf:
            value = -1.0 * (
                1.0674 * (2.0 / np.pi * np.arctan(0.06583 * fs_hz)) ** 0.5
                - 0.1916
            )
        elif "erb" in wf:
            value = -1.0 * (
                0.7446 * (2.0 / np.pi * np.arctan(0.1418 * fs_hz)) ** 0.5
                + 0.03237
            )
        else:
            raise ValueError("Warping factor approximation is not supported")
        return -value if invert else value
    raise TypeError("Invalid type for warping factor")


def dft_core(
    time_data: jnp.ndarray,
    freqs_normalized: np.ndarray,
    chunk: int = 256,
) -> jnp.ndarray:
    """Arbitrary-frequency DFT: ``spec[f, c] = Σ_n exp(-2πi f n / N) x[n, c]``
    as chunked complex matmuls (replaces numba kernel #3,
    `_transforms.py:466-500`)."""
    T, C = time_data.shape
    F = len(freqs_normalized)
    pad_f = (-F) % chunk
    fr = np.pad(np.asarray(freqs_normalized, np.float64), (0, pad_f))

    # The phase f·n/T reaches ~1e5 cycles for long signals; a straight
    # fp32 product loses the fractional part (only `mod 1` matters), so:
    #   n = n1·B + n0,  phase = [(ω·B·n1) mod 1] + ω·n0,  ω = (f/T) mod 1.
    # The coarse table is reduced mod 1 in f64 HOST-side (exact); the fine
    # term is < B cycles, safely within fp32.
    B = 1024
    n1_max = (T + B - 1) // B
    omega = np.mod(fr / T, 1.0)  # (F',) f64
    coarse = np.mod(
        np.mod(omega * B, 1.0)[:, None] * np.arange(n1_max)[None, :], 1.0
    )  # (F', N1) f64 — still accumulates, reduce per-step:
    # exact per-row: ((ω·B mod 1)·n1) mod 1 drifts for large n1 in f64 only
    # below 1e-9 for n1 < 1e6 — acceptable (f64 host math).
    coarse_b = coarse.reshape(-1, chunk, n1_max)
    omega_b = omega.reshape(-1, chunk)

    from .._config import default_float

    real_dt = np.dtype(default_float())
    cplx_dt = (
        jnp.complex128 if real_dt == np.float64 else jnp.complex64
    )

    n_idx = np.arange(T)
    n1 = (n_idx // B).astype(np.int32)
    n0 = (n_idx % B).astype(real_dt)

    td = jnp.asarray(time_data, cplx_dt)
    n1j = jnp.asarray(n1)
    n0j = jnp.asarray(n0)

    def body(carry, fa):
        coarse_c, omega_c = fa  # (chunk, N1), (chunk,)
        phase = coarse_c[:, n1j] + omega_c[:, None] * n0j[None, :]
        M = jnp.exp((-2j * np.pi) * phase.astype(cplx_dt))
        out = jnp.einsum(
            "ft,tc->fc", M, td, precision=jax.lax.Precision.HIGHEST
        )
        return carry, out

    _, chunks = jax.lax.scan(
        body,
        0,
        (
            jnp.asarray(coarse_b, real_dt),
            jnp.asarray(omega_b, real_dt),
        ),
    )
    return chunks.reshape(-1, C)[:F]
