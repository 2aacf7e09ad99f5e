"""Smoke check of the measurement path on the GPU.

Drives the public measurement chain once at full size, in one process,
and compares every result with a plain float64 numpy/scipy reference
(`tests/_plain_reference.py`) computed in the same process:

  phase 0  the device: a GPU must be visible; prints its name and power
           limit
  phase 1  sweep -> 8 image-source RIRs -> recording -> spectral
           deconvolution -> window -> T20
  phase 2  Welch spectrum, CSM, spectrogram and ISTFT of 16 x 8 s
  phase 3  Linkwitz-Riley crossover and gammatone bank over 16 x 8 s
  phase 4  the headline jitted chain of `bench.py` at 16 x 384000
  phase 5  DAS map (64 mics x 900 points, 513 bins), complex smoothing
           of 65537 bins, device image-source RIRs against the f64 host
           oracle
  timings  first-call and warm times of the plain XLA ops that the main
           path runs, and both sides of each backend-dependent choice

Every input is generated from ``--seed``. Each comparison prints its
error beside its limit and the limit's reason. The last line of standard
output is one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed; otherwise the script exits 1.
Without a GPU it exits 2 and prints no result.

``--four-cards`` runs only the multi-device path (the `parallel` module
and the ``mesh=`` arguments of the public classes) on a 1-D mesh of four
GPUs and compares each result with the same computation on one card.

Run:  python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback
from dataclasses import dataclass

REPO = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Sizes:
    fs: int = 48000
    sweep_s: float = 10.0
    rir_s: float = 0.5
    n_rirs: int = 8
    max_order: int | None = None  # image order: full (from the room's T60)
    ir_window: int = 2**15
    channels: int = 16
    signal_s: float = 8.0
    mics: int = 64
    grid_side: int = 30
    array_signal_s: float = 1.0
    smooth_len: int = 2**17
    fleet: tuple = (16384, 8000)  # RIR fleet for the prefix-sum timing
    mesh_fleet: tuple = (4096, 24000)  # RIR fleet for the sharded battery


FULL = Sizes()


class Recorder:
    """Collects comparisons and timings; prints each as it arrives."""

    def __init__(self, card: str):
        self.card = card
        self.failures: list[str] = []

    def check(self, phase, name, err, limit, why):
        ok = bool(err <= limit)  # NaN fails
        print(
            f"[{phase}] {name}: err={err:.3e} limit={limit:.1e} "
            f"{'OK' if ok else 'FAIL'} ({why})",
            flush=True,
        )
        if not ok:
            self.failures.append(f"{phase}: {name}")

    def require(self, phase, name, cond, detail=""):
        print(
            f"[{phase}] {name}: {'OK' if cond else 'FAIL'} {detail}",
            flush=True,
        )
        if not cond:
            self.failures.append(f"{phase}: {name}")

    def timing(self, phase, name, first_s, warm_s):
        print(
            f"[timing] {phase} {name}: first={first_s:.6f} s "
            f"warm_median={warm_s:.6f} s | {self.card}",
            flush=True,
        )


def _ready(out):
    import jax

    return jax.block_until_ready(out)


def timed(fn, n_warm: int = 5):
    """``(result, first-call seconds, median of n_warm warm calls)``; each
    call ends in `jax.block_until_ready` on what ``fn`` returns."""
    t0 = time.perf_counter()
    out = _ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(n_warm):
        t0 = time.perf_counter()
        _ready(fn())
        warm.append(time.perf_counter() - t0)
    return out, first, statistics.median(warm)


def _imports():
    for path in (REPO, os.path.join(REPO, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import _plain_reference as ref

    return ref


# ---------------------------------------------------------------- phase 1
def phase1(sz: Sizes, seed: int, rec: Recorder):
    import numpy as np
    from scipy.signal import fftconvolve

    import dsptoolbox_jax as dsp
    from dsptoolbox_jax import room_acoustics as ra

    ref = _imports()
    fs = sz.fs
    sweep = dsp.generators.chirp(
        fs, range_hz=[20, 20000], length_seconds=sz.sweep_s,
        padding_end_seconds=sz.rir_s,
    )
    sweep_td = np.asarray(sweep.time_data)  # (T, 1)
    room, src, rcv = _fleet_geometry(sz, seed)
    rirs = np.asarray(
        ra.batch_synthetic_rirs(
            room, src, rcv, fs, total_length_seconds=sz.rir_s,
            max_order=sz.max_order,
        )
    )
    rec.require(
        "phase1", "RIR fleet shape/finite",
        rirs.shape == (sz.n_rirs, int(sz.rir_s * fs))
        and bool(np.all(np.isfinite(rirs))), str(rirs.shape),
    )
    T = sweep_td.shape[0]
    recorded = fftconvolve(
        sweep_td[:, 0].astype(np.float64)[None, :],
        rirs.astype(np.float64), axes=-1,
    )[:, :T].astype(np.float32)  # (n_rirs, T)

    def run():
        out = dsp.Signal(None, recorded.T, fs)
        inp = dsp.Signal(None, sweep_td, fs)
        ir = dsp.transfer_functions.spectral_deconvolve(out, inp)
        irw, _ = dsp.transfer_functions.window_ir(ir, sz.ir_window)
        t20, _ = dsp.room_acoustics.reverb_time(
            irw, dsp.room_acoustics.ReverbTime.T20
        )
        return np.asarray(ir.time_data), np.asarray(t20)

    (ir_td, t20), first, warm = timed(run)
    rec.timing(
        "phase1", f"deconvolve+window_ir+T20 {recorded.shape}", first, warm
    )
    ir_ref = ref.deconvolve(
        recorded.astype(np.float64), sweep_td[:, 0].astype(np.float64), fs
    )
    rec.check(
        "phase1", "deconvolved IRs vs numpy f64",
        ref.scale_relative_error(ir_td.T, ir_ref), 1e-4,
        "scale-relative; fp32 FFTs of ~5e5 points: rounding is ~1e-6, a "
        "TF32 or wrong-length path is >=1e-3",
    )
    t20_ref = np.array([ref.schroeder_t20(h, fs) for h in ir_ref])
    rec.check(
        "phase1", "T20 vs Schroeder T20 of the f64 IRs",
        float(np.max(np.abs(t20 - t20_ref) / t20_ref)), 1e-2,
        "relative; the library trims at the noise floor and applies the "
        "Lundeby/Chu corrections the plain integral omits",
    )


def _fleet_geometry(sz: Sizes, seed: int):
    import numpy as np

    from dsptoolbox_jax import room_acoustics as ra

    room = ra.ShoeboxRoom([6.0, 4.5, 3.0], t60_s=0.4)
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0.5, 0.5, 0.5]), np.array([5.5, 4.0, 2.5])
    src = rng.uniform(lo, hi, (sz.n_rirs, 3))
    rcv = rng.uniform(lo, hi, (sz.n_rirs, 3))
    return room, src, rcv


def _noise(sz: Sizes, seed: int, channels: int | None = None):
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    T = int(sz.signal_s * sz.fs)
    C = channels or sz.channels
    return (0.3 * rng.standard_normal((T, C))).astype(np.float32)


# ---------------------------------------------------------------- phase 2
def phase2(sz: Sizes, seed: int, rec: Recorder):
    import numpy as np

    import dsptoolbox_jax as dsp
    from dsptoolbox_jax.standard.enums import SpectrumScaling

    ref = _imports()
    fs = sz.fs
    x = _noise(sz, seed)

    def run():
        s = dsp.Signal(None, x, fs)
        s.set_spectrum_parameters(
            window_length_samples=1024, detrend=False,
            scaling=SpectrumScaling.PowerSpectralDensity,
        )
        _, sp = s.get_spectrum()
        _, csm = s.get_csm()
        _, _, S = s.get_spectrogram()
        y = dsp.transforms.istft(S, original_signal=s)
        return (
            np.asarray(sp), np.asarray(csm), np.asarray(S),
            np.asarray(y.time_data),
        )

    (sp, csm, S, y), first, warm = timed(run)
    rec.timing("phase2", f"Welch+CSM+STFT+ISTFT {x.T.shape}", first, warm)
    xt = x.T.astype(np.float64)
    why = (
        "scale-relative; fp32 1024-point FFTs averaged over 750 frames: "
        "rounding ~1e-6, TF32 products would give ~1e-3"
    )
    rec.check(
        "phase2", "Welch PSD vs scipy.signal.welch",
        ref.scale_relative_error(sp, ref.welch_psd(xt, fs, 1024, 512).T),
        1e-5, why,
    )
    rec.check(
        "phase2", "CSM vs scipy.signal.csd",
        ref.scale_relative_error(csm, ref.csm_welch(xt, fs, 1024, 512)),
        1e-5, why,
    )
    rec.check(
        "phase2", "STFT vs scipy.signal.stft",
        ref.scale_relative_error(S, ref.stft(xt, 1024, 512)), 1e-5, why,
    )
    rec.check(
        "phase2", "ISTFT round trip",
        ref.scale_relative_error(y, x), 1e-5,
        "scale-relative; fp32 inverse FFT and window-squared overlap-add",
    )


# ---------------------------------------------------------------- phase 3
def phase3(sz: Sizes, seed: int, rec: Recorder):
    import numpy as np

    import dsptoolbox_jax as dsp
    from dsptoolbox_jax.standard.enums import (
        FilterBankMode,
        FilterCoefficientsType,
    )

    ref = _imports()
    fs = sz.fs
    x = _noise(sz, seed)
    xt = x.T.astype(np.float64)
    lr = dsp.filterbanks.linkwitz_riley_crossovers(
        [250, 1000, 4000], 4, fs
    )
    gt = dsp.filterbanks.auditory_filters_gammatone(
        [50, 16000], sampling_rate_hz=fs
    )

    def device_bands(mb):
        return [b.time_data_jax for b in mb.bands]

    def run_lr():
        return device_bands(lr.filter_signal(dsp.Signal(None, x, fs)))

    def run_lr_zero_phase():
        return device_bands(
            lr.filter_signal(dsp.Signal(None, x, fs), zero_phase=True)
        )

    def run_gt():
        return gt.filter_signal(
            dsp.Signal(None, x, fs), FilterBankMode.Parallel
        )

    why_iir = (
        "scale-relative; fp32 recursion with poles within 3e-2 of the unit "
        "circle (250 Hz at 48 kHz): rounding ~1e-5, TF32 block products "
        "would exceed 1e-2"
    )
    for name, fn, zero_phase in (
        ("LR crossover", run_lr, False),
        ("LR crossover zero-phase", run_lr_zero_phase, True),
    ):
        bands, first, warm = timed(fn)
        rec.timing("phase3", f"{name} {x.T.shape}", first, warm)
        want = ref.linkwitz_riley_bands(lr.sos, xt, zero_phase=zero_phase)
        err = max(
            ref.scale_relative_error(np.asarray(b).T, w)
            for b, w in zip(bands, want)
        )
        rec.check(
            "phase3", f"{name}: 4 bands vs scipy sosfilt", err, 1e-3,
            why_iir,
        )

    mb, first, warm = timed(lambda: _gt_ready(run_gt()))
    rec.timing(
        "phase3", f"gammatone bank, {gt.number_of_filters} bands "
        f"{x.T.shape}", first, warm,
    )
    chans = [0, sz.channels - 1]
    err = 0.0
    for b, band in enumerate(mb.bands):
        sos = gt.filters[b].get_coefficients(FilterCoefficientsType.Sos)
        got = np.asarray(band.time_data)[:, chans] + 1j * np.asarray(
            band.time_data_imaginary
        )[:, chans]
        err = max(
            err,
            ref.scale_relative_error(got.T, ref.sosfilt(sos, xt[chans])),
        )
    rec.check(
        "phase3",
        f"gammatone: {gt.number_of_filters} bands (channels {chans}) vs "
        "scipy sosfilt", err, 1e-3, why_iir,
    )


def _gt_ready(mb):
    import jax

    jax.block_until_ready([b.time_data_jax for b in mb.bands])
    return mb


# ---------------------------------------------------------------- phase 4
def phase4(sz: Sizes, seed: int, rec: Recorder):
    import numpy as np

    import jax
    import jax.numpy as jnp

    import bench

    ref = _imports()
    fs = sz.fs
    T = int(sz.signal_s * fs)
    B = sz.channels
    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((B, T)).astype(np.float32)
    sos_bank = bench.crossover_bank(fs)
    pipeline, P = bench.build_pipeline(sos_bank, None, T)
    exc = np.fft.rfft(rng.standard_normal(T), n=P)
    reg = np.full(P // 2 + 1, 1e-3)
    fn = jax.jit(pipeline)
    args = (
        jnp.asarray(x),
        jnp.asarray(exc.astype(np.complex64)),
        jnp.asarray(reg, jnp.float32),
    )
    (energy, bands, ir), first, warm = timed(lambda: fn(*args))
    rec.timing("phase4", f"bench.build_pipeline {x.shape}", first, warm)
    rec.check(
        "phase4", "STFT energy vs numpy f64",
        ref.scale_relative_error(energy, ref.stft_energy(x, 1024, 512)),
        1e-5, "relative; sums of fp32 |S|^2 over every frame and bin",
    )
    bands = np.asarray(bands)
    err = max(
        ref.scale_relative_error(bands[:, b], ref.sosfilt(sos, x))
        for b, sos in enumerate(sos_bank)
    )
    rec.check(
        "phase4", "banked IIR (4 bands) vs scipy sosfilt", err, 1e-3,
        "scale-relative; fp32 blocked recursion with poles near the unit "
        "circle, TF32 products would exceed 1e-2",
    )
    H = np.conj(exc) / (np.abs(exc) ** 2 + reg)
    ir_ref = np.fft.irfft(
        np.fft.rfft(x.astype(np.float64), n=P) * H, n=P
    )[:, :T]
    rec.check(
        "phase4", "regularized deconvolution vs numpy f64",
        ref.scale_relative_error(ir, ir_ref), 1e-4,
        f"scale-relative; fp32 FFTs of {P} points",
    )


# ---------------------------------------------------------------- phase 5
def phase5(sz: Sizes, seed: int, rec: Recorder):
    import numpy as np

    import jax
    import jax.numpy as jnp

    import dsptoolbox_jax as dsp
    from dsptoolbox_jax import beamforming as bf
    from dsptoolbox_jax import room_acoustics as ra
    from dsptoolbox_jax.beamforming.beamforming import (
        _das_map_core,
        _simpson_uniform,
    )
    from dsptoolbox_jax.helpers.other import fractional_octave_bandwidth
    from dsptoolbox_jax.room_acoustics import _backend as ism
    from dsptoolbox_jax.standard.enums import SpectrumScaling, Window
    from dsptoolbox_jax.transfer_functions import SmoothingDomain
    from dsptoolbox_jax.transfer_functions._backend import (
        banded_smoothing_operands,
        complex_smoothing_banded,
    )

    ref = _imports()
    fs = sz.fs
    rng = np.random.default_rng(seed + 3)

    # --- DAS map through the public beamformer
    M = sz.mics
    radius = 0.5 * np.sqrt(rng.uniform(0, 1, M))
    angle = rng.uniform(0, 2 * np.pi, M)
    mics = bf.MicArray(
        {
            "x": radius * np.cos(angle),
            "y": radius * np.sin(angle),
            "z": np.zeros(M),
        }
    )
    side = np.linspace(-1.0, 1.0, sz.grid_side)
    grid = bf.Regular2DGrid(side, side, ["x", "y"], value3=1.0)
    src = bf.MonopoleSource(
        dsp.generators.noise(
            length_seconds=sz.array_signal_s, sampling_rate_hz=fs
        ),
        [0.2, -0.1, 1.0],
    )
    arr_sig = src.get_signals_on_array(mics)
    td = np.asarray(arr_sig.time_data)
    st = bf.SteeringVector(formulation=bf.SteeringVectorType.TrueLocation)

    def run_map():
        s = dsp.Signal(None, td, fs)
        s.set_spectrum_parameters(
            detrend=False, scaling=SpectrumScaling.PowerSpectralDensity
        )
        das = bf.BeamformerDASFrequency(s, mics, grid, st)
        return np.asarray(das.get_beamformer_map(2000, 3))

    m, first, warm = timed(run_map)
    rec.timing(
        "phase5", f"DAS map, public ({M} mics x {grid.number_of_points} "
        "points, 1/3 octave)", first, warm,
    )
    csm = ref.csm_welch(td.T.astype(np.float64), fs, 1024, 512)
    f = np.fft.rfftfreq(1024, 1 / fs)
    lo, hi = fractional_octave_bandwidth(2000, 3)
    i1 = int(np.argmin(np.abs(f - lo)))
    i2 = int(np.argmin(np.abs(f - hi)))
    i2 += i1 == i2
    amp, diff = (np.asarray(a) for a in st.get_amp_diff(grid, mics))
    c = 343.0
    band = csm[i1:i2] * (M / (M - 1)) * (1 - np.eye(M))
    mg = ref.das_map(band, amp, diff, f[i1:i2] * 2 * np.pi / c)
    mg[mg < 0] = 0
    want = grid.reconstruct_map_shape(
        _simpson_uniform(mg, dx=f[1] - f[0], axis=1)
    )
    why_q = (
        "scale-relative; fp32 quadratic forms at HIGHEST precision over "
        f"2M={2 * M} terms: rounding ~1e-6, TF32 would give ~1e-3"
    )
    rec.check(
        "phase5", "DAS map vs numpy f64", ref.scale_relative_error(m, want),
        1e-4, why_q,
    )

    # --- the DAS core over all 513 bins (the XLA path of the map)
    k_all = f * 2 * np.pi / c
    core = jax.jit(_das_map_core)
    dev_args = (
        jnp.asarray(amp, jnp.float32),
        jnp.asarray(diff, jnp.float32),
        jnp.asarray(k_all, jnp.float32),
        jnp.asarray(csm.real, jnp.float32),
        jnp.asarray(csm.imag, jnp.float32),
    )
    got, first, warm = timed(lambda: core(*dev_args))
    rec.timing(
        "phase5", f"_das_map_core ({len(f)} bins x {M} mics x "
        f"{grid.number_of_points} points)", first, warm,
    )
    rec.check(
        "phase5", f"DAS core, {len(f)} bins vs numpy f64",
        ref.scale_relative_error(got, ref.das_map(csm, amp, diff, k_all)),
        1e-4, why_q,
    )

    # --- complex smoothing of a long spectrum (the banded XLA path)
    n = sz.smooth_len
    decay = np.exp(-np.arange(n) / (0.05 * fs))[:, None]
    ir_td = (rng.standard_normal((n, 2)) * decay).astype(np.float32)
    ir = dsp.ImpulseResponse(None, ir_td, fs)
    spec, first, warm = timed(
        lambda: dsp.transfer_functions.complex_smoothing(
            ir, 3, SmoothingDomain.RealImaginary
        ).spectral_data
    )
    rec.timing(
        "phase5", f"complex_smoothing ({n // 2 + 1} bins x 2)", first,
        warm,
    )
    from scipy.signal.windows import hann

    fv = np.fft.rfftfreq(n, 1 / fs)
    sp_ref = np.fft.rfft(np.asarray(ir.time_data, np.float64), axis=0)
    rec.check(
        "phase5", f"complex smoothing, {n // 2 + 1} bins vs numpy f64",
        ref.scale_relative_error(
            spec, ref.complex_smoothing(sp_ref, fv, 3, hann(3000))
        ),
        1e-5,
        "scale-relative; fp32 weighted sums of <=15k bins at HIGHEST "
        "precision",
    )
    window_y = np.asarray(Window.Hann(3000, True))
    banded = jax.jit(
        lambda s, *ops: complex_smoothing_banded(s, fv, 3.0, window_y, ops)
    )
    operands = banded_smoothing_operands(fv, 3.0, window_y)
    sp_dev = jnp.asarray(sp_ref.astype(np.complex64))
    _, first, warm = timed(lambda: banded(sp_dev, *operands))
    rec.timing(
        "phase5", f"banded_matmul_xla smoothing ({n // 2 + 1} bins x 2)",
        first, warm,
    )

    # --- image-source RIRs on the device against the f64 host oracle
    room, src_pos, rcv_pos = _fleet_geometry(sz, seed)
    rirs = np.asarray(
        ra.batch_synthetic_rirs(
            room, src_pos, rcv_pos, fs, total_length_seconds=sz.rir_s,
            max_order=sz.max_order,
        )
    )
    same_bins = True
    err = 0.0
    ism.set_ism_device(False)
    try:
        for b in range(sz.n_rirs):
            host = np.asarray(
                ra.generate_synthetic_rir(
                    room, src_pos[b], rcv_pos[b], fs,
                    total_length_seconds=sz.rir_s, max_order=sz.max_order,
                ).time_data
            )[:, 0]
            nz_d, nz_h = np.nonzero(rirs[b])[0], np.nonzero(host)[0]
            same_bins &= bool(np.array_equal(nz_d, nz_h))
            if len(nz_d) and len(nz_h):
                # the single-RIR path normalizes the amplitude
                scale = host[nz_h[0]] / rirs[b][nz_d[0]]
                err = max(
                    err, ref.scale_relative_error(rirs[b] * scale, host)
                )
    finally:
        ism.set_ism_device(None)
    rec.require(
        "phase5", f"device ISM sample bins == f64 host oracle "
        f"({sz.n_rirs} RIRs)", same_bins,
    )
    rec.check(
        "phase5", "device ISM amplitudes vs f64 host oracle", err, 1e-5,
        "scale-relative; fp32 amplitudes of double-single placed images",
    )


# ------------------------------------------------------------- timings
def timings(sz: Sizes, seed: int, rec: Recorder):
    """Times of the plain XLA ops behind the main path, and both sides of
    each choice the library makes from the backend (CPU or not)."""
    import numpy as np
    from scipy.signal import butter

    import jax
    import jax.numpy as jnp

    from dsptoolbox_jax.ops.iir import sosfilt_zero_state
    from dsptoolbox_jax.ops.iir_block import sosfilt_block
    from dsptoolbox_jax.ops.prefix import cumsum_matmul
    from dsptoolbox_jax.ops.spectral import _windowed_frames
    from dsptoolbox_jax.ops.windows import get_window
    from dsptoolbox_jax.room_acoustics import _backend as ism
    from dsptoolbox_jax import room_acoustics as ra
    from dsptoolbox_jax.standard.enums import Window

    fs = sz.fs
    T = int(sz.signal_s * fs)
    rng = np.random.default_rng(seed + 4)
    x = jnp.asarray(rng.standard_normal((sz.channels, T)), jnp.float32)
    shape = tuple(x.shape)
    hi = jax.lax.Precision.HIGHEST

    def report(name, fn, *args):
        j = jax.jit(fn)
        _, first, warm = timed(lambda: j(*args))
        rec.timing("timings", name, first, warm)

    win = get_window(Window.Hann, 1024, symmetric=False)
    report(
        f"framing+window _windowed_frames {shape}, 1024/512",
        lambda v: _windowed_frames(v, win, 512, False), x,
    )
    sos8 = butter(8, 1000.0, fs=fs, output="sos")
    report(
        f"sosfilt_block {shape}, 4 sections",
        lambda v: sosfilt_block(sos8, v)[0], x,
    )

    # FFT length rule: powers of two and 3*2^k off the CPU, scipy's
    # 5-smooth lengths on the CPU (ops/fft_conv.next_fast_len)
    for n in (1 << 19, 3 << 17, 384000):
        report(
            f"rfft+irfft pair {shape}, n={n}",
            lambda v, n=n: jnp.fft.irfft(jnp.fft.rfft(v, n=n), n=n), x,
        )

    # short FIR kernels: direct convolution off the CPU, FFT on the CPU
    K = 256
    h = jnp.asarray(rng.standard_normal(K), jnp.float32)

    def direct(v, h):
        y = jax.lax.conv_general_dilated(
            v[:, None, :], jnp.flip(h)[None, None, :], (1,),
            [(K - 1, K - 1)], precision=hi,
        )
        return y[:, 0]

    def via_fft(v, h):
        n = T + K - 1
        return jnp.fft.irfft(
            jnp.fft.rfft(v, n=3 << 17) * jnp.fft.rfft(h, n=3 << 17),
            n=3 << 17,
        )[:, :n]

    report(f"FIR {K} taps direct {shape}", direct, x, h)
    report(f"FIR {K} taps via FFT {shape}", via_fft, x, h)

    # Schroeder integral: triangular-matmul prefix off the CPU, cumsum on
    # the CPU (room_acoustics/batch.batch_energy_decay)
    e = jnp.asarray(
        rng.standard_normal(sz.fleet) ** 2, jnp.float32
    )
    report(
        f"reverse prefix sum cumsum_matmul {sz.fleet}",
        lambda v: cumsum_matmul(v, reverse=True), e,
    )
    report(
        f"reverse prefix sum jnp.cumsum {sz.fleet}",
        lambda v: jnp.cumsum(v[..., ::-1], axis=-1)[..., ::-1], e,
    )

    # eager op-by-op (the CPU choice in _config.run_maybe_jitted) against
    # one jitted program, for the zero-state sosfilt of Filter.filter_signal
    _, first, warm = timed(lambda: sosfilt_zero_state(sos8, x))
    rec.timing("timings", f"sosfilt_zero_state eager {shape}", first, warm)
    report(
        f"sosfilt_zero_state jitted {shape}",
        lambda v: sosfilt_zero_state(sos8, v), x,
    )

    # image-source model: double-single device lattice off the CPU, f64
    # host lattice on the CPU
    room, src, rcv = _fleet_geometry(sz, seed)
    for on_device in (True, False):
        ism.set_ism_device(on_device)
        try:
            _, first, warm = timed(
                lambda: ra.generate_synthetic_rir(
                    room, src[0], rcv[0], fs,
                    total_length_seconds=sz.rir_s, max_order=sz.max_order,
                ).time_data_jax,
                n_warm=3,
            )
        finally:
            ism.set_ism_device(None)
        side = "device double-single" if on_device else "host f64"
        rec.timing("timings", f"image-source RIR, {side} (48 kHz, full "
                   "order)", first, warm)


# ------------------------------------------------------------ four cards
def four_cards(sz: Sizes, seed: int, rec: Recorder):
    """The multi-device path on a 1-D mesh of four GPUs, each result
    against the same computation on one card."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    import __graft_entry__ as entry
    import dsptoolbox_jax as dsp
    from dsptoolbox_jax import beamforming as bf
    from dsptoolbox_jax import parallel as par
    from dsptoolbox_jax.beamforming.beamforming import _das_map_core
    from dsptoolbox_jax.ops.fft_conv import fft_convolve
    from dsptoolbox_jax.ops.spectral import csm_welch
    from dsptoolbox_jax.room_acoustics.batch import batch_descriptors
    from dsptoolbox_jax.standard.enums import FilterBankMode

    ref = _imports()
    fs = sz.fs
    T = int(sz.signal_s * fs)
    mesh = par.device_mesh(4)
    ids = sorted(d.id for d in mesh.devices.flat)
    rec.require("four", "mesh spans four distinct cards", len(set(ids)) == 4,
                str(ids))

    def spread(a, name):
        devs = {s.device.id for s in a.addressable_shards}
        rec.require("four", f"{name} sharded over 4 cards", len(devs) == 4,
                    str(sorted(devs)))

    rng = np.random.default_rng(seed + 5)
    why = "scale-relative; same fp32 program on one card and on four"

    x = jnp.asarray(0.3 * rng.standard_normal((sz.mics, T)), jnp.float32)
    (_, csm4), first, warm = timed(
        lambda: par.parallel_csm(x, mesh, sampling_rate_hz=fs)
    )
    rec.timing("four", f"parallel_csm {tuple(x.shape)}", first, warm)
    spread(csm4, "parallel_csm")
    _, csm1 = csm_welch(x, sampling_rate_hz=fs)
    rec.check("four", "parallel_csm vs one card",
              ref.scale_relative_error(csm4, csm1), 1e-5, why)

    B, L = sz.mesh_fleet
    rirs = np.zeros((B, L), np.float32)
    rirs[:, 0] = 1.0
    rirs[:, 1:] = (
        rng.standard_normal((B, L - 1)) * np.exp(-np.arange(1, L) / 4800)
    ) * 0.1
    d4, first, warm = timed(
        lambda: par.parallel_batch_descriptors(rirs, fs, mesh)
    )
    rec.timing("four", f"parallel_batch_descriptors {sz.mesh_fleet}",
               first, warm)
    spread(d4["d50"], "parallel_batch_descriptors")
    d1 = batch_descriptors(jnp.asarray(rirs), fs)
    rec.check(
        "four", "parallel_batch_descriptors vs one card",
        max(ref.scale_relative_error(d4[k], d1[k]) for k in d1), 1e-5, why,
    )

    h = np.hanning(255) / 127.0
    xs = jnp.asarray(
        rng.standard_normal((sz.channels, T)), jnp.float32
    )
    y4, first, warm = timed(lambda: par.parallel_fir_filter(h, xs, mesh))
    rec.timing("four", f"parallel_fir_filter {tuple(xs.shape)}, 255 taps",
               first, warm)
    spread(y4, "parallel_fir_filter")
    y1 = fft_convolve(xs, jnp.asarray(h, jnp.float32))[:, : xs.shape[1]]
    rec.check("four", "parallel_fir_filter (ppermute halos) vs one card",
              ref.scale_relative_error(y4, y1), 1e-5, why)

    M, G, F = sz.mics, sz.grid_side**2, 513
    amp = np.abs(rng.standard_normal((M, G))) + 0.1
    diff = rng.standard_normal((M, G)) * 0.5
    k = np.linspace(0, np.pi * fs / 343, F)
    spectra = rng.standard_normal((F, M, 4)) + 1j * rng.standard_normal(
        (F, M, 4)
    )
    csm = np.einsum("fmk,fnk->fmn", spectra, np.conj(spectra))
    m4, first, warm = timed(
        lambda: par.parallel_das_map(amp, diff, k, csm, mesh)
    )
    rec.timing("four", f"parallel_das_map ({F} x {M} x {G})", first, warm)
    spread(m4, "parallel_das_map")
    m1 = _das_map_core(
        *(jnp.asarray(a, jnp.float32) for a in (amp, diff, k)),
        jnp.asarray(csm.real, jnp.float32),
        jnp.asarray(csm.imag, jnp.float32),
    )
    rec.check("four", "parallel_das_map vs one card",
              ref.scale_relative_error(m4, m1), 1e-5, why)

    # the public mesh= arguments
    sig = dsp.Signal(None, np.asarray(x).T, fs)
    _, c4 = sig.get_csm(mesh=mesh)
    _, c1 = sig.get_csm()
    rec.check("four", "Signal.get_csm(mesh=) vs one card",
              ref.scale_relative_error(np.asarray(c4), np.asarray(c1)),
              1e-5, why)
    # octave bands from 500 Hz: below that the fp32 recursion of a
    # 6th-order band-pass at 48 kHz is itself off the f64 result by more
    # than the sharded/one-card difference this check looks for
    fb, _, _ = dsp.filterbanks.fractional_octave_bands(
        frequency_range_hz=[500, 16000], sampling_rate_hz=fs
    )
    sig16 = dsp.Signal(None, np.asarray(xs).T, fs)
    mb4 = fb.filter_signal(sig16, FilterBankMode.Parallel, mesh=mesh)
    mb1 = fb.filter_signal(sig16, FilterBankMode.Parallel)
    rec.check(
        "four", f"FilterBank.filter_signal(mesh=), {fb.number_of_filters} "
        "bands vs one card",
        max(
            ref.scale_relative_error(
                np.asarray(a.time_data), np.asarray(b.time_data)
            )
            for a, b in zip(mb4.bands, mb1.bands)
        ),
        5e-4,
        "scale-relative; the 500 Hz band's poles lie within 1e-2 of the "
        "unit circle and the band-sharded program sums its fp32 blocks in "
        "another order (5e-5 on 4 virtual CPU devices)",
    )
    mics = bf.MicArray(
        {
            "x": rng.uniform(-0.5, 0.5, M),
            "y": rng.uniform(-0.5, 0.5, M),
            "z": np.zeros(M),
        }
    )
    side = np.linspace(-1.0, 1.0, sz.grid_side)
    grid = bf.Regular2DGrid(side, side, ["x", "y"], value3=1.0)
    src = bf.MonopoleSource(
        dsp.generators.noise(
            length_seconds=sz.array_signal_s, sampling_rate_hz=fs
        ),
        [0.2, -0.1, 1.0],
    )
    st = bf.SteeringVector(formulation=bf.SteeringVectorType.TrueLocation)
    das = bf.BeamformerDASFrequency(
        src.get_signals_on_array(mics), mics, grid, st
    )
    b4 = np.asarray(das.get_beamformer_map(2000, 3, mesh=mesh))
    b1 = np.asarray(das.get_beamformer_map(2000, 3))
    rec.check("four", "get_beamformer_map(mesh=) vs one card",
              ref.scale_relative_error(b4, b1), 1e-4, why)

    # a dsp.pipeline-fused public chain partitioned over the mesh; the
    # helper asserts its own one-card agreement
    entry._fused_pipeline_mesh_smoke(mesh, 4)
    rec.require("four", "dsp.pipeline(mesh=) fused chain vs one card", True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-device path on four GPUs",
    )
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke.py needs a GPU; JAX found {devices[0].platform}",
            file=sys.stderr,
        )
        return 2
    if args.four_cards and len(devices) < 4:
        print(f"--four-cards needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    _imports()
    import bench

    cache = bench.enable_compile_cache()
    card = bench.gpu_name_and_power_limit()
    print(card, flush=True)  # name, power limit: as nvidia-smi prints them
    print(
        f"device_kind: {devices[0].device_kind} count: {len(devices)} "
        f"compile cache: {cache} "
        f"matmul precision: {jax.config.jax_default_matmul_precision}",
        flush=True,
    )
    rec = Recorder(card.replace("\n", " / "))
    # TF32 must be kept out by the library's own precision= arguments
    # (tools/precision_audit.py), not by a global override
    rec.require(
        "phase0", "jax_default_matmul_precision unset",
        jax.config.jax_default_matmul_precision is None,
    )
    if args.four_cards:
        phases = [("four", lambda: four_cards(FULL, args.seed, rec))]
    else:
        phases = [
            (name, lambda fn=fn: fn(FULL, args.seed, rec))
            for name, fn in (
                ("phase1", phase1),
                ("phase2", phase2),
                ("phase3", phase3),
                ("phase4", phase4),
                ("phase5", phase5),
                ("timings", timings),
            )
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception:
            traceback.print_exc()
            rec.failures.append(f"{name}: raised")
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    if rec.failures:
        print("FAILED: " + "; ".join(rec.failures), file=sys.stderr)
        return 1
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
