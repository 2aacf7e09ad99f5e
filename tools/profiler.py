"""Profiling harness: per-config kernel breakdown + XLA cost accounting.

SURVEY.md §5 asks for a real tracing subsystem ("jax.profiler traces +
named scopes are nearly free; add them"). Named scopes live on the hot
kernels (`ops/spectral.py`, `ops/fft_conv.py`, `ops/iir_block.py`); this
harness closes the loop: it jits the hot program of each BASELINE config,
captures a `jax.profiler` trace, parses the Chrome-trace JSON the device
runtime emits, and reports

  * the top device kernels by total self time,
  * XLA's own cost analysis (flops / bytes accessed) for the program and
    the FLOP rate it implies at the measured wall time.

Run:  python tools/profiler.py [--config N] [--json] [--trace-dir DIR]

Reference analog: none (the reference has no profiler — SURVEY.md §5);
this is the device observability layer.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXAMPLE = "/root/reference/example_data"


def _cost_analysis(compiled) -> dict:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return dict(ca or {})


def parse_trace(trace_dir: str, top_n: int = 10) -> list[dict]:
    """Aggregate device-kernel self times from the newest trace.json.gz."""
    paths = sorted(
        glob.glob(
            os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz")
        )
    )
    if not paths:
        return []
    with gzip.open(paths[-1], "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    # Identify device process ids: their names mention the device.
    pid_names = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev["pid"]] = ev.get("args", {}).get("name", "")
    device_pids = {
        pid
        for pid, name in pid_names.items()
        if any(k in name for k in ("GPU", "Device", "/device:"))
    }
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if device_pids and ev.get("pid") not in device_pids:
            continue
        name = ev.get("name", "?")
        dur = float(ev.get("dur", 0.0))  # microseconds
        totals[name] = totals.get(name, 0.0) + dur
        counts[name] = counts.get(name, 0) + 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top_n]
    return [
        {"kernel": name, "total_us": round(us, 1), "calls": counts[name]}
        for name, us in ranked
    ]


def profile_program(fn, args, label: str, trace_dir: str | None = None,
                    n_iters: int = 10) -> dict:
    """Compile, time, cost-analyse and trace one jitted program."""
    import jax

    jitted = jax.jit(fn)
    lowered = jitted.lower(*args)
    compiled = lowered.compile()
    ca = _cost_analysis(compiled)
    flops = float(ca.get("flops", 0.0))
    bytes_accessed = float(ca.get("bytes accessed", 0.0))

    jax.block_until_ready(jitted(*args))  # warm-up
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = jitted(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n_iters)

    report = {
        "label": label,
        "seconds_per_iter": round(best, 6),
        "xla_flops": flops,
        "xla_bytes_accessed": bytes_accessed,
        "achieved_tflops": round(flops / best / 1e12, 4),
    }
    if trace_dir is not None:
        import jax.profiler

        os.makedirs(trace_dir, exist_ok=True)
        with jax.profiler.trace(trace_dir):
            for _ in range(3):
                out = jitted(*args)
            jax.block_until_ready(out)
        report["top_kernels"] = parse_trace(trace_dir)
    return report


# ---------------------------------------------------------------------------
# The five BASELINE configs, reduced to their jitted hot programs.
# ---------------------------------------------------------------------------

def _load(path):
    import jax.numpy as jnp

    import dsptoolbox_jax as dsp

    s = dsp.Signal(path)
    return jnp.asarray(np.asarray(s.time_data).T.astype(np.float32)), \
        s.sampling_rate_hz


def prog_config1():
    import jax.numpy as jnp

    x, fs = _load(f"{EXAMPLE}/chirp.wav")
    T = x.shape[-1]
    P = 1 << (T - 1).bit_length()
    exc = jnp.fft.rfft(x[0], n=P)
    reg = jnp.full(P // 2 + 1, 1e-3, jnp.float32)

    def run(x, exc, reg):
        X = jnp.fft.rfft(x, n=P, axis=-1)
        H = jnp.conj(exc) / (jnp.abs(exc) ** 2 + reg)
        ir = jnp.fft.irfft(X * H, n=P, axis=-1)[..., :T]
        n = jnp.arange(T)
        w = 0.5 - 0.5 * jnp.cos(2 * jnp.pi * n / T)
        return ir * w

    return run, (x, exc, reg), "config1: deconvolve+window"


def prog_config2():
    import jax.numpy as jnp

    from dsptoolbox_jax.ops.framing import reconstruct_framed_signal
    from dsptoolbox_jax.ops.spectral import csm_welch, stft, welch
    from dsptoolbox_jax.ops.windows import get_window
    from dsptoolbox_jax.standard.enums import Window

    x, fs = _load(f"{EXAMPLE}/speech.flac")
    T = x.shape[-1]
    wl = 1024
    win = get_window(Window.Hann, wl, symmetric=False)

    def run(x):
        _, _, S = stft(
            x, sampling_rate_hz=fs, window_length_samples=wl,
            overlap_percent=50.0,
        )
        frames = jnp.fft.irfft(S, n=wl, axis=-1)
        y = reconstruct_framed_signal(
            frames, wl // 2, win, original_signal_length=T
        )
        psd = welch(x, None, sampling_rate_hz=fs, window_length_samples=wl)
        x2 = jnp.concatenate([x, y[..., :T].reshape(x.shape)], axis=0)
        _, C = csm_welch(x2, sampling_rate_hz=fs, window_length_samples=wl)
        return y, psd, C

    return run, (x,), "config2: stft+istft+welch+csm"


def prog_config3():
    from scipy.signal import butter

    from dsptoolbox_jax.ops.iir_block import (
        sosfilt_bank_apply,
        sosfilt_bank_operators,
    )

    x, fs = _load(f"{EXAMPLE}/fuer_elise.wav")
    T = x.shape[-1]
    xo = [250.0, 1000.0, 4000.0]
    sos_bank = [
        butter(4, xo[0], btype="lowpass", fs=fs, output="sos"),
        butter(4, [xo[0], xo[1]], btype="bandpass", fs=fs, output="sos"),
        butter(4, [xo[1], xo[2]], btype="bandpass", fs=fs, output="sos"),
        butter(4, xo[2], btype="highpass", fs=fs, output="sos"),
    ]
    max_s = max(s.shape[0] for s in sos_bank)
    ident = np.array([1.0, 0, 0, 1.0, 0, 0])
    padded = np.stack([
        np.vstack([s] + [ident[None]] * (max_s - s.shape[0]))
        for s in sos_bank
    ])
    ops = sosfilt_bank_operators(padded, T)

    def run(x):
        return sosfilt_bank_apply(ops, x)

    return run, (x,), "config3: 4-band blocked-IIR bank"


def prog_config4():
    from dsptoolbox_jax.room_acoustics import batch_descriptors

    fs = 16000
    T = fs // 2
    rng = np.random.default_rng(0)
    t = np.arange(T) / fs
    decays = rng.uniform(3.0, 12.0, 1000)
    rirs = (
        rng.standard_normal((1000, T)) * np.exp(-decays[:, None] * t)
    ).astype(np.float32)
    rirs[:, 0] = 1.0

    def run(r):
        return batch_descriptors(r, fs)

    import jax.numpy as jnp

    return run, (jnp.asarray(rirs),), "config4: RIR descriptor battery"


def prog_config5():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n_mics, n_grid, n_bins = 64, 900, 15
    C = rng.standard_normal((n_bins, n_mics, n_mics)) + 1j * (
        rng.standard_normal((n_bins, n_mics, n_mics))
    )
    C = (C + np.conj(np.swapaxes(C, -1, -2))) / 2
    h = rng.standard_normal((n_bins, n_grid, n_mics)) + 1j * (
        rng.standard_normal((n_bins, n_grid, n_mics))
    )
    # real/imag parts, combined in-program
    Cre = jnp.asarray(np.real(C).astype(np.float32))
    Cim = jnp.asarray(np.imag(C).astype(np.float32))
    hre = jnp.asarray(np.real(h).astype(np.float32))
    him = jnp.asarray(np.imag(h).astype(np.float32))

    def run(cre, cim, hre_, him_):
        Cc = cre + 1j * cim
        hc = hre_ + 1j * him_
        return jnp.real(
            jnp.einsum("fgm,fmn,fgn->gf", jnp.conj(hc), Cc, hc)
        )

    return run, (Cre, Cim, hre, him), "config5: DAS quadratic form"


CONFIGS = {
    1: prog_config1,
    2: prog_config2,
    3: prog_config3,
    4: prog_config4,
    5: prog_config5,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=None)
    ap.add_argument("--trace-dir", default="/tmp/dsptb_profile")
    ap.add_argument("--no-trace", action="store_true")
    # output is always one JSON line per config; kept for CLI compat
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    which = [args.config] if args.config else sorted(CONFIGS)
    for n in which:
        fn, prog_args, label = CONFIGS[n]()
        tdir = None if args.no_trace else os.path.join(
            args.trace_dir, f"config{n}"
        )
        rep = profile_program(fn, prog_args, label, trace_dir=tdir)
        print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
