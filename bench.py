"""Benchmark: the BASELINE.json headline chain on one GPU.

Measures the flagship pipeline — STFT + Linkwitz-Riley/gammatone-style SOS
filter-bank filtering + regularized spectral deconvolution — as one jitted
program over a batch of signals, and reports audio-seconds processed per
wall-second.

Prints the card's name and power limit, then ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

The baseline target from BASELINE.json is >=1000x realtime per card (fp32,
48 kHz): `vs_baseline` is value / 1000. Exits non-zero when JAX finds no
GPU.

Run:  python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache where
    ``JAX_COMPILATION_CACHE_DIR`` says when it is set (JAX reads it
    itself), else at ``<checkout>/.jax_cache``. Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each visible card as nvidia-smi reports
    them (one line per card)."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def device_info() -> dict:
    d = jax.devices()
    return {
        "platform": d[0].platform,
        "kind": d[0].device_kind,
        "count": len(d),
    }


def build_pipeline(sos_bank, _unused_reg, T):
    from dsptoolbox_jax.ops.iir_block import (
        sosfilt_bank_apply,
        sosfilt_bank_operators,
    )
    from dsptoolbox_jax.ops.spectral import stft

    # band-stacked blocked-IIR operators: the whole 4-band crossover runs
    # as one batched einsum program. Cascades are padded to a common
    # section count with identity sections.
    max_s = max(s.shape[0] for s in sos_bank)
    identity = np.array([1.0, 0, 0, 1.0, 0, 0])
    padded = [
        np.vstack([s] + [identity[None]] * (max_s - s.shape[0]))
        for s in sos_bank
    ]
    bank_ops = sosfilt_bank_operators(np.stack(padded), T)

    # Deconvolution FFT length: the smaller of the next power of two and
    # the next 3*2^k (the same rule as `ops.fft_conv.next_fast_len` off
    # the CPU).
    pow2 = 1 << (T - 1).bit_length()
    three = 3
    while three < T:
        three <<= 1
    P = min(pow2, three)

    def pipeline(x, excitation_spectrum_padded, reg_padded):
        # x: (batch, T) audio at 48 kHz
        # 1) STFT analysis
        _, _, S = stft(
            x,
            sampling_rate_hz=48000,
            window_length_samples=1024,
            overlap_percent=50.0,
        )
        energy = jnp.sum(jnp.abs(S) ** 2, axis=(-1, -2))

        # 2) Filter-bank filtering (4 crossover SOS cascades, banked)
        bands = jnp.moveaxis(
            sosfilt_bank_apply(bank_ops, x), 0, 1
        )  # (batch, bands, T)

        # 3) Regularized spectral deconvolution against the excitation
        X = jnp.fft.rfft(x, n=P, axis=-1)
        H = jnp.conj(excitation_spectrum_padded) / (
            jnp.abs(excitation_spectrum_padded) ** 2 + reg_padded
        )
        ir = jnp.fft.irfft(X * H, n=P, axis=-1)[..., :T]
        return energy, bands, ir

    return pipeline, P


def crossover_bank(fs: int = 48000):
    """The headline chain's 4-band Butterworth crossover as SOS cascades."""
    from scipy.signal import butter

    crossovers = [250.0, 1000.0, 4000.0]
    return [
        butter(4, crossovers[0], btype="lowpass", fs=fs, output="sos"),
        butter(
            4, [crossovers[0], crossovers[1]], btype="bandpass", fs=fs,
            output="sos",
        ),
        butter(
            4, [crossovers[1], crossovers[2]], btype="bandpass", fs=fs,
            output="sos",
        ),
        butter(4, crossovers[2], btype="highpass", fs=fs, output="sos"),
    ]


def main():
    if jax.devices()[0].platform != "gpu":
        print("bench.py needs a GPU; JAX found none", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = gpu_name_and_power_limit()
    print(f"card: {card}", flush=True)

    fs = 48000
    batch = 16
    seconds_per_signal = 8
    T = fs * seconds_per_signal

    rng = np.random.default_rng(0)
    x = jax.device_put(
        rng.standard_normal((batch, T)).astype(np.float32)
    )

    pipeline, P = build_pipeline(crossover_bank(fs), None, T)
    exc = jnp.fft.rfft(
        jax.device_put(rng.standard_normal(T).astype(np.float32)), n=P
    )
    reg = jnp.asarray(np.full(P // 2 + 1, 1e-3, dtype=np.float32))

    # Each iteration's input is the previous iteration's (renormalized)
    # output, so consecutive steps are data-dependent; a checksum over
    # every output keeps all stages live. Timing ends in
    # `block_until_ready`.
    def step(x_in, exc_in, reg_in, chk_in):
        energy, bands, ir = pipeline(x_in, exc_in, reg_in)
        x_next = ir * jax.lax.rsqrt(jnp.mean(ir**2) + 1e-12)
        chk = (
            chk_in
            + jnp.sum(energy)
            + jnp.sum(jnp.abs(bands)) * 1e-9
            + jnp.sum(jnp.abs(ir)) * 1e-9
        )
        return x_next, chk

    step_fn = jax.jit(step)
    chk = jnp.zeros((), jnp.float32)

    # XLA's own cost model for the compiled step (flops per iteration)
    ca = step_fn.lower(x, exc, reg, chk).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    flops = float((ca or {}).get("flops", 0.0))

    # warmup / compile
    x_cur, chk = jax.block_until_ready(step_fn(x, exc, reg, chk))

    n_iters = 20
    batches = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            x_cur, chk = step_fn(x_cur, exc, reg, chk)
        jax.block_until_ready((x_cur, chk))
        batches.append((time.perf_counter() - t0) / n_iters)
    dt = float(np.median(batches))

    audio_seconds = batch * seconds_per_signal
    realtime_factor = audio_seconds / dt

    # Device-kernel time per iteration from a profiler trace of a short
    # chained batch (tracing slows the host, so this is kept apart from
    # the wall-clock number above).
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import tempfile

    from profiler import parse_trace

    trace_iters = 5
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(trace_iters):
                x_cur, chk = step_fn(x_cur, exc, reg, chk)
            jax.block_until_ready((x_cur, chk))
        kernels = parse_trace(td, top_n=10_000)
    total_us = sum(k["total_us"] for k in kernels)
    kernel_dt = total_us * 1e-6 / trace_iters if total_us > 0 else None

    print(
        json.dumps(
            {
                "metric": "stft+filterbank+deconvolution realtime factor",
                "value": realtime_factor,
                "unit": "x realtime per card (fp32, 48kHz)",
                "vs_baseline": realtime_factor / 1000.0,
                "step_ms_median": dt * 1e3,
                "achieved_tflops": flops / dt / 1e12 if flops else None,
                "device_kernel_ms_per_iter_profiled": (
                    kernel_dt * 1e3 if kernel_dt else None
                ),
                "card": card,
                "device": device_info(),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
