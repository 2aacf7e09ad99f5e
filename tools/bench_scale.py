"""Fleet-scale throughput benchmarks.

At interactive sizes the fixed per-program launch dominates; this suite
measures every config at fleet scale (≥256 signals / full-batch
descriptor and beamforming sweeps), reporting aggregate throughput and
XLA's cost analysis via `tools/profiler.profile_program`.

Run on a GPU:  python tools/bench_scale.py [--json-out PATH]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profiler import _load, profile_program  # noqa: E402

EXAMPLE = "/root/reference/example_data"


def scale_config1(batch=256):
    """256 simultaneous deconvolution+window measurements."""
    import jax.numpy as jnp

    x, fs = _load(f"{EXAMPLE}/chirp.wav")
    T = int(x.shape[-1])
    P = 1 << (T - 1).bit_length()
    rng = np.random.default_rng(0)
    xb = jnp.asarray(
        (np.asarray(x[0])[None, :] *
         rng.uniform(0.5, 1.0, (batch, 1))).astype(np.float32)
    )
    exc = jnp.fft.rfft(x[0], n=P)
    reg = jnp.full(P // 2 + 1, 1e-3, jnp.float32)

    def run(xb, exc, reg):
        X = jnp.fft.rfft(xb, n=P, axis=-1)
        H = jnp.conj(exc) / (jnp.abs(exc) ** 2 + reg)
        ir = jnp.fft.irfft(X * H, n=P, axis=-1)[..., :T]
        n = jnp.arange(T)
        w = 0.5 - 0.5 * jnp.cos(2 * jnp.pi * n / T)
        return ir * w

    audio_s = batch * T / fs
    return run, (xb, exc, reg), f"scale1: {batch}x deconvolve+window", audio_s


def scale_config2(batch=256):
    """256 simultaneous STFT+ISTFT+Welch+CSM chains (pairs for the CSM)."""
    import jax
    import jax.numpy as jnp

    from dsptoolbox_jax.ops.framing import reconstruct_framed_signal
    from dsptoolbox_jax.ops.spectral import csm_welch, stft, welch
    from dsptoolbox_jax.ops.windows import get_window
    from dsptoolbox_jax.standard.enums import Window

    x, fs = _load(f"{EXAMPLE}/speech.flac")
    T = int(x.shape[-1])
    wl = 1024
    win = get_window(Window.Hann, wl, symmetric=False)
    rng = np.random.default_rng(0)
    xb = jnp.asarray(
        (np.asarray(x[0])[None, :] *
         rng.uniform(0.5, 1.0, (batch, 1))).astype(np.float32)
    )

    def one(xi):  # xi (T,)
        _, _, S = stft(
            xi[None], sampling_rate_hz=fs, window_length_samples=wl,
            overlap_percent=50.0,
        )
        frames = jnp.fft.irfft(S, n=wl, axis=-1)
        y = reconstruct_framed_signal(
            frames, wl // 2, win, original_signal_length=T
        )
        psd = welch(
            xi[None], None, sampling_rate_hz=fs, window_length_samples=wl
        )
        x2 = jnp.concatenate([xi[None], y[..., :T][0][None]], axis=0)
        _, C = csm_welch(x2, sampling_rate_hz=fs, window_length_samples=wl)
        return y, psd, C

    def run(xb):
        return jax.vmap(one)(xb)

    audio_s = batch * T / fs
    return run, (xb,), f"scale2: {batch}x stft+istft+welch+csm", audio_s


def scale_config3(channels=64):
    """Fleet-scale filter-bank filtering: a 22-band fractional-octave-style
    blocked-IIR bank over a 64-channel, 15 s signal in ONE program —
    config 3's dominant kernel once launches amortize (the LR tree and
    resampler are one rfft/irfft pair each, covered by scale1/2's FFT
    accounting)."""
    import jax.numpy as jnp
    from scipy.signal import butter

    from dsptoolbox_jax.ops.iir_block import (
        sosfilt_bank_apply,
        sosfilt_bank_operators,
    )

    x, fs = _load(f"{EXAMPLE}/fuer_elise.wav")
    T = int(x.shape[-1])
    rng = np.random.default_rng(0)
    xb = jnp.asarray(
        (np.asarray(x[0])[None, :] *
         rng.uniform(0.5, 1.0, (channels, 1))).astype(np.float32)
    )
    edges = 1000.0 * (2.0 ** (np.arange(23) / 3.0 - 10.0 / 3.0))
    sos_bank = np.stack([
        butter(4, [lo, min(hi, 0.499 * fs)], btype="bandpass", fs=fs,
               output="sos")
        for lo, hi in zip(edges[:-1], edges[1:])
    ])
    ops = sosfilt_bank_operators(sos_bank, T)
    ops = {
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for k, v in ops.items()
    }

    def run(xb, **ops_):
        return sosfilt_bank_apply(ops_, xb)

    audio_s = channels * T / fs

    def runner(xb):
        return run(xb, **ops)

    return (
        runner, (xb,),
        f"scale3: 22-band blocked-IIR bank x {channels} ch x {T} samples",
        audio_s,
    )


def scale_config4(n_rirs=16384):
    """Full-batch descriptor sweep."""
    import jax.numpy as jnp

    from dsptoolbox_jax.room_acoustics import batch_descriptors

    fs = 16000
    T = fs // 2
    rng = np.random.default_rng(0)
    t = np.arange(T) / fs
    decays = rng.uniform(15.0, 40.0, n_rirs)
    rirs = (
        rng.standard_normal((n_rirs, T)) * np.exp(-decays[:, None] * t)
        + 1e-3 * rng.standard_normal((n_rirs, T))
    ).astype(np.float32)
    rirs[:, 0] = 1.0

    def run(r):
        return batch_descriptors(r, fs)

    return (
        run, (jnp.asarray(rirs),),
        f"scale4: {n_rirs}-RIR descriptor battery", None,
    )


def scale_config5(n_bins=513):
    """Full-spectrum DAS sweep: every rfft bin, 64 mics, 900 points."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n_mics, n_grid = 64, 900
    C = rng.standard_normal((n_bins, n_mics, n_mics)) + 1j * (
        rng.standard_normal((n_bins, n_mics, n_mics))
    )
    C = (C + np.conj(np.swapaxes(C, -1, -2))) / 2
    h = rng.standard_normal((n_bins, n_grid, n_mics)) + 1j * (
        rng.standard_normal((n_bins, n_grid, n_mics))
    )
    Cre = jnp.asarray(np.real(C).astype(np.float32))
    Cim = jnp.asarray(np.imag(C).astype(np.float32))
    hre = jnp.asarray(np.real(h).astype(np.float32))
    him = jnp.asarray(np.imag(h).astype(np.float32))

    def run(cre, cim, hre_, him_):
        # production packed-real block form (beamforming._das_map_core):
        # one real contraction over 2M instead of a complex one over M
        hp = jnp.concatenate([hre_, him_], axis=-1)
        B = jnp.concatenate(
            [
                jnp.concatenate([cre, -cim], axis=-1),
                jnp.concatenate([cim, cre], axis=-1),
            ],
            axis=-2,
        )
        t = jnp.einsum("fgk,fkl->fgl", hp, B)
        return jnp.einsum("fgl,fgl->gf", hp, t)

    return (
        run, (Cre, Cim, hre, him),
        f"scale5: DAS full-spectrum {n_bins} bins x 64 mics x 900 pts",
        None,
    )


def scale_config6(n_rirs=256):
    """Batched image-source generation: 256 RIRs in one program."""
    import jax.numpy as jnp

    import dsptoolbox_jax as dsp
    from dsptoolbox_jax.room_acoustics import batch
    from dsptoolbox_jax.room_acoustics._backend import (
        _U_VECTORS,
        _ism_device_program_batched,
    )

    room = dsp.room_acoustics.ShoeboxRoom([6.0, 5.0, 3.0], t60_s=0.5)
    rng = np.random.default_rng(0)
    s = rng.uniform([0.3, 0.3, 0.3], [5.7, 4.7, 2.7], (n_rirs, 3))
    r = rng.uniform([0.3, 0.3, 0.3], [5.7, 4.7, 2.7], (n_rirs, 3))
    sr = 16000
    # same prep as batch_synthetic_rirs, but expose the raw program so
    # the profiler can cost-analyze exactly one compiled executable
    room_dim = np.asarray(room.dimensions_m, np.float64)
    beta = np.sqrt(1 - np.asarray(room.absorption_coefficient))
    beta_1 = beta_2 = np.ones(3) * beta
    t_max = room.t60_s * 1.1
    l_max = 343 * t_max / 2 / room_dim
    LIMIT = min(int(np.ceil(np.sqrt(l_max @ l_max))), 20)
    gen_length = int(t_max * 5 * sr)
    a64 = (1 - 2 * _U_VECTORS)[None] * s[:, None, :] - r[:, None, :]
    b64 = 2 * room_dim
    a_hi = a64.astype(np.float32)
    b_hi = b64.astype(np.float32)
    program, M = _ism_device_program_batched(LIMIT, sr, gen_length)
    args = (
        jnp.asarray(a_hi),
        jnp.asarray((a64 - a_hi).astype(np.float32)),
        jnp.asarray(b_hi),
        jnp.asarray((b64 - b_hi).astype(np.float32)),
        jnp.asarray(beta_1, np.float32),
        jnp.asarray(beta_2, np.float32),
    )
    return (
        program, args,
        f"scale6: {n_rirs}-RIR batched ISM (order {LIMIT}, "
        f"{M} lattice cells x 8 images)",
        None,
    )


def main():
    out_path = None
    if "--json-out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--json-out") + 1]
    results = []
    for build, extra in (
        (scale_config1, lambda r, a: {"audio_s_per_s": round(a / r["seconds_per_iter"], 1)}),
        (scale_config2, lambda r, a: {"audio_s_per_s": round(a / r["seconds_per_iter"], 1)}),
        (scale_config3, lambda r, a: {"audio_s_per_s": round(a / r["seconds_per_iter"], 1)}),
        (scale_config4, lambda r, a: {"rirs_per_s": round(16384 / r["seconds_per_iter"], 0)}),
        (scale_config5, lambda r, a: {"grid_pts_bins_per_s": round(900 * 513 / r["seconds_per_iter"], 0)}),
        (scale_config6, lambda r, a: {"rirs_per_s": round(256 / r["seconds_per_iter"], 1)}),
    ):
        fn, args, label, audio_s = build()
        rep = profile_program(fn, args, label, trace_dir=None, n_iters=5)
        rep.update(extra(rep, audio_s))
        results.append(rep)
        print(json.dumps(rep), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
