"""Benchmark suite: all five BASELINE.json configs on one GPU.

Prints one JSON line per config with throughput and (where available) the
pure scipy/numpy reference-equivalent timing measured on the host CPU.
`bench.py` remains the single-line headline benchmark.

Run:  python tools/bench_suite.py [--ref]   (--ref also times the scipy path)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXAMPLE = "/root/reference/example_data"


def _sync(x):
    """Wait for every device value in ``x``: pending deferred programs are
    forced first (device-side, no transfer), then `jax.block_until_ready`
    on the concrete leaves."""
    import jax

    from dsptoolbox_jax import compute_all
    from dsptoolbox_jax.classes.lazy_array import LazyHostArray
    from dsptoolbox_jax._defer import DeferredArray

    leaves = jax.tree_util.tree_leaves(x)
    compute_all(*leaves)
    ready = []
    for leaf in leaves:
        if isinstance(leaf, LazyHostArray):
            leaf = leaf.device_real
        if isinstance(leaf, DeferredArray):
            leaf = leaf.force()
        if isinstance(leaf, jax.Array):
            ready.append(leaf)
    jax.block_until_ready(ready)


def timeit(fn, n_iters=10, warmup=2, repeats=3):
    """Best-of-`repeats` mean over `n_iters` calls; each batch ends in
    `_sync` on the last output."""
    for _ in range(warmup):
        out = fn()
    _sync(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = fn()
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / n_iters)
    return best


def config1_deconvolution():
    """chirp.wav -> rir.wav: regularized spectral deconvolution + windowed
    IR + RT60 (the canonical measurement chain, E2E through the library)."""
    import dsptoolbox_jax as dsp

    chirp = dsp.Signal(f"{EXAMPLE}/chirp.wav")
    rec = dsp.Signal(f"{EXAMPLE}/chirp.wav")

    def chain(r, c):
        ir = dsp.transfer_functions.spectral_deconvolve(
            r, c, padding=False, keep_original_length=True
        )
        ir_w, _ = dsp.transfer_functions.window_ir(
            ir, 2**14, return_device=True
        )
        return ir_w

    def run():
        return chain(rec, chirp).time_data_jax

    dt = timeit(run, n_iters=50)
    fused = dsp.pipeline(chain)

    def run_fused():
        return fused(rec, chirp).time_data_jax

    dt_fused = timeit(run_fused, n_iters=50)
    audio_s = chirp.length_samples / chirp.sampling_rate_hz
    return {
        "config": 1,
        "metric": "spectral_deconvolve+window_ir E2E",
        "value": round(audio_s / dt_fused, 1),
        "unit": "x realtime per card (dsp.pipeline fused, library E2E)",
        "seconds_per_iter": round(dt_fused, 4),
        "unfused_x_realtime": round(audio_s / dt, 1),
        "unfused_seconds_per_iter": round(dt, 4),
    }


def config2_stft_welch_csm():
    """speech.flac: STFT -> ISTFT roundtrip + Welch PSD + CSM, driven
    entirely through the PUBLIC class layer (`Signal.get_spectrogram` /
    `transforms.istft` / `Signal.get_spectrum` / `Signal.get_csm` +
    `append_signals`) — the same call sequence as the reference oracle
    `r2()` below."""
    import jax

    import dsptoolbox_jax as dsp

    s = dsp.Signal(f"{EXAMPLE}/speech.flac")
    s.set_spectrogram_parameters(window_length_samples=1024)
    fs = s.sampling_rate_hz
    T = s.length_samples

    def _chain(sig):
        t, f, S = sig.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=sig)
        f2, sp = sig.get_spectrum(force_computation=True)
        two = dsp.append_signals([sig, y])
        f3, C = two.get_csm(force_computation=True)
        return y, sp, C

    # distinct input buffers derived ON device (execution-memoization
    # guard; measured to be within launch noise of the fixed-buffer run,
    # but removes the question)
    _scale = jax.jit(lambda a, c: a * c)
    _rot = []
    for i in range(2 + 3 * 50 + 8):
        t2 = s.copy_with_new_time_data(
            _scale(s.time_data_jax, 1.0 + 1e-6 * i)
        )
        t2.set_spectrogram_parameters(window_length_samples=1024)
        _rot.append(t2)
    _cnt = {"i": -1}

    def _next_sig():
        _cnt["i"] += 1
        return _rot[_cnt["i"] % len(_rot)]

    fused = dsp.pipeline(_chain)

    def run_fused():
        y, sp, C = fused(_next_sig())
        return y.time_data_jax, sp, C

    def run_device():
        # device-resident returns (public `return_device=True` API):
        # the chain never fetches to the host
        t, f, S = s.get_spectrogram(
            force_computation=True, return_device=True
        )
        y = dsp.transforms.istft(S, original_signal=s)
        f2, sp = s.get_spectrum(
            force_computation=True, return_device=True
        )
        two = dsp.append_signals([s, y])
        f3, C = two.get_csm(force_computation=True, return_device=True)
        return y.time_data_jax, sp, C.real

    def run_default():
        # reference-identical DEFAULT call sequence. Getters record
        # deferred device programs (fp32 mode); compute_all forces every
        # result to a concrete device value each iteration (ONE composite
        # launch — nothing is skipped, nothing fetches to the host).
        # This is what drop-in code pays per iteration.
        y, sp, C = _chain(_next_sig())
        dsp.compute_all(y, sp, C)
        return y.time_data_jax, sp, C

    def run_default_materialized():
        # same chain, but every result lands fully on the host each
        # iteration (packed single-fetch per array)
        from dsptoolbox_jax.classes.lazy_array import materialize_all

        y, sp, C = _chain(_next_sig())
        sp_np, c_np = materialize_all(sp, C)
        return float(np.asarray(y.time_data_jax[0, 0])), sp_np, c_np

    dt_fused = timeit(run_fused, n_iters=50)
    dt = timeit(run_device, n_iters=50)
    dt_default = timeit(run_default, n_iters=50)
    dt_host = timeit(run_default_materialized, n_iters=5)
    audio_s = T / fs
    return {
        "config": 2,
        "metric": "STFT+ISTFT+Welch+CSM (public class API)",
        "value": round(audio_s / dt_fused, 1),
        "unit": "x realtime per card (dsp.pipeline fused public chain)",
        "seconds_per_iter": round(dt_fused, 5),
        "device_resident_x_realtime": round(audio_s / dt, 1),
        "device_resident_seconds_per_iter": round(dt, 5),
        "default_lazy_x_realtime": round(audio_s / dt_default, 1),
        "default_lazy_seconds_per_iter": round(dt_default, 5),
        "host_materialized_x_realtime": round(audio_s / dt_host, 1),
        "host_materialized_seconds_per_iter": round(dt_host, 5),
    }


def config3_filterbanks():
    """fuer_elise.wav: LR crossover + gammatone filtering + polyphase
    resampling, batched over channels."""
    import jax.numpy as jnp

    import dsptoolbox_jax as dsp
    from dsptoolbox_jax.standard.enums import FilterBankMode

    s = dsp.Signal(f"{EXAMPLE}/fuer_elise.wav")
    fs = s.sampling_rate_hz
    fb = dsp.filterbanks.linkwitz_riley_crossovers(
        [250.0, 1000.0, 4000.0], [4, 4, 4], sampling_rate_hz=fs
    )
    gt = dsp.filterbanks.auditory_filters_gammatone(
        [500.0, 4000.0], sampling_rate_hz=fs
    )

    def _chain3(sig):
        mb = fb.filter_signal(sig, FilterBankMode.Parallel)
        gt_bands = gt.filter_signal(sig, FilterBankMode.Parallel)
        r = dsp.resample(sig, fs // 3)
        return mb, gt_bands, r

    def run():
        mb, gt_bands, r = _chain3(s)
        return (
            mb.bands[0].time_data_jax,
            gt_bands.bands[0].time_data_jax,
            r.time_data_jax,
        )

    fused = dsp.pipeline(_chain3)

    def run_fused():
        mb, gt_bands, r = fused(s)
        return (
            mb.bands[0].time_data_jax,
            gt_bands.bands[0].time_data_jax,
            r.time_data_jax,
        )

    dt_fused = timeit(run_fused, n_iters=50)
    dt = timeit(run, n_iters=50)
    audio_s = s.length_samples / fs
    return {
        "config": 3,
        "metric": "LR4 3-way + gammatone + resample E2E",
        "value": round(audio_s / dt_fused, 1),
        "unit": "x realtime per card (dsp.pipeline fused, library E2E)",
        "seconds_per_iter": round(dt_fused, 4),
        "unfused_x_realtime": round(audio_s / dt, 1),
        "unfused_seconds_per_iter": round(dt, 4),
    }


def config4_rir_battery(n_rirs=1000):
    """rir.wav-style battery: D50/C80/center-time/T20 over a batch of
    synthetic RIRs (batched device kernel)."""
    import jax.numpy as jnp

    from dsptoolbox_jax.room_acoustics import batch_descriptors

    fs = 16000
    T = fs // 2
    rng = np.random.default_rng(0)
    t = np.arange(T) / fs
    # decay fast enough to reach a -60 dB noise floor inside the window:
    # the same family the reference-side oracle (`r4`) times, so the
    # reference-vs-repo ratio is apples-to-apples (the reference's
    # noise-floor trim NaN-crashes on floorless synthetic decays)
    decays = rng.uniform(15.0, 40.0, n_rirs)
    rirs = (
        rng.standard_normal((n_rirs, T)) * np.exp(-decays[:, None] * t)
        + 1e-3 * rng.standard_normal((n_rirs, T))
    ).astype(np.float32)
    rirs[:, 0] = 1.0
    rirs_j = jnp.asarray(rirs)

    def run():
        return batch_descriptors(rirs_j, fs)

    dt = timeit(run)
    return {
        "config": 4,
        "metric": "batched RIR descriptors (D50+C80+Ts+T20)",
        "value": round(n_rirs / dt, 0),
        "unit": "RIRs/s per card",
        "seconds_per_iter": round(dt, 5),
    }


def config5_beamforming():
    """array.xml: DAS + MVDR beamforming map over a grid sweep (E2E)."""
    import dsptoolbox_jax as dsp
    from dsptoolbox_jax import beamforming as bf

    ma = bf.MicArray.from_xml(f"{EXAMPLE}/array.xml")
    xval = np.arange(-0.3, 0.3, 0.02)
    yval = np.arange(-0.3, 0.3, 0.02)
    grid = bf.Regular2DGrid(xval, yval, ["x", "y"], value3=0.5)
    src = bf.MonopoleSource(
        dsp.generators.noise(
            length_seconds=0.5,
            sampling_rate_hz=16000,
        ),
        [0.1, -0.1, 0.5],
    )
    sig = src.get_signals_on_array(ma)
    st = bf.SteeringVector(formulation=bf.SteeringVectorType.TrueLocation)

    das = bf.BeamformerDASFrequency(sig, ma, grid, st)

    def run_das():
        # lazy map return (fp32 default): the map stays on device; the
        # timing sync materializes one map per BATCH, so this is the
        # batch/tracking-loop rate (per-map full materialization is the
        # `materialized` line)
        return das.get_beamformer_map(
            2000, 3, remove_csm_diagonal=True
        )

    dt_das = timeit(run_das, n_iters=10, warmup=2, repeats=3)

    def run_das_host():
        m = das.get_beamformer_map(2000, 3, remove_csm_diagonal=True)
        return np.asarray(m)

    dt_das_host = timeit(run_das_host, n_iters=2, warmup=1, repeats=2)

    mvdr = bf.BeamformerMVDR(sig, ma, grid, st)

    def run_mvdr():
        return mvdr.get_beamformer_map(2000, 3)

    dt_mvdr = timeit(run_mvdr, n_iters=10, warmup=2, repeats=3)
    n_points = len(xval) * len(yval)
    return {
        "config": 5,
        "metric": "DAS + MVDR map (1/3-octave @2kHz, "
        f"{n_points} grid points, {ma.number_of_points} mics)",
        "value": round(n_points / dt_das, 0),
        "unit": "DAS grid-points/s per card (device-resident lazy map)",
        "das_seconds_per_map": round(dt_das, 4),
        "das_materialized_seconds_per_map": round(dt_das_host, 4),
        "mvdr_seconds_per_map": round(dt_mvdr, 4),
    }


def _install_reference():
    """Make the reference package importable without an audio stack (same
    approach as tests/conftest.py, but without touching jax config)."""
    import types

    if "soundfile" not in sys.modules:
        sf = types.ModuleType("soundfile")

        def read(path, **kw):
            import dsptoolbox_jax.io as dtio

            data, fs = dtio.read_audio(path)
            return data, fs

        sf.read = read
        sf.write = lambda *a, **k: None
        sys.modules["soundfile"] = sf
    if "sounddevice" not in sys.modules:
        sd = types.ModuleType("sounddevice")
        sd.default = types.SimpleNamespace(
            device=None, samplerate=None, blocksize=None, latency=None
        )
        sd.DeviceList = list
        sd.query_devices = lambda *a, **k: []
        sd.playrec = sd.play = sd.rec = lambda *a, **k: None
        sd.sleep = lambda ms: None
        sd.CallbackStop = type("CallbackStop", (Exception,), {})
        sd.OutputStream = object
        sys.modules["sounddevice"] = sd
    if "/root/reference" not in sys.path:
        sys.path.insert(0, "/root/reference")
    import dsptoolbox as ref

    return ref


def _time_host(fn, n_iters=3, warmup=1):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        fn()
    return (time.perf_counter() - t0) / n_iters


def reference_oracles():
    """Time the reference package (pure numpy/scipy, f64) on the host CPU
    for each config; prints one JSON line per config."""
    ref = _install_reference()
    results = []

    def _emit(r):
        # print as we go: a crash in a later config must not lose the
        # earlier measurements
        print(json.dumps(r), flush=True)
        results.append(r)

    # config 1
    chirp = ref.Signal(f"{EXAMPLE}/chirp.wav")
    rec = ref.Signal(f"{EXAMPLE}/chirp.wav")

    def r1():
        ir = ref.transfer_functions.spectral_deconvolve(
            rec, chirp, padding=False, keep_original_length=True
        )
        return ref.transfer_functions.window_ir(ir, 2**14)

    dt = _time_host(r1)
    audio_s = chirp.time_data.shape[0] / chirp.sampling_rate_hz
    _emit({
        "config": 1, "reference_seconds_per_iter": round(dt, 4),
        "reference_x_realtime": round(audio_s / dt, 1),
    })

    # config 2
    s = ref.Signal(f"{EXAMPLE}/speech.flac")
    s.set_spectrogram_parameters(window_length_samples=1024)

    def r2():
        t, f, S = s.get_spectrogram()
        y = ref.transforms.istft(S, original_signal=s)
        f2, sp = s.get_spectrum(force_computation=True)
        two = ref.append_signals([s, y])
        return two.get_csm(force_computation=True)

    dt = _time_host(r2)
    audio_s = s.time_data.shape[0] / s.sampling_rate_hz
    _emit({
        "config": 2, "reference_seconds_per_iter": round(dt, 5),
        "reference_x_realtime": round(audio_s / dt, 1),
    })

    # config 3
    s3 = ref.Signal(f"{EXAMPLE}/fuer_elise.wav")
    fs3 = s3.sampling_rate_hz
    fb = ref.filterbanks.linkwitz_riley_crossovers(
        [250.0, 1000.0, 4000.0], [4, 4, 4], sampling_rate_hz=fs3
    )
    gt = ref.filterbanks.auditory_filters_gammatone(
        [500.0, 4000.0], sampling_rate_hz=fs3
    )
    from dsptoolbox.standard.enums import FilterBankMode as RefMode

    def r3():
        mb = fb.filter_signal(s3, RefMode.Parallel)
        gtb = gt.filter_signal(s3, RefMode.Parallel)
        return ref.resample(s3, fs3 // 3)

    dt = _time_host(r3)
    audio_s = s3.time_data.shape[0] / fs3
    _emit({
        "config": 3, "reference_seconds_per_iter": round(dt, 4),
        "reference_x_realtime": round(audio_s / dt, 1),
    })

    # config 4 (time a 50-RIR slice of the 1000-RIR battery; same RIR
    # family as `config4_rir_battery` — fast decay + noise floor, which
    # the reference's trim logic requires)
    fs4 = 16000
    T = fs4 // 2
    rng = np.random.default_rng(0)
    t4 = np.arange(T) / fs4
    n_slice = 50
    decays = rng.uniform(15.0, 40.0, n_slice)
    rirs = rng.standard_normal((n_slice, T)) * np.exp(
        -decays[:, None] * t4
    ) + 1e-3 * rng.standard_normal((n_slice, T))
    rirs[:, 0] = 1.0
    from dsptoolbox.room_acoustics.enums import RoomAcousticsDescriptor

    def r4():
        out = []
        for n in range(n_slice):
            rir_sig = ref.ImpulseResponse(None, rirs[n], fs4)
            out.append([
                ref.room_acoustics.descriptors(
                    rir_sig, RoomAcousticsDescriptor.D50
                ),
                ref.room_acoustics.descriptors(
                    rir_sig, RoomAcousticsDescriptor.C80
                ),
                ref.room_acoustics.descriptors(
                    rir_sig, RoomAcousticsDescriptor.CenterTime
                ),
            ])
        return out

    dt = _time_host(r4, n_iters=1, warmup=1)
    _emit({
        "config": 4, "reference_rirs_per_s": round(n_slice / dt, 1),
    })

    # config 5 (the reference MicArray takes a positions dict, not XML —
    # reuse our XML parser for identical coordinates)
    from dsptoolbox_jax.beamforming import MicArray as _MicArray

    _ma = _MicArray.from_xml(f"{EXAMPLE}/array.xml")
    ma = ref.beamforming.MicArray(
        {
            "x": _ma.coordinates[:, 0],
            "y": _ma.coordinates[:, 1],
            "z": _ma.coordinates[:, 2],
        }
    )
    xval = np.arange(-0.3, 0.3, 0.02)
    yval = np.arange(-0.3, 0.3, 0.02)
    grid = ref.beamforming.Regular2DGrid(
        xval, yval, ["x", "y"], value3=0.5
    )
    src = ref.beamforming.MonopoleSource(
        ref.generators.noise(
            length_seconds=0.5, sampling_rate_hz=16000
        ),
        [0.1, -0.1, 0.5],
    )
    sig5 = src.get_signals_on_array(ma)
    st = ref.beamforming.SteeringVector(
        formulation=ref.beamforming.SteeringVectorType.TrueLocation
    )
    das = ref.beamforming.BeamformerDASFrequency(sig5, ma, grid, st)

    def r5():
        return das.get_beamformer_map(2000, 3, remove_csm_diagonal=True)

    dt = _time_host(r5, n_iters=1, warmup=1)
    _emit({
        "config": 5,
        "reference_das_seconds_per_map": round(dt, 3),
        "reference_das_grid_points_per_s": round(
            len(xval) * len(yval) / dt, 1
        ),
    })

    return results


_CONFIG_FNS = {
    "1": lambda: config1_deconvolution(),
    "2": lambda: config2_stft_welch_csm(),
    "3": lambda: config3_filterbanks(),
    "4": lambda: config4_rir_battery(),
    "5": lambda: config5_beamforming(),
}


def main():
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if "--ref" in sys.argv:
        return reference_oracles()
    if "--config" in sys.argv:
        n = sys.argv[sys.argv.index("--config") + 1]
        r = _CONFIG_FNS[n]()
        print(json.dumps(r), flush=True)
        return [r]
    results = []
    for fn in (
        config1_deconvolution,
        config2_stft_welch_csm,
        config3_filterbanks,
        config4_rir_battery,
        config5_beamforming,
    ):
        try:
            r = fn()
        except Exception as e:  # keep the suite running
            r = {"config": fn.__name__, "error": f"{type(e).__name__}: {e}"}
        results.append(r)
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
