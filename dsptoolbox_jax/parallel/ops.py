"""Sharded hot-path pipelines (`shard_map` + device collectives).

These wrap the single-device kernels in `dsptoolbox_jax.ops` with explicit
shardings so that multi-channel workloads scale across a mesh:

- `parallel_welch`: channels split across devices; periodograms are fully
  local (embarrassingly parallel — no collectives).
- `parallel_csm`: row-parallel Gram matrix. Each device holds a channel
  block, computes its windowed spectra locally, `all_gather`s the spectra
  (one (C, K, F) tensor — far smaller than the (F, C, C) output), then
  forms its block of CSM rows with one local einsum.
- `parallel_filterbank`: SOS band battery split across devices; each
  device runs its bands' blocked IIR kernels, outputs stay band-sharded.
- `sharded_map_reduce`: generic dp fan-out for map-reduce shaped work
  (e.g. per-RIR descriptors over thousands of measurements).
"""

from __future__ import annotations


import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map as _shard_map


def shard_map(f, *, mesh, in_specs, out_specs, check_rep=True):
    return _shard_map(
        f,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=check_rep,
    )


from ..ops.spectral import welch as _welch
from ..ops.windows import get_window
from ..standard.enums import SpectrumScaling, Window


def parallel_welch(
    x: jnp.ndarray,
    mesh: Mesh,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
) -> jnp.ndarray:
    """Welch autospectra of ``x (C, T)`` with channels sharded across the
    mesh's first axis. Purely local compute — no collectives."""
    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    assert x.shape[0] % n == 0, (
        f"Channel count {x.shape[0]} must divide across {n} devices"
    )

    def local(xl):
        return _welch(
            xl,
            sampling_rate_hz=sampling_rate_hz,
            window_length_samples=window_length_samples,
            window_type=window_type,
            overlap_percent=overlap_percent,
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(axis, None),
    )
    sharding = NamedSharding(mesh, P(axis, None))
    return jax.jit(fn, in_shardings=sharding)(jax.device_put(x, sharding))


def _windowed_spectra(xl, window, step, norm, detrend=True):
    """Local windowed FFT frames (C_local, K, F). Same frame pipeline as
    the single-device path (`ops/spectral.py:_windowed_frames`): window
    first, then per-frame mean removal."""
    from ..ops.framing import frame_signal

    frames = frame_signal(xl, len(window), step, True)
    frames = frames * jnp.asarray(window, frames.dtype)
    if detrend:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    return jnp.fft.rfft(frames, axis=-1, norm=norm)


def parallel_csm(
    x: jnp.ndarray,
    mesh: Mesh,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    detrend: bool = True,
    scaling: SpectrumScaling = SpectrumScaling.PowerSpectralDensity,
) -> tuple[np.ndarray, jnp.ndarray]:
    """Cross-spectral matrix of ``x (C, T)``, rows sharded over the mesh.

    Row-parallel Gram-matrix pattern: local spectra → `all_gather` →
    one local einsum per device for its (C/n, C, F) row block.
    Returns ``(f, csm)`` with ``csm (F, C, C)`` sharded on the second
    (row) axis.
    """
    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    C = x.shape[0]
    assert C % n == 0, f"{C} channels do not divide over {n} devices"

    window = get_window(window_type, window_length_samples, symmetric=False)
    step = window_length_samples - int(
        overlap_percent / 100 * window_length_samples
    )
    norm = scaling.fft_norm()

    def local(xl):
        Xl = _windowed_spectra(
            xl, window, step, norm, detrend
        )  # (C/n, K, F)
        X_all = jax.lax.all_gather(
            Xl, axis, axis=0, tiled=True
        )  # (C, K, F)
        K = Xl.shape[1]
        # rows[f, a_local, b] = mean_k conj(Xl[a,k,f]) X_all[b,k,f]
        rows = (
            jnp.einsum(
                "akf,bkf->fab",
                jnp.conjugate(Xl),
                X_all,
                precision=jax.lax.Precision.HIGHEST,
            )
            / K
        )
        return rows

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(None, axis, None),
    )
    in_sharding = NamedSharding(mesh, P(axis, None))
    csm = jax.jit(fn, in_shardings=in_sharding)(
        jax.device_put(x, in_sharding)
    )
    # finish exactly like the single-device kernel
    # (ops/spectral.py:csm_welch tail): exact-real diagonal, physical
    # scaling + halved edge bins, per-pair sqrt for amplitude scalings,
    # then the reference-order Hermitian assembly — GSPMD keeps these
    # elementwise/transpose ops on the sharded array
    from ..ops.spectral import _assemble_csm_reference_order

    eye = jnp.eye(csm.shape[-1])
    csm = csm * (1 - eye) + jnp.real(csm) * eye
    if scaling.has_physical_units():
        factor = scaling.get_scaling_factor(
            window_length_samples, sampling_rate_hz, window
        )
        edge = np.ones(csm.shape[0])
        edge[0] = edge[-1] = 0.5
        csm = csm * factor * jnp.asarray(edge)[:, None, None]
    if scaling.is_amplitude_scaling():
        csm = jnp.sqrt(
            csm.astype(jnp.result_type(csm.dtype, jnp.complex64))
        )
    csm = _assemble_csm_reference_order(csm)
    f = np.fft.rfftfreq(window_length_samples, 1 / sampling_rate_hz)
    return f, csm


def parallel_filterbank(
    sos_bank: np.ndarray,
    x: jnp.ndarray,
    mesh: Mesh,
) -> jnp.ndarray:
    """Apply a battery of SOS filters ``sos_bank (B, S, 6)`` to
    ``x (..., T)`` with bands sharded across devices.

    Each device runs the blocked IIR kernel for its bands; output
    ``(B, ..., T)`` stays band-sharded (tensor-parallel layout)."""
    from ..ops.iir_block import (
        sosfilt_bank_apply,
        sosfilt_bank_operators,
    )

    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    B = sos_bank.shape[0]
    assert B % n == 0, f"{B} bands do not divide over {n} devices"

    # The block operators are precomputed host-side in f64 and handed to
    # the devices as band-stacked tensors — they shard on the band axis
    # like any other parameter (tensor parallelism).
    ops = sosfilt_bank_operators(np.asarray(sos_bank), x.shape[-1])
    meta = {k: ops[k] for k in ("L", "n_full", "rem")}
    tensors = [ops["HmatT"], ops["GyT"], ops["ALT"], ops["MT"]]
    if ops["rem"]:
        tensors += list(ops["rem_ops"])

    def local(x_rep, *tens):
        local_ops = dict(meta)
        (
            local_ops["HmatT"],
            local_ops["GyT"],
            local_ops["ALT"],
            local_ops["MT"],
        ) = tens[:4]
        local_ops["rem_ops"] = list(tens[4:]) if meta["rem"] else None
        return sosfilt_bank_apply(local_ops, x_rep)

    band_specs = tuple(P(axis, *([None] * (t.ndim - 1))) for t in tensors)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(*([None] * x.ndim)),) + band_specs,
        out_specs=P(axis, *([None] * x.ndim)),
        check_rep=False,
    )
    x_sharding = NamedSharding(mesh, P(*([None] * x.ndim)))
    band_shardings = tuple(NamedSharding(mesh, s) for s in band_specs)
    # complex cascades (gammatone) must keep their imaginary parts: cast
    # to the complex compute dtype, never to real x.dtype
    op_dtype = (
        jnp.result_type(x.dtype, jnp.complex64)
        if any(np.iscomplexobj(t) for t in tensors)
        else x.dtype
    )
    placed = [
        jax.device_put(jnp.asarray(t, op_dtype), s)
        for t, s in zip(tensors, band_shardings)
    ]
    return jax.jit(
        fn, in_shardings=(x_sharding,) + band_shardings
    )(jax.device_put(x, x_sharding), *placed)


def sharded_map_reduce(
    map_fn,
    x: jnp.ndarray,
    mesh: Mesh,
    reduce: str | None = None,
):
    """Apply ``map_fn`` to the leading-axis blocks of ``x`` across
    devices (dp fan-out) and optionally reduce.

    ``map_fn`` must be shape-preserving on the leading axis (vmappable).
    ``reduce``: None (keep sharded), "sum" or "mean" (`psum`).
    """
    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    assert x.shape[0] % n == 0, (
        f"Leading axis {x.shape[0]} must divide across {n} devices"
    )

    def local(xl):
        out = jax.vmap(map_fn)(xl)
        if reduce == "sum":
            return jax.lax.psum(jnp.sum(out, axis=0), axis)
        if reduce == "mean":
            return jax.lax.psum(jnp.sum(out, axis=0), axis) / x.shape[0]
        return out

    if reduce is None:
        out_specs = P(axis)
    else:
        out_specs = P()
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis, *([None] * (x.ndim - 1))),
        out_specs=out_specs,
        check_rep=False,
    )
    sharding = NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
    return jax.jit(fn, in_shardings=sharding)(jax.device_put(x, sharding))


def parallel_fir_filter(
    h: np.ndarray,
    x: jnp.ndarray,
    mesh: Mesh,
) -> jnp.ndarray:
    """Causal FIR filtering of ``x (..., T)`` with the TIME axis sharded
    across the mesh (sequence parallelism for DSP).

    Each device convolves its time shard; the K-1 samples of left-neighbor
    history arrive via one `ppermute` (halo exchange) — the multi-device
    analog of streamed overlap-save. Output equals
    ``lfilter(h, 1, x)`` and stays time-sharded.
    """
    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    T = x.shape[-1]
    assert T % n == 0, f"time length {T} must divide across {n} devices"
    K = len(h)
    assert K - 1 <= T // n, "kernel longer than a time shard"
    hj = jnp.asarray(h, x.dtype)
    if K == 1:
        # no history needed — a 1-tap filter is a pure scaling (and the
        # -(K-1) halo slice below would grab the whole shard)
        return jax.jit(lambda xv: xv * hj[0])(x)

    def local(xl):
        # send this shard's tail one device to the right
        halo = jax.lax.ppermute(
            xl[..., -(K - 1):],
            axis,
            [(i, (i + 1) % n) for i in range(n)],
        )
        # the first shard has no history (zeros)
        first = jax.lax.axis_index(axis) == 0
        halo = jnp.where(first, jnp.zeros_like(halo), halo)
        xpad = jnp.concatenate([halo, xl], axis=-1)
        from ..ops.fft_conv import fft_convolve

        y = fft_convolve(xpad, hj, "full")
        return y[..., K - 1 : K - 1 + xl.shape[-1]]

    spec = P(*([None] * (x.ndim - 1) + [axis]))
    fn = shard_map(
        local, mesh=mesh, in_specs=spec, out_specs=spec,
        check_rep=False,
    )
    sharding = NamedSharding(mesh, spec)
    return jax.jit(fn, in_shardings=sharding)(jax.device_put(x, sharding))


def parallel_das_map(
    amp: np.ndarray,
    diff: np.ndarray,
    wave_numbers: np.ndarray,
    csm: np.ndarray,
    mesh: Mesh,
) -> jnp.ndarray:
    """Grid-parallel frequency-domain DAS map.

    The steering tensor factors as ``h[f,m,g] = amp[m,g] e^{-j k_f d[m,g]}``
    (`beamforming._steering_amp_diff`); the grid axis is embarrassingly
    parallel, so each device builds the steering block for its grid chunk
    in-program and evaluates ``map[g,f] = h^H C h`` locally — the (small)
    CSM is replicated, no collectives are needed until the final gather.

    ``amp``/``diff`` are (M, G) host arrays, ``wave_numbers`` (F,),
    ``csm`` (F, M, M) complex host. G must divide over the mesh's first
    axis. Returns the (G, F) map, grid-sharded.
    """
    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    G = amp.shape[1]
    assert G % n == 0, f"{G} grid points do not divide over {n} devices"

    amp_j = jnp.asarray(amp, jnp.float32)
    diff_j = jnp.asarray(diff, jnp.float32)
    k_j = jnp.asarray(wave_numbers, jnp.float32)
    cre = jnp.asarray(np.ascontiguousarray(csm.real), jnp.float32)
    cim = jnp.asarray(np.ascontiguousarray(csm.imag), jnp.float32)

    # the single-chip packed-real core (deferred import: beamforming
    # imports this module for its mesh path)
    from ..beamforming.beamforming import _das_map_core

    def local(amp_l, diff_l, k_rep, cre_rep, cim_rep):
        return _das_map_core(amp_l, diff_l, k_rep, cre_rep, cim_rep)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, axis),
            P(None, axis),
            P(None),
            P(None, None, None),
            P(None, None, None),
        ),
        out_specs=P(axis, None),
        check_rep=False,
    )
    shard_g = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())
    args = (
        jax.device_put(amp_j, shard_g),
        jax.device_put(diff_j, shard_g),
        jax.device_put(k_j, rep),
        jax.device_put(cre, rep),
        jax.device_put(cim, rep),
    )
    return jax.jit(fn)(*args)


def parallel_batch_descriptors(
    rirs: jnp.ndarray, sampling_rate_hz: int, mesh: Mesh
) -> dict:
    """dp-sharded room-acoustics descriptor battery: the RIR fleet's batch
    axis splits across the mesh; each device runs the jitted descriptor
    kernel on its shard (no collectives — outputs stay batch-sharded)."""
    from ..room_acoustics.batch import batch_descriptors

    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    B = rirs.shape[0]
    assert B % n == 0, f"{B} RIRs do not divide over {n} devices"

    def local(r):
        return batch_descriptors(r, sampling_rate_hz)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=P(axis),
        check_rep=False,
    )
    sharding = NamedSharding(mesh, P(axis, None))
    return jax.jit(fn)(jax.device_put(jnp.asarray(rirs), sharding))


def _framed_halo_setup(window_length, step, T, n):
    """Shared validation for time-sharded framed spectral ops: each device
    owns the frames STARTING in its shard (L/step of them) and needs the
    right neighbor's first ``window - step`` samples (one `ppermute` halo
    — the STFT-framing analog of overlap-save sequence
    parallelism, SURVEY §5)."""
    assert T % n == 0, f"time length {T} must divide across {n} devices"
    L = T // n
    assert L % step == 0, (
        f"local shard ({L}) must be a multiple of the hop size ({step}) so "
        "every device owns a whole number of frames"
    )
    halo = window_length - step
    assert halo <= L, "window overhang longer than a time shard"
    return L, halo


def _local_framed_spectra_halo(
    xl, window, step, norm, detrend, fft_length, axis, n
):
    """Frames of the local time shard, extended by the right-neighbor halo:
    ``(..., L/step, F)`` windowed spectra. Runs inside `shard_map`."""
    W = len(window)
    halo_len = W - step
    if halo_len > 0:
        # send this shard's HEAD one device to the left
        halo = jax.lax.ppermute(
            xl[..., :halo_len],
            axis,
            [(i, (i - 1) % n) for i in range(n)],
        )
        # the last shard sees zeros beyond the end of the recording (the
        # zero_padding convention of `frame_signal`)
        last = jax.lax.axis_index(axis) == n - 1
        halo = jnp.where(last, jnp.zeros_like(halo), halo)
        xl = jnp.concatenate([xl, halo], axis=-1)
    K_local = (xl.shape[-1] - halo_len) // step
    starts = jnp.arange(K_local) * step
    idx = starts[:, None] + jnp.arange(W)[None, :]
    frames = xl[..., idx]  # (..., K_local, W) gather
    frames = frames * jnp.asarray(window, frames.dtype)
    if detrend:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    return jnp.fft.rfft(frames, axis=-1, n=fft_length, norm=norm)


def parallel_stft(
    x: jnp.ndarray,
    mesh: Mesh,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    fft_length_samples: int | None = None,
    detrend: bool = False,
    scaling: SpectrumScaling = SpectrumScaling.FFTBackward,
):
    """STFT of ``x (..., T)`` with the TIME axis sharded across the mesh
    (sequence parallelism for hour-long recordings).

    Each device frames its own time shard; the ``window - step`` samples
    that the shard's last frames overhang into the neighbor arrive via one
    `ppermute` halo exchange. Output ``(..., n_frames, F)`` stays
    frame-sharded (frames = time). Equals the single-device
    ``ops.stft(..., padding=False)`` (the reference's edge padding,
    `_spectral_methods.py:246`, is a global transform of the time axis —
    apply it before sharding when needed).
    Matches `_framed_signal_representation.py:9` framing.
    """
    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    if fft_length_samples is None:
        fft_length_samples = window_length_samples
    window = get_window(window_type, window_length_samples, symmetric=False)
    overlap = int(
        overlap_percent / 100 * window_length_samples + 0.5
    )  # stft rounds (ops/spectral.py:189)
    step = window_length_samples - overlap
    _framed_halo_setup(window_length_samples, step, x.shape[-1], n)
    norm = scaling.fft_norm()

    def local(xl):
        return _local_framed_spectra_halo(
            xl, window, step, norm, detrend, fft_length_samples, axis, n
        )

    spec_in = P(*([None] * (x.ndim - 1) + [axis]))
    spec_out = P(*([None] * (x.ndim - 1) + [axis, None]))
    fn = shard_map(
        local, mesh=mesh, in_specs=spec_in, out_specs=spec_out,
        check_rep=False,
    )
    sharding = NamedSharding(mesh, spec_in)
    S = jax.jit(fn, in_shardings=sharding)(jax.device_put(x, sharding))

    if scaling.has_physical_units():
        edge = np.ones(S.shape[-1])
        edge[0] = 1 / 2**0.5
        if fft_length_samples % 2 == 0:
            edge[-1] = 1 / 2**0.5
        S = S * jnp.asarray(edge)
        factor = scaling.get_scaling_factor(
            fft_length_samples, sampling_rate_hz, window
        )
        if not scaling.is_amplitude_scaling():
            S = jnp.abs(S) ** 2.0
        S = S * factor

    n_frames = S.shape[-2]
    time_s = np.linspace(0, x.shape[-1] / sampling_rate_hz, n_frames)
    freqs_hz = np.fft.rfftfreq(len(window), 1 / sampling_rate_hz)
    return time_s, freqs_hz, S


def parallel_welch_time(
    x: jnp.ndarray,
    mesh: Mesh,
    *,
    sampling_rate_hz: int,
    window_length_samples: int = 1024,
    window_type: Window = Window.Hann,
    overlap_percent: float = 50.0,
    detrend: bool = True,
    scaling: SpectrumScaling = SpectrumScaling.PowerSpectralDensity,
) -> jnp.ndarray:
    """Welch autospectra of ``x (..., T)`` with the TIME axis sharded
    across the mesh: each device averages the periodograms of its own
    frames (halo exchange as in `parallel_stft`), one `psum` merges the
    partial sums. Mean averaging only (median needs the global frame
    population on one device). Returns the replicated ``(..., F)``
    spectrum equal to the single-device ``ops.welch`` up to summation
    order."""
    axis = mesh.axis_names[0]
    n = int(mesh.shape[axis])
    window = get_window(window_type, window_length_samples, symmetric=False)
    overlap = int(
        overlap_percent / 100 * window_length_samples
    )  # welch truncates (ops/spectral.py:116)
    step = window_length_samples - overlap
    L, _ = _framed_halo_setup(window_length_samples, step, x.shape[-1], n)
    norm = scaling.fft_norm()
    K_total = x.shape[-1] // step

    def local(xl):
        X = _local_framed_spectra_halo(
            xl, window, step, norm, detrend, window_length_samples, axis, n
        )
        part = jnp.sum(jnp.abs(X) ** 2.0, axis=-2)  # (..., F)
        return jax.lax.psum(part, axis) / K_total

    spec_in = P(*([None] * (x.ndim - 1) + [axis]))
    spec_out = P(*([None] * x.ndim))
    fn = shard_map(
        local, mesh=mesh, in_specs=spec_in, out_specs=spec_out,
        check_rep=False,
    )
    sharding = NamedSharding(mesh, spec_in)
    csd = jax.jit(fn, in_shardings=sharding)(jax.device_put(x, sharding))

    if scaling.has_physical_units():
        factor = scaling.get_scaling_factor(
            window_length_samples, sampling_rate_hz, window
        )
        csd = csd * factor
        edge = np.ones(csd.shape[-1])
        edge[0] = edge[-1] = 0.5
        csd = csd * jnp.asarray(edge, dtype=csd.real.dtype)
    if scaling.is_amplitude_scaling():
        csd = jnp.sqrt(csd)
    return csd
