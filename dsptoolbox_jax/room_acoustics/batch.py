"""Batched room-acoustics descriptors: one jitted program over fleets of
RIRs.

Device-native extension beyond the reference API (which loops channels on the
host, `room_acoustics.py:34-140`): production acoustic pipelines evaluate
thousands of measured or synthesized RIRs; here the whole fleet is a
``(B, T)`` array and every descriptor is computed in one batched device
program — masked least-squares fits instead of data-dependent trimming,
`vmap`-free broadcasting throughout. Shard the batch axis with
`dsptoolbox_jax.parallel.sharded_map_reduce` (or `shard_batch`) to scale
across a mesh.

Conventions: each row is one RIR; the direct sound is located with the
energy peak (`argmax |h|`). Descriptors follow ISO 3382 definitions (D50,
C80, center time, EDT/T20/T30 from the Schroeder backward integral).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.prefix import cumsum_matmul

__all__ = [
    "batch_energy_decay",
    "batch_descriptors",
    "batch_reverb_times",
    "batch_synthetic_rirs",
]


def batch_synthetic_rirs(
    room,
    source_positions,
    receiver_positions,
    sampling_rate_hz: int,
    total_length_seconds: float = 0.5,
    max_order: int | None = None,
) -> jnp.ndarray:
    """Image-source RIRs for a FLEET of source/receiver pairs in one
    device program — the batched extension of
    `generate_synthetic_rir` (the reference loops its triple-Python-loop
    generator per pair, `_room_acoustics.py:161-268`).

    ``source_positions`` / ``receiver_positions``: ``(B, 3)`` arrays in
    the same room. Returns a ``(B, T)`` float32 DEVICE array (feed it
    straight to `batch_descriptors` / `batch_reverb_times` without a
    host round trip). The sample-index math runs in double-single
    arithmetic, so each row is bit-identically placed vs the f64
    single-RIR oracle."""
    from ._backend import (
        _U_VECTORS,
        _ism_device_program_batched,
    )

    s = np.atleast_2d(np.asarray(source_positions, np.float64))
    r = np.atleast_2d(np.asarray(receiver_positions, np.float64))
    assert s.shape == r.shape and s.shape[1] == 3, (
        "source/receiver positions must both be (B, 3)"
    )
    for p in np.concatenate([s, r]):
        assert room.check_if_in_room(p), (
            f"Position {p} is not located inside the room"
        )
    room_dim = np.asarray(room.dimensions_m, np.float64)
    alpha = room.absorption_coefficient
    beta = np.atleast_1d(np.sqrt(1 - np.asarray(alpha, np.float64)))
    if len(beta) == 1:
        beta_1 = beta_2 = np.ones(3) * beta
    elif len(beta) == 6:
        beta_1 = np.array([beta[1], beta[3], beta[4]])
        beta_2 = np.array([beta[0], beta[2], beta[5]])
    else:
        raise ValueError("Wrong length for absorption coefficients")
    c = 343
    t_max = room.t60_s * 1.1
    l_max = c * t_max / 2 / room_dim
    LIMIT = int(np.ceil(np.sqrt(l_max @ l_max)))
    if max_order is not None:
        LIMIT = min(LIMIT, max_order)
    gen_length = int(t_max * 5 * sampling_rate_hz)
    out_length = int(total_length_seconds * sampling_rate_hz)

    # a[b, u, :] = (1-2u)*s_b - r_b, split to double-single fp32 pairs
    a64 = (1 - 2 * _U_VECTORS)[None, :, :] * s[:, None, :] - r[:, None, :]
    b64 = 2 * room_dim
    a_hi = a64.astype(np.float32)
    b_hi = b64.astype(np.float32)
    program, _ = _ism_device_program_batched(
        LIMIT, sampling_rate_hz, gen_length
    )
    rirs = program(
        jnp.asarray(a_hi),
        jnp.asarray((a64 - a_hi).astype(np.float32)),
        jnp.asarray(b_hi),
        jnp.asarray((b64 - b_hi).astype(np.float32)),
        jnp.asarray(beta_1, jnp.float32),
        jnp.asarray(beta_2, jnp.float32),
    )
    return _pad_rirs(rirs, out_length)


@partial(jax.jit, static_argnames="out_length")
def _pad_rirs(rirs, out_length: int):
    from ..ops.pad_trim import pad_trim_axis

    return pad_trim_axis(rirs, out_length, axis=-1)

def _start_indices(rirs: jnp.ndarray) -> jnp.ndarray:
    """Direct-sound index per row: energy peak."""
    return jnp.argmax(jnp.abs(rirs), axis=-1)


def _mask_from_start(T: int, start: jnp.ndarray) -> jnp.ndarray:
    t = jnp.arange(T)[None, :]
    return (t >= start[:, None]).astype(jnp.float32)


@jax.jit
def batch_energy_decay(rirs: jnp.ndarray) -> jnp.ndarray:
    """Schroeder backward-integrated energy decay curves in dB, ``(B, T)``.

    Rows are aligned to their direct-sound peak (samples before the peak
    are excluded from the integral); 0 dB at the decay start.
    """
    rirs = jnp.atleast_2d(jnp.asarray(rirs))
    T = rirs.shape[-1]
    start = _start_indices(rirs)
    mask = _mask_from_start(T, start)
    e = (rirs**2) * mask
    # backward cumulative integral. Off the CPU: blocked triangular
    # matmuls (ops/prefix.py) in place of XLA's log-depth cumsum passes.
    # The matmul form inflates arithmetic ~L×, so the CPU oracle path
    # keeps plain cumsum; the branch is static at trace time.
    if jax.default_backend() == "cpu":
        edc = jnp.cumsum(e[..., ::-1], axis=-1)[..., ::-1]
    else:
        edc = cumsum_matmul(e, reverse=True)
    total = edc[:, :1]
    edc_db = 10.0 * jnp.log10(
        jnp.maximum(edc, 1e-30) / jnp.maximum(total, 1e-30)
    )
    return edc_db


@partial(jax.jit, static_argnames="sampling_rate_hz")
def batch_descriptors(
    rirs: jnp.ndarray, sampling_rate_hz: int
) -> dict[str, jnp.ndarray]:
    """D50, C80 and center time for a fleet of RIRs ``(B, T)`` in one
    jitted program. Returns a dict of ``(B,)`` arrays."""
    rirs = jnp.atleast_2d(jnp.asarray(rirs))
    B, T = rirs.shape
    start = _start_indices(rirs)
    t_idx = jnp.arange(T)[None, :]
    rel = t_idx - start[:, None]  # samples since direct sound
    e = rirs**2 * (rel >= 0)

    n50 = int(50e-3 * sampling_rate_hz)
    n80 = int(80e-3 * sampling_rate_hz)
    e_total = jnp.sum(e, axis=-1)
    e_50 = jnp.sum(e * (rel < n50), axis=-1)
    e_80 = jnp.sum(e * (rel < n80), axis=-1)
    d50 = e_50 / jnp.maximum(e_total, 1e-30)
    c80 = 10.0 * jnp.log10(
        jnp.maximum(e_80, 1e-30)
        / jnp.maximum(e_total - e_80, 1e-30)
    )
    ts = (
        jnp.sum(e * jnp.maximum(rel, 0), axis=-1)
        / jnp.maximum(e_total, 1e-30)
        / sampling_rate_hz
    )
    return {"d50": d50, "c80": c80, "center_time_s": ts}


def _masked_linear_fit(
    x: jnp.ndarray, y: jnp.ndarray, mask: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row least-squares line fit of y over x restricted to mask.

    Returns (slope, intercept), each (B,)."""
    w = mask.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    mx = jnp.sum(w * x, axis=-1) / n
    my = jnp.sum(w * y, axis=-1) / n
    cov = jnp.sum(w * (x - mx[:, None]) * (y - my[:, None]), axis=-1)
    var = jnp.maximum(
        jnp.sum(w * (x - mx[:, None]) ** 2, axis=-1), 1e-30
    )
    slope = cov / var
    return slope, my - slope * mx


@partial(jax.jit, static_argnames=("sampling_rate_hz", "mode"))
def batch_reverb_times(
    rirs: jnp.ndarray,
    sampling_rate_hz: int,
    mode: str = "T20",
) -> jnp.ndarray:
    """EDT/T20/T30 for a fleet of RIRs ``(B, T)`` via masked linear fits
    on the Schroeder decay (ISO 3382 evaluation ranges), one jitted
    program. Returns seconds, ``(B,)``."""
    ranges = {"EDT": (0.0, -10.0), "T20": (-5.0, -25.0),
              "T30": (-5.0, -35.0)}
    assert mode in ranges, f"mode must be one of {sorted(ranges)}"
    hi, lo = ranges[mode]
    rirs = jnp.atleast_2d(jnp.asarray(rirs))
    edc_db = batch_energy_decay(rirs)
    B, T = edc_db.shape
    t = (jnp.arange(T) / sampling_rate_hz)[None, :] * jnp.ones((B, 1))
    # exclude the flat 0 dB plateau before the direct sound: for an RIR
    # with leading delay the EDC is constant there and including it in the
    # EDT fit flattens the slope
    start = _start_indices(rirs)
    mask = (
        (edc_db <= hi)
        & (edc_db >= lo)
        & (jnp.arange(T)[None, :] >= start[:, None])
    )
    slope, _ = _masked_linear_fit(t, edc_db, mask)
    # reference convention (`_room_acoustics.py:81`): T20/T30 extrapolate
    # the fitted slope to a 60 dB decay; EDT reports the 0 -> -10 dB time
    factor = 10.0 if mode == "EDT" else 60.0
    return -factor / jnp.minimum(slope, -1e-10)
