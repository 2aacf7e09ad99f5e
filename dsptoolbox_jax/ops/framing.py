"""Framing (strided segmentation) and overlap-add reconstruction.

Device design: signals are channels-first ``(..., T)`` with time on the
minor (contiguous) axis. Framing is a gather with a static index matrix —
XLA lowers it to efficient dynamic slices; overlap-add is a scatter-add. Frame counts/padding
are static functions of the (static) signal length, so everything jits with
fixed shapes.

Behavioral reference: `dsptoolbox/standard/_framed_signal_representation.py`
and `dsptoolbox/helpers/other.py:181-213` (frame-count convention).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np



def compute_number_frames(
    window_length: int, step: int, signal_length: int, zero_padding: bool = True
) -> tuple[int, int]:
    """Number of frames and end-padding for segmenting a signal.

    Matches the reference convention (`helpers/other.py:181`): with
    ``zero_padding`` the signal is padded with ``window_length - (L % step)``
    samples (note: a full extra window when L is a multiple of the step) and
    produces ``ceil(L / step)`` frames; without it, trailing partial frames
    are dropped.
    """
    if zero_padding:
        n_frames = math.ceil(signal_length / step)
        padding = window_length - int(signal_length % step)
    else:
        n_frames = math.ceil((signal_length - window_length) / step)
        padding = 0
    return n_frames, padding


def frame_signal(
    x: jnp.ndarray,
    window_length: int,
    step: int,
    keep_last_frames: bool = True,
) -> jnp.ndarray:
    """Segment ``x (..., T)`` into overlapping frames ``(..., n_frames, L)``.

    ``n_frames`` follows `compute_number_frames`; when ``keep_last_frames`` the
    tail is zero-padded.
    """
    length = x.shape[-1]
    n_frames, padding = compute_number_frames(
        window_length, step, length, zero_padding=keep_last_frames
    )
    # signal shorter than one window with keep_last_frames=False: zero
    # frames (the reference's ceil() goes negative there and it crashes)
    n_frames = max(0, n_frames)
    span = (n_frames - 1) * step + window_length  # last sample touched + 1

    if window_length % step == 0 and n_frames >= 1:
        # Fast path: when the window is a multiple of the step, frames are
        # concatenations of k = L/step contiguous step-chunks — pure
        # reshape + k static slices, no gather. XLA lowers this to strided
        # copies.
        k = window_length // step
        total = span
        if total >= length:
            pad_widths = [(0, 0)] * (x.ndim - 1) + [(0, total - length)]
            xp = jnp.pad(x, pad_widths) if total > length else x
        else:
            xp = x[..., :total]
        chunks = xp.reshape(x.shape[:-1] + (total // step, step))
        parts = [
            chunks[..., j : j + n_frames, :] for j in range(k)
        ]
        return jnp.concatenate(parts, axis=-1)

    if keep_last_frames and padding:
        pad_widths = [(0, 0)] * (x.ndim - 1) + [(0, padding)]
        x = jnp.pad(x, pad_widths)
    # Static gather indices: (n_frames, window_length)
    idx = np.arange(n_frames)[:, None] * step + np.arange(window_length)[None, :]
    return jnp.take(x, jnp.asarray(idx), axis=-1)


def overlap_add(
    frames: jnp.ndarray,
    step: int,
    total_length: int | None = None,
) -> jnp.ndarray:
    """Overlap-add frames ``(..., n_frames, L)`` back into ``(..., T)``.

    ``total_length`` defaults to the reference's reconstruction length
    ``step * n_frames + L - step``.
    """
    n_frames, window_length = frames.shape[-2], frames.shape[-1]
    if total_length is None:
        total_length = step * n_frames + window_length - step
    # Scatter-free overlap-add: pad the window axis to k·step, view each
    # frame as k contiguous step-chunks, and accumulate the j-th chunk of
    # every frame at chunk row (frame + j). k static shifted adds of dense
    # (n_frames, step) views — XLA lowers them to fused strided updates
    # instead of a scatter-add.
    k = -(-window_length // step)
    pad = k * step - window_length
    if pad:
        frames = jnp.pad(
            frames, [(0, 0)] * (frames.ndim - 1) + [(0, pad)]
        )
    chunks = frames.reshape(frames.shape[:-1] + (k, step))
    rows = n_frames + k - 1
    acc = jnp.zeros(frames.shape[:-2] + (rows, step), dtype=frames.dtype)
    for j in range(k):
        acc = acc.at[..., j : j + n_frames, :].add(chunks[..., :, j, :])
    out = acc.reshape(frames.shape[:-2] + (rows * step,))
    if rows * step >= total_length:
        return out[..., :total_length]
    return jnp.pad(
        out,
        [(0, 0)] * (out.ndim - 1) + [(0, total_length - rows * step)],
    )


def window_envelope(
    window: np.ndarray,
    total_length: int,
    step: int,
    n_frames: int,
    squared: bool = True,
) -> np.ndarray:
    """Summed (optionally squared) window envelope across overlapped frames.

    Static given the window, so computed host-side in float64 and baked into
    the graph as a constant (reference `standard/_standard_backend.py:408`).
    """
    w = np.asarray(window, dtype=np.float64)
    if squared:
        w = w**2
    env = np.zeros(total_length, dtype=np.float64)
    for k in range(n_frames):
        start = k * step
        stop = min(start + len(w), total_length)
        if start >= total_length:
            break
        env[start:stop] += w[: stop - start]
    return env


def reconstruct_framed_signal(
    frames: jnp.ndarray,
    step: int,
    window: np.ndarray | None = None,
    original_signal_length: int | None = None,
    safety_threshold: float = 1e-4,
) -> jnp.ndarray:
    """Inverse of `frame_signal` with window² COLA normalization.

    ``frames (..., n_frames, L)`` → ``(..., T)``. Mirrors the reference
    semantics (`_framed_signal_representation.py:70`): frames are multiplied
    by the window (if given), overlap-added, and divided by the squared-window
    envelope clipped at ``safety_threshold``.
    """
    n_frames, wl = frames.shape[-2], frames.shape[-1]
    if window is not None:
        frames = frames * jnp.asarray(window, dtype=frames.dtype)
    # parity: the reference computes this length with the same float
    # expression (`_framed_signal_representation.py:115-118`); for some
    # (wl, step) pairs (e.g. wl=12, step=5) the truncation lands one sample
    # short of the exact `step*n + wl - step` — reproduced for parity.
    total_length = int(step * n_frames + wl * (1 - step / wl))
    out = overlap_add(frames, step, total_length)
    if window is not None:
        env = window_envelope(window, total_length, step, n_frames, squared=True)
        if safety_threshold is not None:
            env = np.clip(env, a_min=safety_threshold, a_max=None)
        nonzero = env > np.finfo(np.float64).tiny
        env_safe = np.where(nonzero, env, 1.0)
        out = jnp.where(
            jnp.asarray(nonzero),
            out / jnp.asarray(env_safe, dtype=out.dtype),
            out,
        )
    if original_signal_length is not None:
        from .pad_trim import pad_trim_axis

        out = pad_trim_axis(out, original_signal_length, axis=-1)
    return out
