"""Miscellaneous array helpers (static geometry, thresholds, toeplitz).

Reference: `dsptoolbox/helpers/other.py`. Static/scalar utilities stay in
numpy (host-side); batch math is jax.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .gain_and_level import to_db


def find_nearest_points_index_in_vector(points, vector) -> np.ndarray:
    points = np.atleast_1d(np.asarray(points))
    vector = np.asarray(vector)
    return np.argmin(np.abs(points[:, None] - vector[None, :]), axis=1)


def find_frequencies_above_threshold(
    spec, f, threshold_db, normalize=True
) -> list:
    """First/last frequency whose (normalized) magnitude exceeds the
    threshold (`helpers/other.py:34-42`). Host-side: steers regularization
    windows, a static decision."""
    # pure host math: the spectrum is a small (F,) vector — an eager
    # device to_db would cost a dispatch + fetch round trip per call
    mag = np.abs(np.asarray(spec))
    floor = float(np.finfo(np.float64).smallest_normal)
    denum_db = 20.0 * np.log10(np.clip(mag, floor, None))
    if normalize:
        denum_db = denum_db - np.max(denum_db)
    freqs = np.asarray(f)[denum_db > threshold_db]
    return [freqs[0], freqs[-1]]


def toeplitz_convolution_matrix(h: jnp.ndarray, length_of_input: int):
    """Convolution operator as a toeplitz matrix
    ``(len(h)+L-1, L)`` (`helpers/other.py:44-68`); built with static index
    gathers so it jits."""
    h = jnp.asarray(h).reshape(-1)
    K = h.shape[0]
    L = length_of_input
    padded = jnp.concatenate([jnp.zeros(L - 1, h.dtype), h, jnp.zeros(L - 1, h.dtype)])
    rows = np.arange(K + L - 1)[:, None]
    cols = np.arange(L)[None, :]
    idx = rows - cols + (L - 1)
    return padded[idx]


def next_power_2(number, mode: str = "closest") -> int:
    """Closest/floor/ceil power of two (`helpers/other.py:95-130`)."""
    assert number > 0, "Only positive numbers are valid"
    mode = mode.lower()
    assert mode in ("closest", "floor", "ceil")
    p = np.log2(number)
    if mode == "closest":
        mode = "floor" if (p - int(p)) < 0.5 else "ceil"
    p = int(np.floor(p)) if mode == "floor" else int(np.ceil(p))
    return int(2**p)


def euclidean_distance_matrix(x, y):
    """Pairwise distances ``(Px, Py)`` from ``(Px, D)``/``(Py, D)``
    (`helpers/other.py:131-155`) — one matmul plus norms."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    assert x.ndim == 2 and y.ndim == 2, "Inputs must have exactly two dimensions"
    assert x.shape[1] == y.shape[1], "Dimensions do not match"
    sq = (
        jnp.sum(x**2, axis=1, keepdims=True)
        + jnp.sum(y**2, axis=1)[None, :]
        - 2 * jnp.matmul(x, y.T, precision=jax.lax.Precision.HIGHEST)
    )
    return jnp.sqrt(jnp.clip(sq, min=0.0))


def fractional_octave_bandwidth(f_c: float, fraction: int = 1) -> np.ndarray:
    """Lower/upper band edges for a fractional-octave band
    (`helpers/other.py:156-178`)."""
    if fraction == 0:
        return np.array([f_c, f_c])
    return np.array(
        [f_c * 2 ** (-1 / fraction / 2), f_c * 2 ** (1 / fraction / 2)]
    )


def check_format_in_path(path: str, desired_format: str) -> str:
    """Validate a file path's extension, appending it when the path has
    none (`helpers/other.py:69-94`)."""
    import os

    parts = path.split(os.sep)[-1].split(".")
    if len(parts) != 1:
        assert parts[-1] == desired_format, (
            f"{parts[-1]} is not the desired format"
        )
    else:
        path += f".{desired_format}"
    return path


def pearson_correlation(x: "np.ndarray", y: "np.ndarray") -> float:
    """Pearson correlation coefficient of two 1-D arrays (0.0 when either
    is constant). Shared by the EDC fits and the IR-trim decay scan."""
    x = np.asarray(x)
    y = np.asarray(y)
    xc = x - x.mean()
    yc = y - y.mean()
    denom = np.sqrt((xc**2).sum() * (yc**2).sum())
    return float((xc * yc).sum() / denom) if denom > 0 else 0.0
