"""Functional array-level ops (L1): pure jax, jit-friendly, channels-first.

Everything here operates on raw arrays with time on the last axis; the object
layer (`dsptoolbox_jax.classes`) adapts to the reference's public
``(time, channels)`` conventions.
"""

from .framing import (
    compute_number_frames,
    frame_signal,
    overlap_add,
    reconstruct_framed_signal,
    window_envelope,
)
from .differentiable import (
    biquad_coefficients_diff,
    fit_sos_to_magnitude,
    sosfilt_diff,
    sosfreqz_diff,
    sosfreqz_host,
)
from .pad_trim import pad_trim_axis
from .prefix import cumsum_matmul
from .spectral import csm_from_spectrum, csm_welch, stft, welch
from .windows import check_cola, get_window

__all__ = [
    "biquad_coefficients_diff",
    "fit_sos_to_magnitude",
    "sosfilt_diff",
    "sosfreqz_diff",
    "sosfreqz_host",
    "compute_number_frames",
    "frame_signal",
    "overlap_add",
    "reconstruct_framed_signal",
    "window_envelope",
    "pad_trim_axis",
    "cumsum_matmul",
    "welch",
    "stft",
    "csm_welch",
    "csm_from_spectrum",
    "get_window",
    "check_cola",
]
