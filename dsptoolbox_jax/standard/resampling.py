"""Resampling of signals and filters (reference
`dsptoolbox/standard/resampling.py`). Signal resampling runs the polyphase
upfirdn kernel on device."""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..classes import Filter, Signal
from ..ops.fft_conv import resample_poly
from .enums import FilterCoefficientsType


def resample(
    sig: Signal, desired_sampling_rate_hz: int, rescaling: bool = False
) -> Signal:
    """Polyphase resampling (`standard/resampling.py:9-44`)."""
    if sig.sampling_rate_hz == desired_sampling_rate_hz:
        return sig.copy()
    ratio = Fraction(
        numerator=desired_sampling_rate_hz, denominator=sig.sampling_rate_hz
    )
    u, d = ratio.as_integer_ratio()
    from ..classes.signal import _dev_jit

    def _prog(td):
        y = resample_poly(td.T, up=u, down=d).T
        return y * (d / u) if rescaling else y

    # one jitted program, result stays device-resident (eager polyphase
    # ops would each dispatch separately)
    new_td = _dev_jit(("resample", u, d, bool(rescaling)), _prog)(
        sig.time_data_jax
    )
    new_sig = sig.copy_with_new_time_data(new_td)
    new_sig.sampling_rate_hz = desired_sampling_rate_hz
    return new_sig


def resample_filter(filter: Filter, new_sampling_rate_hz: int) -> Filter:
    """zpk → analog → re-bilinear filter resampling (host-side static
    design, `standard/resampling.py:46-83`)."""
    from scipy.signal import bilinear_zpk

    z, p, k = filter.get_coefficients(FilterCoefficientsType.Zpk)
    add_to_poles = max(0, len(z) - len(p))
    add_to_zeros = max(0, len(p) - len(z))
    f = 2 * filter.sampling_rate_hz
    p = f * (p - 1) / (p + 1)
    z = z[z != -1.0]
    z = f * (z - 1) / (z + 1)
    if add_to_poles:
        p = np.hstack([p, [-f] * (len(z) - len(p))])
    if add_to_zeros:
        z = np.hstack([z, [-f] * (len(p) - len(z))])
    k /= np.real(np.prod(f - z) / np.prod(f - p))
    z, p, k = bilinear_zpk(z, p, k, new_sampling_rate_hz)
    return Filter.from_zpk(z, p, k, new_sampling_rate_hz)
