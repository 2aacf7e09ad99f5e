"""dsptoolbox_jax — a JAX-native DSP / audio-acoustics framework.

A from-scratch JAX/XLA rebuild of the capabilities of
`nico-franco-gomez/dsptoolbox`: signal containers, filter design &
application, spectral estimation, transfer-function measurement, room
acoustics, filter banks, transforms, beamforming, effects, generators and
distance measures — redesigned for accelerators (static shapes, functional
compute kernels, blocked IIR recurrences as matmuls, compile-time
window/design precomputation, sharding over device meshes).

The public surface mirrors the reference package
(`dsptoolbox/__init__.py:12-75`): standard functions and classes at the
root, domain modules as namespaces.
"""

from ._config import default_complex, default_float, set_default_float
from .standard import (
    activity_detector,
    append_filterbanks,
    append_signals,
    append_spectra,
    apply_gain,
    crest_factor,
    delay,
    detrend,
    dither,
    envelope,
    fade,
    fractional_delay,
    latency,
    load_pkl_object,
    lufs_integrated,
    merge_filters,
    modify_signal_length,
    normalize,
    pad_trim,
    resample,
    resample_filter,
    rms,
    spectral_difference,
    trim_with_level_threshold,
    trim_with_time_selection,
    true_peak_level,
    # Enums
    BiquadEqType,
    FadeType,
    FilterBankMode,
    FilterCoefficientsType,
    FilterPassType,
    FrequencySpacing,
    IirDesignMethod,
    InterpolationDomain,
    InterpolationEdgeHandling,
    InterpolationScheme,
    MagnitudeNormalization,
    SpectrumMethod,
    SpectrumScaling,
    SpectrumType,
    Window,
)
from .classes import (
    CalibrationData,
    Filter,
    FilterBank,
    ImpulseResponse,
    MultiBandSignal,
    Signal,
    Spectrum,
)

from . import audio_io
from . import beamforming
from . import distances
from . import effects
from . import filterbanks
from . import generators
from . import plots
from . import room_acoustics
from . import tools
from . import transfer_functions
from . import transforms
from .pipeline import pipeline
from ._defer import compute_all

__version__ = "0.1.0"

__all__ = [
    "Signal",
    "ImpulseResponse",
    "MultiBandSignal",
    "Filter",
    "FilterBank",
    "Spectrum",
    "CalibrationData",
    "latency",
    "pad_trim",
    "trim_with_level_threshold",
    "trim_with_time_selection",
    "fade",
    "modify_signal_length",
    "append_signals",
    "pipeline",
    "compute_all",
    "append_filterbanks",
    "append_spectra",
    "fractional_delay",
    "delay",
    "activity_detector",
    "normalize",
    "true_peak_level",
    "lufs_integrated",
    "crest_factor",
    "resample",
    "resample_filter",
    "load_pkl_object",
    "detrend",
    "rms",
    "envelope",
    "dither",
    "apply_gain",
    "merge_filters",
    "spectral_difference",
    "SpectrumScaling",
    "SpectrumMethod",
    "FilterCoefficientsType",
    "BiquadEqType",
    "FilterBankMode",
    "FilterPassType",
    "IirDesignMethod",
    "MagnitudeNormalization",
    "SpectrumType",
    "InterpolationDomain",
    "InterpolationScheme",
    "InterpolationEdgeHandling",
    "FrequencySpacing",
    "Window",
    "FadeType",
    "transfer_functions",
    "distances",
    "room_acoustics",
    "plots",
    "generators",
    "filterbanks",
    "transforms",
    "audio_io",
    "beamforming",
    "effects",
    "tools",
    "default_float",
    "default_complex",
    "set_default_float",
]
