"""Streaming runtime (JAX rebuild of the reference RealtimeFilter family,
`dsptoolbox/classes/*_realtime.py` and friends)."""

from .base import RealtimeFilter
from .iir_fir import (
    FIRFilter,
    FIRFilterOverlapSave,
    FIRUniformPartitioned,
    FIRUniformPartitionedMultichannel,
    IIRFilter,
)
from .kautz import KautzFilter
from .misc import (
    ExponentialAverageFilter,
    FilterChain,
    LatticeLadderFilter,
    StateSpaceFilter,
    StateVariableFilter,
    WarpedFIR,
    WarpedIIR,
)
from .parallel_filter import ParallelFilter

__all__ = [
    "RealtimeFilter",
    "IIRFilter",
    "FIRFilter",
    "FIRFilterOverlapSave",
    "FIRUniformPartitioned",
    "FIRUniformPartitionedMultichannel",
    "KautzFilter",
    "ExponentialAverageFilter",
    "FilterChain",
    "LatticeLadderFilter",
    "StateSpaceFilter",
    "StateVariableFilter",
    "WarpedFIR",
    "WarpedIIR",
    "ParallelFilter",
]
