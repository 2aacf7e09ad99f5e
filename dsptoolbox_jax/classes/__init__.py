"""Core object model (L2): device-backed containers with static designs.

JAX rebuild of `dsptoolbox/classes/`: `Signal`, `ImpulseResponse`,
`MultiBandSignal`, `Filter`, `FilterBank`, `Spectrum`, `CalibrationData`.
"""

from .calibration_data import CalibrationData
from .filter import Filter
from .filterbank import FilterBank
from .impulse_response import ImpulseResponse
from .multibandsignal import MultiBandSignal
from .signal import DeviceSpectralData, DeviceTimeData, Signal
from .spectrum import Spectrum

__all__ = [
    "Signal",
    "DeviceSpectralData",
    "DeviceTimeData",
    "ImpulseResponse",
    "MultiBandSignal",
    "Filter",
    "FilterBank",
    "Spectrum",
    "CalibrationData",
]
