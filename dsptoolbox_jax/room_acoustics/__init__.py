"""Room acoustics (JAX rebuild of `dsptoolbox/room_acoustics/`)."""

from .enums import ReverbTime, RoomAcousticsDescriptor
from .room_acoustics import (
    convolve_rir_on_signal,
    descriptors,
    find_ir_start,
    find_modes,
    generate_synthetic_rir,
    reverb_time,
)
from .batch import (  # noqa: F401
    batch_descriptors,
    batch_energy_decay,
    batch_reverb_times,
    batch_synthetic_rirs,
)
from .rooms import Room, ShoeboxRoom

__all__ = [
    "reverb_time",
    "find_modes",
    "convolve_rir_on_signal",
    "find_ir_start",
    "generate_synthetic_rir",
    "descriptors",
    "Room",
    "ShoeboxRoom",
    "ReverbTime",
    "RoomAcousticsDescriptor",
    "batch_synthetic_rirs",
]
