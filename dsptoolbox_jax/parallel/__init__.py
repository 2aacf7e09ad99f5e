"""Multi-chip execution utilities (`jax.sharding` over a device mesh).

The reference package is a single-host NumPy library with no distribution
story; this module is the multi-device scale-out layer. DSP workloads shard
naturally along three axes:

- **dp** (data parallel): independent signals / measurement batches
- **ch** (channel parallel): microphone/array channels — CSM and
  beamforming maps are O(C²)/O(C·G) and ride this axis
- **band** (tensor parallel): filter-bank bands, grid chunks

Helpers here build meshes, produce `NamedSharding`s, and wrap the hot
multi-channel pipelines (Welch/CSM, filter banks, beamforming maps) in
`shard_map`/`pjit` so XLA inserts device collectives (`psum`, `all_gather`)
instead of any host-side gather.
"""

from .mesh import (
    device_mesh,
    shard_batch,
    shard_channels,
    replicate,
)
from .ops import (
    parallel_batch_descriptors,
    parallel_csm,
    parallel_das_map,
    parallel_fir_filter,
    parallel_filterbank,
    parallel_stft,
    parallel_welch,
    parallel_welch_time,
    sharded_map_reduce,
)

__all__ = [
    "device_mesh",
    "shard_batch",
    "shard_channels",
    "replicate",
    "parallel_welch",
    "parallel_welch_time",
    "parallel_stft",
    "parallel_csm",
    "parallel_fir_filter",
    "parallel_filterbank",
    "parallel_das_map",
    "parallel_batch_descriptors",
    "sharded_map_reduce",
]
