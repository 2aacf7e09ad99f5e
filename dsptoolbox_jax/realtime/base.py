"""Streaming runtime base (JAX rebuild of the reference's RealtimeFilter
hierarchy, `dsptoolbox/classes/realtime_filter.py`).

Design: the reference's contract is per-sample Python processing. Here every
filter also exposes `process_block(block, channel)` / vectorized signal
filtering backed by jitted `lax.scan` device kernels where the structure
allows it — per-sample Python recursion cannot be the hot path. The
`process_sample` methods keep exact reference semantics (host numpy state)
for API parity and for tests.
"""

from __future__ import annotations

import abc

import numpy as np


class RealtimeFilter(abc.ABC):
    """Sample/block streaming filter contract
    (`classes/realtime_filter.py:4-19`)."""

    @abc.abstractmethod
    def process_sample(self, x: float, channel: int):
        """Process one sample for a channel (state updated in place)."""

    @abc.abstractmethod
    def reset_state(self):
        """Reset all filter states to 0."""

    @abc.abstractmethod
    def set_n_channels(self, n_channels: int):
        """Set the number of channels to be filtered."""

    def process_block(self, block, channel: int):
        """Process a 1D block of samples (default: per-sample loop; device
        implementations override this)."""
        block = np.asarray(block)
        out = np.empty_like(block)
        for i in range(len(block)):
            out[i] = self.process_sample(block[i], channel)
        return out
