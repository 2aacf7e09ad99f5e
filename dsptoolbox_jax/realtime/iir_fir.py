"""Streaming IIR/FIR filters: per-sample TDF2, circular-buffer FIR,
overlap-save and uniformly partitioned block convolution.

Behavioral reference: `dsptoolbox/classes/iir_filter_realtime.py` and
`dsptoolbox/classes/fir_filter_realtime.py`. Block convolutions run as
batched device FFTs; the frequency-domain delay line of the partitioned
scheme is a rolled device array.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from scipy.fft import next_fast_len

from ..standard.enums import FilterCoefficientsType
from .base import RealtimeFilter


class IIRFilter(RealtimeFilter):
    """Transposed direct-form II streaming IIR
    (`iir_filter_realtime.py:9-66`)."""

    def __init__(self, b: np.ndarray, a: np.ndarray):
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a, dtype=np.float64)
        b = b / a[0]
        a = a / a[0]
        self.order = max(len(b), len(a)) - 1
        self.b = np.pad(b, (0, self.order + 1 - len(b)))
        self.a = np.pad(a, (0, self.order + 1 - len(a)))
        self.set_n_channels(1)

    @staticmethod
    def from_filter(iir) -> "IIRFilter":
        assert iir.is_iir, "Only valid for IIR filters"
        b, a = iir.get_coefficients(FilterCoefficientsType.Ba)
        return IIRFilter(b, a)

    def set_n_channels(self, n_channels: int):
        self.state = np.zeros((self.order, n_channels))

    def reset_state(self):
        self.state.fill(0.0)

    def process_sample(self, x: float, channel: int):
        y = self.b[0] * x + self.state[0, channel]
        for i in range(self.order - 1):
            self.state[i, channel] = (
                x * self.b[i + 1]
                - y * self.a[i + 1]
                + self.state[i + 1, channel]
            )
        self.state[-1, channel] = x * self.b[-1] - y * self.a[-1]
        return y

    def process_block(self, block, channel: int):
        """Blocked device path with carried scipy-convention state."""
        from ..ops.iir import lfilter

        y, zf = lfilter(
            self.b,
            self.a,
            jnp.asarray(np.asarray(block)),
            zi=jnp.asarray(self.state[:, channel]),
        )
        self.state[:, channel] = np.asarray(zf)
        return np.asarray(y)


class FIRFilter(RealtimeFilter):
    """Time-domain circular-buffer FIR
    (`fir_filter_realtime.py:11-70`)."""

    def __init__(self, b: np.ndarray):
        b = np.asarray(b, dtype=np.float64)
        self.order = len(b) - 1
        self.b = b
        self.set_n_channels(1)

    @staticmethod
    def from_filter(fir) -> "FIRFilter":
        assert fir.is_fir, "Only valid for FIR filters"
        b, _ = fir.get_coefficients(FilterCoefficientsType.Ba)
        return FIRFilter(b)

    def set_n_channels(self, n_channels: int):
        self.state = np.zeros((self.order, n_channels))
        self.current_state_ind = np.zeros(n_channels, dtype=int)

    def reset_state(self):
        self.state.fill(0.0)

    def process_sample(self, x: float, channel: int):
        y = self.b[0] * x
        write_index = self.current_state_ind[channel]
        for i in range(self.order):
            read_index = (write_index - i) % self.order
            y += self.state[read_index, channel] * self.b[i + 1]
        write_index = (write_index + 1) % self.order
        self.state[write_index, channel] = x
        self.current_state_ind[channel] = write_index
        return y


class FIRFilterOverlapSave(RealtimeFilter):
    """Block overlap-save convolution (device FFTs;
    `fir_filter_realtime.py:73-155`)."""

    def __init__(self, b: np.ndarray):
        b = np.asarray(b, dtype=np.float64)
        assert b.ndim == 1, "A single dimension should be provided"
        self.fir = b

    @staticmethod
    def from_filter(fir) -> "FIRFilterOverlapSave":
        assert fir.is_fir, "Only valid for FIR filters"
        b, _ = fir.get_coefficients(FilterCoefficientsType.Ba)
        return FIRFilterOverlapSave(b)

    def prepare(self, blocksize_samples: int, n_channels: int):
        self.blocksize = blocksize_samples
        self.total_length = next_fast_len(
            len(self.fir) + blocksize_samples, True
        )
        self.fir_spectrum = jnp.fft.rfft(
            jnp.asarray(self.fir), n=self.total_length
        )
        self.buffer = np.zeros((self.total_length, n_channels))

    def process_block(self, block, channel: int):
        self.buffer[-self.blocksize :, channel] = np.asarray(block)
        spec = jnp.fft.rfft(jnp.asarray(self.buffer[:, channel]))
        out = np.asarray(jnp.fft.irfft(spec * self.fir_spectrum))[
            -self.blocksize :
        ]
        self.buffer[: -self.blocksize, channel] = self.buffer[
            self.blocksize :, channel
        ]
        return out

    def process_sample(self, x: float, channel: int):
        raise NotImplementedError(
            "The convolution can only done via block-processing"
        )

    def reset_state(self):
        self.buffer.fill(0.0)

    def set_n_channels(self, n_channels: int):
        raise NotImplementedError("Use prepare method for setting the filter")


class FIRUniformPartitioned(FIRFilterOverlapSave):
    """Uniformly partitioned overlap-save with a frequency-domain delay line
    (`fir_filter_realtime.py:157-242`)."""

    def __init__(self, fir: np.ndarray):
        fir = np.asarray(fir, dtype=np.float64)
        assert fir.ndim == 1
        self.fir = fir

    @staticmethod
    def from_filter(fir) -> "FIRUniformPartitioned":
        assert fir.is_fir, "Only valid for FIR filters"
        b, _ = fir.get_coefficients(FilterCoefficientsType.Ba)
        return FIRUniformPartitioned(b)

    def prepare(self, blocksize_samples: int, n_channels: int):
        self.blocksize = blocksize_samples
        self.fft_size = blocksize_samples * 2
        self._prepare_partitions(n_channels)

    def _prepare_partitions(self, n_channels: int):
        import jax

        self.n_partitions = len(self.fir) // self.blocksize + 1
        partitioned = np.zeros((self.blocksize, self.n_partitions))
        for n in range(self.n_partitions):
            part = self.fir[n * self.blocksize : (n + 1) * self.blocksize]
            partitioned[: len(part), n] = part
        part_spec = np.fft.rfft(partitioned, axis=0, n=self.fft_size)
        self.buffer_ind = 0
        self.buffer_index_helper = np.arange(self.n_partitions)
        # frequency-domain delay line as a stacked-real state; the complex
        # arithmetic lives inside one jitted step
        self._state = jnp.zeros(
            (2, self.fft_size // 2 + 1, self.n_partitions, n_channels),
            dtype=jnp.float32,
        )
        self.input_buffer = np.zeros((self.fft_size, n_channels))
        part_c = jnp.asarray(np.stack([part_spec.real, part_spec.imag]))

        @jax.jit
        def _step(state, x_buf, ind, sel):
            X = jnp.fft.rfft(x_buf)
            state = state.at[0, :, ind].set(X.real.astype(jnp.float32))
            state = state.at[1, :, ind].set(X.imag.astype(jnp.float32))
            buf = state[0, :, sel] + 1j * state[1, :, sel]  # (P, F)
            ps = part_c[0] + 1j * part_c[1]  # (F, P)
            out = jnp.sum(ps * buf.T, axis=1)
            return state, jnp.fft.irfft(out)

        self._step = _step

    def reset_state(self):
        self._state = jnp.zeros_like(self._state)
        self.input_buffer.fill(0.0)

    def process_block(self, block, channel: int):
        self.input_buffer[: self.blocksize, channel] = self.input_buffer[
            -self.blocksize :, channel
        ]
        self.input_buffer[-self.blocksize :, channel] = np.asarray(block)
        sel = (self.buffer_ind - self.buffer_index_helper) % self.n_partitions
        st_ch, out = self._step(
            self._state[..., channel],
            jnp.asarray(self.input_buffer[:, channel], jnp.float32),
            self.buffer_ind,
            jnp.asarray(sel),
        )
        self._state = self._state.at[..., channel].set(st_ch)
        self.buffer_ind = (self.buffer_ind + 1) % self.n_partitions
        return np.asarray(out)[-self.blocksize :]


class FIRUniformPartitionedMultichannel(FIRUniformPartitioned):
    """Vectorized multichannel partitioned convolution
    (`fir_filter_realtime.py:243-335`)."""

    def __init__(self, fir: np.ndarray):
        fir = np.atleast_2d(np.asarray(fir, dtype=np.float64))
        if fir.shape[0] < fir.shape[1]:
            fir = fir.T
        self.fir = fir

    def prepare(self, blocksize_samples: int):  # type: ignore[override]
        self.blocksize = blocksize_samples
        self.fft_size = blocksize_samples * 2
        self._prepare_partitions_mc()

    def _prepare_partitions_mc(self):
        import jax

        self.n_partitions = self.fir.shape[0] // self.blocksize + 1
        self.n_channels = self.fir.shape[1]
        partitioned = np.zeros(
            (self.blocksize, self.n_partitions, self.n_channels)
        )
        for n in range(self.n_partitions):
            part = self.fir[n * self.blocksize : (n + 1) * self.blocksize]
            partitioned[: len(part), n, :] = part
        part_spec = np.fft.rfft(partitioned, axis=0, n=self.fft_size)
        self.buffer_ind = 0
        self.buffer_index_helper = np.arange(self.n_partitions)
        self._state = jnp.zeros(
            (2, self.fft_size // 2 + 1, self.n_partitions, self.n_channels),
            dtype=jnp.float32,
        )
        self.input_buffer = np.zeros((self.fft_size, self.n_channels))
        part_c = jnp.asarray(np.stack([part_spec.real, part_spec.imag]))

        @jax.jit
        def _step_mc(state, x_buf, ind, sel):
            X = jnp.fft.rfft(x_buf, axis=0)  # (F, C)
            state = state.at[0, :, ind, :].set(X.real.astype(jnp.float32))
            state = state.at[1, :, ind, :].set(X.imag.astype(jnp.float32))
            buf = (
                state[0][:, sel, :] + 1j * state[1][:, sel, :]
            )  # (F, P, C)
            ps = part_c[0] + 1j * part_c[1]  # (F, P, C)
            out = jnp.sum(ps * buf, axis=1)  # (F, C)
            return state, jnp.fft.irfft(out, axis=0)

        self._step_mc = _step_mc

    def process_block(self, block):  # type: ignore[override]
        self.input_buffer[: self.blocksize] = self.input_buffer[
            -self.blocksize :
        ]
        self.input_buffer[-self.blocksize :] = np.asarray(block)
        sel = (self.buffer_ind - self.buffer_index_helper) % self.n_partitions
        self._state, out = self._step_mc(
            self._state,
            jnp.asarray(self.input_buffer, jnp.float32),
            self.buffer_ind,
            jnp.asarray(sel),
        )
        self.buffer_ind = (self.buffer_ind + 1) % self.n_partitions
        return np.asarray(out)[-self.blocksize :]
