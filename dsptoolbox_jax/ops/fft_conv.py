"""FFT-based convolution (the device FIR path).

The reference's FIR application goes through ``scipy.signal.oaconvolve``
(`dsptoolbox/classes/filter_helpers.py:454-503`). On a device a single large
real FFT multiply is the fast path for offline filtering (XLA's FFT is
batched and fused); a partitioned overlap-save variant backs the streaming
runtime (`dsptoolbox_jax.realtime`). Shapes are static so padded FFT lengths
are compile-time constants.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from scipy.fft import next_fast_len as _scipy_next_fast_len


def next_fast_len(n: int, real: bool = True) -> int:
    """Padded FFT length for convolution, tuned per backend.

    The choice is mathematically invisible (any length >= the linear size is
    exact); only speed differs. Off the CPU the length is the smaller of
    {2^k, 3*2^k} >= n; on the CPU it is scipy's 5-smooth fast length.
    """
    if jax.default_backend() == "cpu":
        return int(_scipy_next_fast_len(int(n), real))
    pow2 = 1 << max(0, int(n) - 1).bit_length()
    three = 3
    while three < n:
        three <<= 1
    return min(pow2, three)


@jax.named_scope("dsptb.fft_convolve")
def fft_convolve(
    x: jnp.ndarray,
    h: jnp.ndarray,
    mode: str = "full",
) -> jnp.ndarray:
    """Linear convolution of ``x (..., T)`` with ``h (..., K)`` on the last axis.

    Broadcasting across leading axes. ``mode`` in {"full", "same", "valid"}
    with scipy semantics.
    """
    T = x.shape[-1]
    K = h.shape[-1]
    n_full = T + K - 1
    complex_path = jnp.iscomplexobj(x) or jnp.iscomplexobj(h)
    # Short real kernels (K <= 256) off the CPU: direct
    # conv_general_dilated, K multiply-adds per output sample; longer or
    # complex kernels and the CPU take the FFT product.
    if (
        not complex_path
        and h.ndim == 1
        and 1 < K <= 256
        and T >= 4 * K
        and jax.default_backend() != "cpu"
    ):
        xb = x.reshape((-1, 1, T))  # (N, C=1, T)
        hb = jnp.flip(h, -1).reshape((1, 1, K)).astype(xb.dtype)
        # HIGHEST keeps the conv in full fp32 — the default may run in
        # TF32/bf16 (~1e-3..1e-2 relative error).
        y = jax.lax.conv_general_dilated(
            xb,
            hb,
            window_strides=(1,),
            padding=[(K - 1, K - 1)],
            precision=jax.lax.Precision.HIGHEST,
        )
        y = y.reshape(x.shape[:-1] + (n_full,))
        if mode == "full":
            return y
        if mode == "same":
            start = (K - 1) // 2
            return y[..., start : start + T]
        if mode == "valid":
            n_valid = max(T, K) - min(T, K) + 1
            start = min(T, K) - 1
            return y[..., start : start + n_valid]
        raise ValueError(f"Unknown convolution mode: {mode!r}")
    if complex_path:
        nfft = next_fast_len(n_full, real=False)
        X = jnp.fft.fft(x, n=nfft, axis=-1)
        H = jnp.fft.fft(h, n=nfft, axis=-1)
        y = jnp.fft.ifft(X * H, n=nfft, axis=-1)[..., :n_full]
    else:
        nfft = next_fast_len(n_full, real=True)
        X = jnp.fft.rfft(x, n=nfft, axis=-1)
        H = jnp.fft.rfft(h, n=nfft, axis=-1)
        y = jnp.fft.irfft(X * H, n=nfft, axis=-1)[..., :n_full]
    if mode == "full":
        return y
    if mode == "same":
        start = (K - 1) // 2
        return y[..., start : start + T]
    if mode == "valid":
        n_valid = max(T, K) - min(T, K) + 1
        start = min(T, K) - 1
        return y[..., start : start + n_valid]
    raise ValueError(f"Unknown convolution mode: {mode!r}")


def fft_correlate(x: jnp.ndarray, y: jnp.ndarray, mode: str = "full"):
    """Cross-correlation along the last axis via FFT (scipy.correlate order:
    ``convolve(x, flip(conj(y)))``)."""
    return fft_convolve(x, jnp.flip(jnp.conj(y), axis=-1), mode=mode)


@jax.named_scope("dsptb.upfirdn")
def upfirdn(
    h: np.ndarray,
    x: jnp.ndarray,
    up: int = 1,
    down: int = 1,
) -> jnp.ndarray:
    """Upsample ``up``, FIR filter with ``h``, downsample ``down``.

    Matches ``scipy.signal.upfirdn`` output length
    ``ceil(((T-1)*up + K) / down)`` on the last axis of ``x (..., T)``.
    """
    T = x.shape[-1]
    K = len(h)
    if up > 1:
        # zero-stuffing: (..., T, up) -> (..., T*up)
        z = jnp.zeros(x.shape + (up,), dtype=x.dtype)
        z = z.at[..., 0].set(x)
        x = z.reshape(x.shape[:-1] + (T * up,))
    y = fft_convolve(x, jnp.asarray(h, dtype=x.dtype), mode="full")
    n_out = int(np.ceil(((T - 1) * up + K) / down))
    return y[..., ::down][..., :n_out]


@jax.named_scope("dsptb.resample_poly")
def resample_poly(
    x: jnp.ndarray,
    up: int,
    down: int,
    beta: float = 5.0,
) -> jnp.ndarray:
    """Polyphase resampling matching ``scipy.signal.resample_poly`` defaults
    (kaiser(5.0) anti-alias filter, ``padtype='constant'`` zero padding).

    Used by `standard.resampling.resample` — reference
    `dsptoolbox/standard/resampling.py:9`.
    """
    from math import gcd

    g = gcd(int(up), int(down))
    up = int(up) // g
    down = int(down) // g
    if up == down == 1:
        return x
    T = x.shape[-1]
    n_out = (T * up) // down + (1 if (T * up) % down else 0)

    # anti-aliasing FIR identical to scipy's internal design
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    from scipy.signal import firwin

    h = firwin(2 * half_len + 1, f_c, window=("kaiser", beta))
    h = h * up

    # scipy zero-pads so the filter's group delay lands on output sample 0
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while (
        int(np.ceil(((T - 1) * up + len(h) + n_pre_pad + n_post_pad) / down))
        < n_out + n_pre_remove
    ):
        n_post_pad += 1
    h_full = np.concatenate(
        [np.zeros(n_pre_pad), h, np.zeros(n_post_pad)]
    )
    y = upfirdn(h_full, x, up, down)
    return y[..., n_pre_remove : n_pre_remove + n_out]
