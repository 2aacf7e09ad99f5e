"""Exact zero-state IIR filtering by frequency sampling.

For a stable LTI filter and zero initial state, the first T output samples
depend only on the first T samples of the impulse response. Sampling the
analytic transfer function on an FFT grid of length ``nfft ≥ T + margin``
(margin chosen from the slowest pole's decay) therefore reproduces
``scipy.signal.sosfilt`` on ``x[..., :T]`` to floating-point accuracy —
with two FFTs and one elementwise multiply instead of a sequential
recursion: the FFTs are XLA-native and bandwidth-bound, with no per-block
state chain.

Numerical core: each biquad factors into poles/zeros ``ρ·e^{jφ}``
(computed host-side in float64, static). A unit-circle sample of the
factor ``1 - ρ e^{jφ} e^{-jω}`` is evaluated as

    (1-ρ) + 2ρ·sin²(Δ/2)  +  j·ρ·sin(Δ),     Δ = ω − φ

whose real part is a SUM of non-negatives — no cancellation — so float32
device evaluation stays ~1e-7 accurate even for poles with 1-ρ ≈ 1e-4,
where naive polynomial evaluation of the denominator loses 3-4 digits.

Behavioral reference: `scipy.signal.sosfilt` as used by
`/root/reference/dsptoolbox/classes/filter_helpers.py:258` (zero-zi path)
and the gammatone bank at
`/root/reference/dsptoolbox/filterbanks/_filterbank.py:664-841`.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

_DECAY_EPS = 1e-9  # relative tail level the margin must reach
_MAX_POLE_RADIUS = 1.0 - 1e-6  # beyond this the margin explodes: fall back


@lru_cache(maxsize=512)
def _sos_factors(sos_key: tuple, shape: tuple):
    """Host-side float64 pole/zero factorization of an SOS cascade.

    Returns (gain complex, zeros (Z,) complex, poles (P,) complex) with
    exact conjugate pairing from np.roots per section.
    """
    sos = np.asarray(sos_key, dtype=np.complex128).reshape(shape)
    if np.allclose(sos.imag, 0.0):
        sos = sos.real.astype(np.float64)
    gain = 1.0 + 0.0j
    zeros, poles = [], []
    for sec in sos:
        b, a = sec[:3], sec[3:]
        if a[0] != 1.0:
            b = b / a[0]
            a = a / a[0]
        gain *= b[0] if b[0] != 0 else 1.0
        # roots of b0 + b1 z^-1 + b2 z^-2 = b0 (1 - q1 z^-1)(1 - q2 z^-1)
        if b[0] != 0:
            zeros.extend(np.roots(b))
        elif np.any(b != 0):
            # pure z^-1 factor(s): b1 z^-1 + b2 z^-2
            nz = np.trim_zeros(b, "f")
            gain *= nz[0]
            zeros.extend(np.roots(nz))
            # each leading zero coefficient contributes a delay z^-1 =
            # a zero at infinity; represent as extra pole at 0
            poles.extend([0.0] * (len(b) - len(nz)))
        poles.extend(np.roots(a))
    return (
        complex(gain),
        np.asarray(zeros, np.complex128),
        np.asarray(poles, np.complex128),
    )


def decay_margin(sos: np.ndarray, eps: float = _DECAY_EPS) -> int | None:
    """Samples until the slowest pole decays to ``eps``; None if the
    cascade is (numerically) marginally stable or unstable."""
    sos = np.asarray(sos)
    key = tuple(np.asarray(sos, np.complex128).reshape(-1).tolist())
    _, _, poles = _sos_factors(key, sos.shape)
    if poles.size == 0:
        return 0
    r = float(np.max(np.abs(poles)))
    if r >= _MAX_POLE_RADIUS:
        return None
    if r <= 1e-12:
        return 0
    n = int(np.ceil(np.log(eps) / np.log(r)))
    # repeated poles grow as n^(m-1) ρ^n before decaying; a 2x safety
    # factor covers every multiplicity that occurs in practice (the
    # gammatone's 4th-order pole included — verified against the f64
    # impulse response in tests)
    return 2 * n + 64


def _factor_eval(omega: jnp.ndarray, roots: np.ndarray):
    """prod_r (1 - r e^{-jω}) over the last axis of ``roots (..., R)``,
    evaluated cancellation-free in f32. ``omega (F,)`` f32."""
    rho = np.abs(roots)
    phi = np.angle(roots)
    one_minus_rho = (1.0 - rho).astype(np.float32)
    rho32 = rho.astype(np.float32)
    phi32 = phi.astype(np.float32)
    d = omega[..., None, :] - phi32[..., :, None]  # (..., R, F)
    s2 = jnp.sin(0.5 * d)
    re = one_minus_rho[..., :, None] + 2.0 * rho32[..., :, None] * s2 * s2
    im = rho32[..., :, None] * jnp.sin(d)
    fac = jax.lax.complex(re, im)
    return jnp.prod(fac, axis=-2)


def sos_freq_response(
    sos: np.ndarray, nfft: int, full_spectrum: bool
) -> jnp.ndarray:
    """Transfer function of the cascade on the length-``nfft`` DFT grid
    (``(nfft//2+1,)`` for real half-spectrum, ``(nfft,)`` for full),
    complex64, built inside the current trace from static pole/zero data.
    """
    sos = np.asarray(sos)
    key = tuple(np.asarray(sos, np.complex128).reshape(-1).tolist())
    gain, zeros, poles = _sos_factors(key, sos.shape)
    F = nfft if full_spectrum else nfft // 2 + 1
    omega = (2.0 * np.pi / nfft) * jnp.arange(F, dtype=jnp.float32)
    num = _factor_eval(omega, zeros) if zeros.size else 1.0
    den = _factor_eval(omega, poles) if poles.size else 1.0
    g = jnp.asarray(gain, jnp.complex64)
    return g * num / den


def sos_freq_response_host(
    sos: np.ndarray, nfft: int, full_spectrum: bool
) -> np.ndarray:
    """Host-f64 twin of :func:`sos_freq_response` (same cancellation-free
    factor formulation, numpy float64) → complex128 ``(F,)``.

    For responses that are INPUT-INDEPENDENT constants of a program
    (e.g. the LR crossover tree), evaluating on device per call wastes
    GFLOPs XLA will not constant-fold at these sizes; computing once on
    the host (cached) and baking the result in as a literal is both
    faster and more accurate (f64 vs f32 chained factors)."""
    sos = np.asarray(sos)
    key = tuple(np.asarray(sos, np.complex128).reshape(-1).tolist())
    return np.asarray(
        _freq_response_host_cached(key, sos.shape, int(nfft),
                                   bool(full_spectrum))
    )


@lru_cache(maxsize=64)
def _freq_response_host_cached(
    sos_key: tuple, shape: tuple, nfft: int, full_spectrum: bool
):
    gain, zeros, poles = _sos_factors(sos_key, shape)
    F = nfft if full_spectrum else nfft // 2 + 1
    omega = (2.0 * np.pi / nfft) * np.arange(F, dtype=np.float64)

    def feval(roots):
        rho = np.abs(roots)
        phi = np.angle(roots)
        d = omega[None, :] - phi[:, None]
        s2 = np.sin(0.5 * d)
        fac = (
            (1.0 - rho)[:, None]
            + 2.0 * rho[:, None] * s2 * s2
            + 1j * (rho[:, None] * np.sin(d))
        )
        return np.prod(fac, axis=0)

    num = feval(zeros) if zeros.size else 1.0
    den = feval(poles) if poles.size else 1.0
    return gain * num / den


def sos_bank_freq_response(
    sos_bank: np.ndarray, nfft: int, full_spectrum: bool
) -> jnp.ndarray:
    """Stacked responses for a bank ``(B, S, 6)`` → ``(B, F)`` complex64."""
    return jnp.stack(
        [
            sos_freq_response(sos_bank[b], nfft, full_spectrum)
            for b in range(sos_bank.shape[0])
        ]
    )


def _next_fast_len(n: int) -> int:
    # backend-aware: {2^k, 3·2^k} off the CPU, scipy's 5-smooth lengths
    # on the CPU
    from .fft_conv import next_fast_len

    return int(next_fast_len(int(n), real=True))


def plan_nfft(sos, T: int) -> int | None:
    """FFT length for exact zero-state filtering of length-T signals, or
    None when the margin is unusable (near-unstable poles or margin far
    beyond the signal length)."""
    m = decay_margin(sos)
    if m is None or m > 8 * T + 4096:
        return None
    return _next_fast_len(T + m)


@jax.named_scope("dsptb.sosfilt_freq")
def sosfilt_freq(
    sos: np.ndarray,
    x: jnp.ndarray,
    nfft: int | None = None,
):
    """Zero-state ``sosfilt`` over the last axis via frequency sampling.

    Matches ``scipy.signal.sosfilt(sos, x)`` (zero zi) to ~1e-6 relative.
    Complex cascades (e.g. gammatone sections) produce complex output,
    like scipy. Returns ``y`` only (no final state — this is the
    zero-state fast path; use `ops.iir_block.sosfilt_block` for zi/zf).
    """
    sos = np.asarray(sos)
    T = x.shape[-1]
    if nfft is None:
        nfft = plan_nfft(sos, T)
        if nfft is None:
            raise ValueError(
                "sosfilt_freq: cascade too close to instability for "
                "frequency sampling; use sosfilt_block"
            )
    complex_filter = np.iscomplexobj(sos)
    if complex_filter or jnp.iscomplexobj(x):
        H = sos_freq_response(sos, nfft, full_spectrum=True)
        X = jnp.fft.fft(x, n=nfft, axis=-1)
        y = jnp.fft.ifft(X * H, axis=-1)[..., :T]
        return y
    H = sos_freq_response(sos, nfft, full_spectrum=False)
    X = jnp.fft.rfft(x, n=nfft, axis=-1)
    return jnp.fft.irfft(X * H, n=nfft, axis=-1)[..., :T]


@jax.named_scope("dsptb.sosfilt_bank_freq")
def sosfilt_bank_freq(
    sos_bank: np.ndarray,
    x: jnp.ndarray,
    nfft: int | None = None,
):
    """Zero-state bank application ``(B, S, 6) × (..., T) → (B, ..., T)``
    via one shared forward FFT and a band-batched multiply + inverse FFT.
    """
    sos_bank = np.asarray(sos_bank)
    B = sos_bank.shape[0]
    T = x.shape[-1]
    if nfft is None:
        ms = [decay_margin(sos_bank[b]) for b in range(B)]
        if any(m is None for m in ms):
            raise ValueError("sosfilt_bank_freq: near-unstable band")
        m = max(ms)
        if m > 8 * T + 4096:
            raise ValueError("sosfilt_bank_freq: margin too large")
        nfft = _next_fast_len(T + m)
    complex_filter = np.iscomplexobj(sos_bank)

    def _expand(H):
        # (B, F) → (B, 1, ..., 1, F) so it broadcasts against X[None]
        return H.reshape((B,) + (1,) * (x.ndim - 1) + (H.shape[-1],))

    if complex_filter or jnp.iscomplexobj(x):
        H = sos_bank_freq_response(sos_bank, nfft, full_spectrum=True)
        X = jnp.fft.fft(x, n=nfft, axis=-1)
        return jnp.fft.ifft(X[None] * _expand(H), axis=-1)[..., :T]
    H = sos_bank_freq_response(sos_bank, nfft, full_spectrum=False)
    X = jnp.fft.rfft(x, n=nfft, axis=-1)
    return jnp.fft.irfft(X[None] * _expand(H), n=nfft, axis=-1)[..., :T]
