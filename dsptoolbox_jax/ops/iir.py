"""IIR filtering: linear recurrences as associative (parallel-prefix) scans.

The reference applies IIR filters through scipy's C loops
(`dsptoolbox/classes/filter_helpers.py:258-336` → `scipy.signal.sosfilt` /
`lfilter`). A per-sample feedback loop defeats vectorization, so here each
second-order section (and, for the ba path, each order-N direct form) is
rewritten as a linear state recurrence

    s[n] = A s[n-1] + B x[n],      y[n] = b0 x[n] + s_0[n-1]

(transposed direct-form II — the exact state convention of scipy's
``sosfilt``/``lfilter``), and the recurrence is evaluated with
`jax.lax.associative_scan` over time: O(log T) depth, fully parallel,
batched over channels/sections. Cascades run as a short sequential loop
of parallel scans.

All coefficient handling (design, zi steady states) is static/host-side;
only the data path runs on device.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np



def _affine_combine(a, b):
    """Compose affine maps s -> M s + v: fn(earlier, later) returns later∘earlier.

    The tiny matrix products are forced to full fp32 precision: at the
    default precision XLA may run them in TF32/bf16, which destroys parity
    with scipy (~1e-3..1e-2 relative error).
    """
    Ma, va = a
    Mb, vb = b
    M = jnp.matmul(Mb, Ma, precision=jax.lax.Precision.HIGHEST)
    v = (
        jnp.einsum("...ij,...j->...i", Mb, va, precision=jax.lax.Precision.HIGHEST)
        + vb
    )
    return M, v


def linear_recurrence(
    A: jnp.ndarray, Bx: jnp.ndarray, zi: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Evaluate ``s[n] = A @ s[n-1] + Bx[n]`` for all n via parallel prefix.

    Parameters
    ----------
    A : (N, N) constant transition matrix.
    Bx : (T, ..., N) per-step input injections.
    zi : (..., N) initial state ``s[-1]`` (defaults to zeros).

    Returns
    -------
    s : (T, ..., N) states ``s[0..T-1]``.
    """
    T = Bx.shape[0]
    M = jnp.broadcast_to(A, (T,) + Bx.shape[1:] + (A.shape[-1],))
    Ms, vs = jax.lax.associative_scan(_affine_combine, (M, Bx), axis=0)
    if zi is not None:
        vs = vs + jnp.einsum(
            "t...ij,...j->t...i", Ms, zi, precision=jax.lax.Precision.HIGHEST
        )
    return vs


def _tdf2_system(b: np.ndarray, a: np.ndarray):
    """Transposed direct-form II state-space (A, Bvec, b0) for normalized ba.

    State s (N,) with N = max(len(a), len(b)) - 1:
        y[n]   = b0 x[n] + s_0[n-1]
        s_i[n] = b_{i+1} x[n] - a_{i+1} y[n] + s_{i+1}[n-1]
    giving s[n] = A s[n-1] + Bvec x[n] with
        A[i, 0] = -a_{i+1};  A[i, i+1] = 1;  Bvec[i] = b_{i+1} - a_{i+1} b0.
    Matches scipy's ``lfilter``/``sosfilt`` zi convention.
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    N = max(len(a), len(b)) - 1
    bp = np.zeros(N + 1)
    ap = np.zeros(N + 1)
    bp[: len(b)] = b
    ap[: len(a)] = a
    A = np.zeros((N, N))
    A[:, 0] = -ap[1:]
    A[: N - 1, 1:] = np.eye(N - 1)
    Bvec = bp[1:] - ap[1:] * bp[0]
    return A, Bvec, bp[0]


def _apply_tdf2(
    x: jnp.ndarray,
    A: np.ndarray,
    Bvec: np.ndarray,
    b0: float,
    zi: jnp.ndarray | None,
):
    """Run one TDF2 stage over ``x (..., T)``. Returns (y, zf)."""
    dt = x.dtype
    T = x.shape[-1]
    xt = jnp.moveaxis(x, -1, 0)  # (T, ...)
    Bx = xt[..., None] * jnp.asarray(Bvec, dtype=dt)  # (T, ..., N)
    Aj = jnp.asarray(A, dtype=dt)
    if zi is not None:
        zi = jnp.broadcast_to(
            jnp.asarray(zi, dtype=dt), x.shape[:-1] + (A.shape[0],)
        )
    s = linear_recurrence(Aj, Bx, zi)  # (T, ..., N)
    s0_prev = s[:-1, ..., 0]
    first = (
        zi[..., 0]
        if zi is not None
        else jnp.zeros(x.shape[:-1], dtype=dt)
    )
    s0_shifted = jnp.concatenate([first[None], s0_prev], axis=0)
    y = jnp.asarray(b0, dtype=dt) * xt + s0_shifted
    return jnp.moveaxis(y, 0, -1), s[-1]


def lfilter(
    b: np.ndarray,
    a: np.ndarray,
    x: jnp.ndarray,
    zi: jnp.ndarray | None = None,
):
    """IIR/FIR direct-form filtering of ``x (..., T)`` along the last axis.

    Numerically matches ``scipy.signal.lfilter(b, a, x, zi=zi)`` (TDF2 state
    convention). Returns ``(y, zf)`` where ``zf (..., N)`` is the final state.

    For order > 2 with zero initial state, the filter is applied as a cascade
    of second-order sections (identical transfer function, designed host-side
    via ``tf2sos``): a high-order direct-form recursion amplifies fp32
    rounding beyond the 1e-5 parity budget, the biquad cascade does not. The
    direct form is kept for the streaming (``zi``) path, whose state layout
    is the scipy TDF2 convention.
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    order = max(len(a), len(b)) - 1
    if len(a) == 1 and zi is None and order > 2:
        # pure FIR without state: one FFT convolution
        from .fft_conv import fft_convolve

        h = jnp.asarray(b / a[0], dtype=x.dtype)
        y = fft_convolve(x, h)[..., : x.shape[-1]]
        return y, jnp.zeros(x.shape[:-1] + (order,), dtype=x.dtype)
    if order <= 2 or zi is None:
        from .iir_block import lfilter_block

        return lfilter_block(b, a, x, zi=zi)
    # high-order stateful path: associative scan on the TDF2 companion form
    A, Bvec, b0 = _tdf2_system(b, a)
    y, zf = _apply_tdf2(x, A, Bvec, b0, zi)
    return y, zf


def sosfilt(
    sos: np.ndarray,
    x: jnp.ndarray,
    zi: jnp.ndarray | None = None,
):
    """Second-order-sections filtering of ``x (..., T)``.

    Mirrors ``scipy.signal.sosfilt``: ``sos (S, 6)`` static host-side
    coefficients; ``zi (..., S, 2)`` optional initial state. Returns
    ``(y, zf)``.

    Dispatches to the blocked matmul formulation (`ops.iir_block`) — exact
    block processing via static matmuls, which compiles orders of magnitude
    faster than the associative scan. The associative-scan variant is
    kept as `sosfilt_assoc` for reference.
    """
    from .iir_block import sosfilt_block

    return sosfilt_block(sos, x, zi=zi)


# Below this many samples the FFT's fixed cost outweighs its bandwidth
# win.
_FREQ_MIN_T = 4096
# Upper bound for the frequency-sampling single-filter path: its padded
# FFT grows with the decay margin while the blocked chain's cost per
# sample stays flat.
_FREQ_MAX_T = 131072


def sosfilt_zero_state(sos: np.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Zero-state ``sosfilt`` returning ``y`` only, auto-dispatched.

    Long signals route to exact frequency sampling (`ops.iir_freq`): two
    FFTs instead of a block chain when no initial/final state is needed.
    Short signals, near-unstable cascades, or margins that would blow up
    the FFT length fall back to the blocked formulation (`ops.iir_block`).
    """
    from .iir_block import sosfilt_block

    T = x.shape[-1]
    if _FREQ_MIN_T <= T <= _FREQ_MAX_T:
        from .iir_freq import plan_nfft, sosfilt_freq

        nfft = plan_nfft(np.asarray(sos), T)
        if nfft is not None and nfft <= 4 * T:
            return sosfilt_freq(sos, x, nfft=nfft)
    return sosfilt_block(sos, x)[0]


def sosfilt_assoc(
    sos: np.ndarray,
    x: jnp.ndarray,
    zi: jnp.ndarray | None = None,
):
    """Associative-scan sosfilt (log-depth parallel prefix per section)."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6), got {sos.shape}")
    S = sos.shape[0]
    y = x
    zfs = []
    for s_idx in range(S):
        b, a = sos[s_idx, :3], sos[s_idx, 3:]
        sec_zi = zi[..., s_idx, :] if zi is not None else None
        A, Bvec, b0 = _tdf2_system(b, a)
        y, zf = _apply_tdf2(y, A, Bvec, b0, sec_zi)
        zfs.append(zf)
    return y, jnp.stack(zfs, axis=-2)


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state sosfilt initial conditions (host-side, scipy-equivalent).

    Returns ``(S, 2)``: the state such that a unit-step input produces a
    constant output from the first sample.
    """
    from scipy.signal import sosfilt_zi as _zi

    return np.asarray(_zi(np.asarray(sos, dtype=np.float64)))


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    from scipy.signal import lfilter_zi as _zi

    return np.asarray(_zi(b, a))


def _odd_ext(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Odd extension along the last axis (scipy.signal._arraytools.odd_ext)."""
    if n < 1:
        return x
    left = 2 * x[..., :1] - x[..., n:0:-1]
    right = 2 * x[..., -1:] - x[..., -2 : -(n + 2) : -1]
    return jnp.concatenate([left, x, right], axis=-1)


def sosfiltfilt(sos: np.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Zero-phase forward-backward SOS filtering, matching
    ``scipy.signal.sosfiltfilt`` (odd padding, steady-state zi scaling)."""
    sos = np.asarray(sos, dtype=np.float64)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    padlen = 3 * ntaps
    if x.shape[-1] <= padlen:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen="
            f"{padlen}."
        )
    zi0 = sosfilt_zi(sos)  # (S, 2)
    ext = _odd_ext(x, padlen)
    x0 = ext[..., :1]
    y, _ = sosfilt(sos, ext, zi=zi0 * x0[..., None])
    y = jnp.flip(y, axis=-1)
    y0 = y[..., :1]
    y, _ = sosfilt(sos, y, zi=zi0 * y0[..., None])
    y = jnp.flip(y, axis=-1)
    if padlen > 0:
        y = y[..., padlen:-padlen]
    return y


def filtfilt_ba(b: np.ndarray, a: np.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Zero-phase ba filtering matching ``scipy.signal.filtfilt`` defaults
    (odd padding, padlen = 3 * max(len(a), len(b)))."""
    b = np.atleast_1d(b)
    a = np.atleast_1d(a)
    padlen = 3 * max(len(a), len(b))
    if x.shape[-1] <= padlen:
        raise ValueError("Input too short for filtfilt padding")
    zi0 = lfilter_zi(b, a)  # (N,)
    ext = _odd_ext(x, padlen)
    x0 = ext[..., :1]
    y, _ = lfilter(b, a, ext, zi=zi0 * x0)
    y = jnp.flip(y, axis=-1)
    y0 = y[..., :1]
    y, _ = lfilter(b, a, y, zi=zi0 * y0)
    y = jnp.flip(y, axis=-1)
    return y[..., padlen:-padlen]
