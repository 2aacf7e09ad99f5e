"""Differentiable DSP: traced filter design + filtering for gradient-based fitting.

The reference library designs filters from closed-form parameters and can only
*apply* them (`dsptoolbox/classes/filter_helpers.py:20-105`,
`classes/filter.py:143`). Because this framework's data path is JAX, the same
operators can also be *differentiated*: every function here keeps the filter
coefficients as traced `jnp` values, so `jax.grad` flows from a loss on the
filtered signal (or on a frequency response) back to the design parameters.
That enables gradient-based EQ matching, IR approximation, and
perceptually-weighted filter fitting — none of which the numpy reference can
express.

Contents
--------
- `biquad_coefficients_diff`: RBJ cookbook biquads with traced
  (frequency, gain, Q) — same conventions as
  `classes.filter_helpers.biquad_coefficients` (verified by tests).
- `sosfreqz_diff`: complex frequency response of a traced SOS cascade.
- `sosfilt_diff`: time-domain SOS filtering with traced coefficients via the
  same TDF2 associative-scan recurrence as `ops.iir` (log-depth over time,
  parallel over batch), so it runs on a device and is reverse-mode
  differentiable in O(T log T) memory via the scan's native VJP.
- `fit_sos_to_magnitude`: a small optax-free (plain SGD/Adam) fitting loop
  kept here so the capability is usable without extra deps; tests use it to
  recover known EQ parameters.

Everything is fp32-on-device like the rest of the package; fitting problems
are tiny (S sections × 3 params), so no f64 host fallback is needed.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..standard.enums import BiquadEqType
from .iir import linear_recurrence


def biquad_coefficients_diff(
    eq_type: BiquadEqType,
    fs_hz: int,
    frequency_hz: jnp.ndarray,
    gain_db: jnp.ndarray,
    q: jnp.ndarray,
) -> jnp.ndarray:
    """RBJ biquad coefficients with traced parameters.

    Returns an ``sos (..., 6)`` row (normalized so ``a0 == 1``) broadcast over
    the common shape of the three parameters. Matches
    `classes.filter_helpers.biquad_coefficients` (including the reference's
    convention that the linear gain multiplies the numerator of every type —
    `dsptoolbox/classes/filter_helpers.py:30-44`) but is differentiable w.r.t.
    ``frequency_hz``, ``gain_db`` and ``q``.

    Only the second-order types are supported here (the first-order and
    Inverter types have a degenerate third coefficient and are rarely fitting
    targets); use the host designer for those.
    """
    frequency_hz, gain_db, q = jnp.broadcast_arrays(
        jnp.asarray(frequency_hz, jnp.float32),
        jnp.asarray(gain_db, jnp.float32),
        jnp.asarray(q, jnp.float32),
    )
    shelf_like = eq_type in (
        BiquadEqType.Peaking,
        BiquadEqType.Lowshelf,
        BiquadEqType.Highshelf,
    )
    A = 10.0 ** (gain_db / (40.0 if shelf_like else 20.0))
    Omega = 2.0 * jnp.pi * frequency_hz / fs_hz
    sn, cs = jnp.sin(Omega), jnp.cos(Omega)
    alpha = sn / (2.0 * q)
    sqA = jnp.sqrt(A)
    if eq_type == BiquadEqType.Peaking:
        b = jnp.stack([1 + alpha * A, -2 * cs, 1 - alpha * A], axis=-1)
        a = jnp.stack([1 + alpha / A, -2 * cs, 1 - alpha / A], axis=-1)
    elif eq_type == BiquadEqType.Lowpass:
        b = jnp.stack(
            [(1 - cs) / 2 * A, (1 - cs) * A, (1 - cs) / 2 * A], axis=-1
        )
        a = jnp.stack([1 + alpha, -2 * cs, 1 - alpha], axis=-1)
    elif eq_type == BiquadEqType.Highpass:
        b = jnp.stack(
            [(1 + cs) / 2 * A, -(1 + cs) * A, (1 + cs) / 2 * A], axis=-1
        )
        a = jnp.stack([1 + alpha, -2 * cs, 1 - alpha], axis=-1)
    elif eq_type == BiquadEqType.BandpassSkirt:
        b = jnp.stack([sn / 2 * A, jnp.zeros_like(A), -sn / 2 * A], axis=-1)
        a = jnp.stack([1 + alpha, -2 * cs, 1 - alpha], axis=-1)
    elif eq_type == BiquadEqType.BandpassPeak:
        b = jnp.stack([alpha * A, jnp.zeros_like(A), -alpha * A], axis=-1)
        a = jnp.stack([1 + alpha, -2 * cs, 1 - alpha], axis=-1)
    elif eq_type == BiquadEqType.Notch:
        b = jnp.stack([A, -2 * cs * A, A], axis=-1)
        a = jnp.stack([1 + alpha, -2 * cs, 1 - alpha], axis=-1)
    elif eq_type == BiquadEqType.Allpass:
        b = jnp.stack(
            [(1 - alpha) * A, -2 * cs * A, (1 + alpha) * A], axis=-1
        )
        a = jnp.stack([1 + alpha, -2 * cs, 1 - alpha], axis=-1)
    elif eq_type == BiquadEqType.Lowshelf:
        b = jnp.stack(
            [
                A * ((A + 1) - (A - 1) * cs + 2 * sqA * alpha),
                2 * A * ((A - 1) - (A + 1) * cs),
                A * ((A + 1) - (A - 1) * cs - 2 * sqA * alpha),
            ],
            axis=-1,
        )
        a = jnp.stack(
            [
                (A + 1) + (A - 1) * cs + 2 * sqA * alpha,
                -2 * ((A - 1) + (A + 1) * cs),
                (A + 1) + (A - 1) * cs - 2 * sqA * alpha,
            ],
            axis=-1,
        )
    elif eq_type == BiquadEqType.Highshelf:
        b = jnp.stack(
            [
                A * ((A + 1) + (A - 1) * cs + 2 * sqA * alpha),
                -2 * A * ((A - 1) + (A + 1) * cs),
                A * ((A + 1) + (A - 1) * cs - 2 * sqA * alpha),
            ],
            axis=-1,
        )
        a = jnp.stack(
            [
                (A + 1) - (A - 1) * cs + 2 * sqA * alpha,
                2 * ((A - 1) - (A + 1) * cs),
                (A + 1) - (A - 1) * cs - 2 * sqA * alpha,
            ],
            axis=-1,
        )
    else:
        raise ValueError(
            f"{eq_type} is not supported by the differentiable designer"
        )
    a0 = a[..., :1]
    return jnp.concatenate([b / a0, a / a0], axis=-1)


def sosfreqz_diff(
    sos: jnp.ndarray, freqs_hz: jnp.ndarray, fs_hz: int
) -> jnp.ndarray:
    """Complex response of a traced SOS cascade at arbitrary frequencies.

    ``sos (..., S, 6)``, ``freqs_hz (F,)`` → ``H (..., F)`` complex64.
    Differentiable w.r.t. ``sos`` (and through it the design parameters).
    """
    sos = jnp.asarray(sos)
    w = 2.0 * jnp.pi * jnp.asarray(freqs_hz, jnp.float32) / fs_hz
    z1 = jnp.exp(-1j * w.astype(jnp.complex64))  # (F,)
    z = jnp.stack([jnp.ones_like(z1), z1, z1 * z1], axis=-1)  # (F, 3)
    b = sos[..., :3].astype(jnp.complex64)
    a = sos[..., 3:].astype(jnp.complex64)
    _hi = jax.lax.Precision.HIGHEST  # fp32 products, not TF32/bf16
    num = jnp.einsum("...sc,fc->...sf", b, z, precision=_hi)
    den = jnp.einsum("...sc,fc->...sf", a, z, precision=_hi)
    return jnp.prod(num / den, axis=-2)


def sosfreqz_host(
    sos, freqs_hz, fs_hz: int
) -> np.ndarray:
    """Host-facing `sosfreqz_diff`: returns a complex numpy array.

    `sosfreqz_diff` is a traced builder meant to live inside a jitted loss;
    called eagerly on backends where eager complex ops / complex host
    transfers are unavailable (see `_config.run_jitted_complex`) it fails.
    This wrapper runs it as one jitted program with complex-safe transfer.
    """
    from .._config import run_jitted_complex

    f = np.asarray(freqs_hz, np.float32)
    return np.asarray(
        run_jitted_complex(
            lambda s: sosfreqz_diff(s, jnp.asarray(f), fs_hz),
            np.asarray(sos, np.float32),
        )
    )


def _tdf2_system_traced(b: jnp.ndarray, a: jnp.ndarray):
    """Traced TDF2 companion form for one normalized biquad (a0 == 1).

    Mirrors `ops.iir._tdf2_system` for N == 2 but keeps everything as jnp so
    gradients flow to the coefficients.
    """
    A = jnp.stack(
        [
            jnp.stack([-a[..., 1], jnp.ones_like(a[..., 1])], axis=-1),
            jnp.stack([-a[..., 2], jnp.zeros_like(a[..., 2])], axis=-1),
        ],
        axis=-2,
    )  # (..., 2, 2)
    Bvec = jnp.stack(
        [
            b[..., 1] - a[..., 1] * b[..., 0],
            b[..., 2] - a[..., 2] * b[..., 0],
        ],
        axis=-1,
    )  # (..., 2)
    return A, Bvec, b[..., 0]


def sosfilt_diff(sos: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """SOS filtering of ``x (..., T)`` with traced coefficients ``sos (S, 6)``.

    Numerically matches ``scipy.signal.sosfilt`` (zero initial state) like
    `ops.iir.sosfilt`, but the coefficients stay inside the trace:
    ``jax.grad`` w.r.t. ``sos`` (or upstream design parameters) works. Uses
    the log-depth associative-scan recurrence per section — slower than the
    blocked static-operator kernel used for inference, so reserve this path
    for fitting loops.
    """
    sos = jnp.asarray(sos, jnp.float32)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6), got {sos.shape}")
    a0 = sos[:, 3:4]
    sos = sos / a0
    y = x
    for s_idx in range(sos.shape[0]):
        b, a = sos[s_idx, :3], sos[s_idx, 3:]
        A, Bvec, b0 = _tdf2_system_traced(b, a)
        xt = jnp.moveaxis(y, -1, 0)  # (T, ...)
        Bx = xt[..., None] * Bvec  # (T, ..., 2)
        s = linear_recurrence(A, Bx)  # (T, ..., 2)
        s0_shifted = jnp.concatenate(
            [jnp.zeros_like(s[:1, ..., 0]), s[:-1, ..., 0]], axis=0
        )
        y = jnp.moveaxis(b0 * xt + s0_shifted, 0, -1)
    return y


def fit_sos_to_magnitude(
    make_sos: Callable[[jnp.ndarray], jnp.ndarray],
    params0: jnp.ndarray,
    target_mag_db: jnp.ndarray,
    freqs_hz: jnp.ndarray,
    fs_hz: int,
    steps: int = 200,
    lr: float = 0.05,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fit design parameters so the SOS magnitude matches a dB target.

    ``make_sos(params) -> (S, 6)`` is a user-supplied traced designer (e.g.
    stacked `biquad_coefficients_diff` rows). Runs Adam entirely on device
    as one jitted program (the whole `lax.scan` optimization loop compiles
    once per call-site closure); returns ``(params, loss_history)``.
    """
    target = jnp.asarray(target_mag_db, jnp.float32)
    freqs = jnp.asarray(freqs_hz, jnp.float32)

    def loss_fn(params):
        H = sosfreqz_diff(make_sos(params), freqs, fs_hz)
        # |H|^2 + eps inside the log keeps the VJP finite when the response
        # grid hits a true zero (grad of abs() is NaN at 0).
        mag_db = 10.0 * jnp.log10(H.real**2 + H.imag**2 + 1e-24)
        return jnp.mean((mag_db - target) ** 2)

    grad_fn = jax.value_and_grad(loss_fn)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(carry, i):
        params, m, v = carry
        loss, g = grad_fn(params)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (i + 1.0))
        vh = v / (1 - b2 ** (i + 1.0))
        params = params - lr * mh / (jnp.sqrt(vh) + eps)
        return (params, m, v), loss

    p0 = jnp.asarray(params0, jnp.float32)

    @jax.jit
    def _run(p0):
        return jax.lax.scan(
            step,
            (p0, jnp.zeros_like(p0), jnp.zeros_like(p0)),
            jnp.arange(steps, dtype=jnp.float32),
        )

    (params, _, _), losses = _run(p0)
    return params, losses
