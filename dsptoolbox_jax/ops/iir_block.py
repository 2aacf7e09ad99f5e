"""Blocked IIR filtering: the device fast path for sosfilt/lfilter.

A per-sample IIR recursion maps badly onto a data-parallel accelerator, and
even the log-depth associative scan (see `ops.iir`) compiles to hundreds of
small kernels. The formulation here is *exact block processing*: for an
LTI system in state-space form (A, B, C, D),

    y[n]  = sum_{k<=n} h[n-k] x[k]  +  C A^n s_prev          (within a block)
    s_end = A^L s_prev + sum_k A^{L-1-k} B x[k]

so a whole block of L samples is two matmuls against *static* matrices
(the L×L lower-triangular Toeplitz of the impulse response — exact within the
block, no truncation — plus the state propagation/injection operators), and
the sequence of blocks is one `lax.scan` carrying the N-dim state. One
compiled while loop, a few matmuls per step: seconds to compile, runs at
matmul speed.

The SOS cascade is composed host-side (float64) into one state-space whose
state vector is the concatenation of the per-section scipy TDF2 states, so
``zi``/``zf`` keep scipy's ``(S, 2)`` layout exactly.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

_HIGH = jax.lax.Precision.HIGHEST


def _tdf2_abcd(b: np.ndarray, a: np.ndarray):
    """Transposed direct-form II state-space (A, B, C, D) of normalized ba —
    the state convention of scipy's ``lfilter``/``sosfilt`` zi."""
    dtype = (
        np.complex128
        if (np.iscomplexobj(b) or np.iscomplexobj(a))
        else np.float64
    )
    b = np.atleast_1d(np.asarray(b, dtype=dtype))
    a = np.atleast_1d(np.asarray(a, dtype=dtype))
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    N = max(len(a), len(b)) - 1
    bp = np.zeros(N + 1, dtype)
    ap = np.zeros(N + 1, dtype)
    bp[: len(b)] = b
    ap[: len(a)] = a
    A = np.zeros((N, N), dtype)
    A[:, 0] = -ap[1:]
    A[: N - 1, 1:] = np.eye(N - 1)
    B = (bp[1:] - ap[1:] * bp[0])[:, None]
    C = np.zeros((1, N), dtype)
    C[0, 0] = 1.0
    D = np.array([[bp[0]]], dtype)
    return A, B, C, D


def _series_compose(systems):
    """Series-connect state-space systems, preserving member state order in
    the concatenated state vector."""
    A_c, B_c, C_c, D_c = systems[0]
    for A2, B2, C2, D2 in systems[1:]:
        n1 = A_c.shape[0]
        n2 = A2.shape[0]
        dtype = np.result_type(A_c.dtype, A2.dtype)
        A_new = np.zeros((n1 + n2, n1 + n2), dtype)
        A_new[:n1, :n1] = A_c
        A_new[n1:, n1:] = A2
        A_new[n1:, :n1] = B2 @ C_c
        B_new = np.vstack([B_c, B2 @ D_c])
        C_new = np.hstack([D2 @ C_c, C2])
        D_new = D2 @ D_c
        A_c, B_c, C_c, D_c = A_new, B_new, C_new, D_new
    return A_c, B_c, C_c, D_c


def _sos_abcd(sos: np.ndarray):
    return _series_compose([_tdf2_abcd(sec[:3], sec[3:]) for sec in sos])


@lru_cache(maxsize=256)
def _block_operators(sos_key: tuple, L: int):
    """Static (HmatT (L,L), GyT (N,L), ALT (N,N), MT (L,N)) in float64:
    y_blk = x_blk @ HmatT + s @ GyT ;  s' = s @ ALT + x_blk @ MT."""
    sos = np.asarray(sos_key).reshape(-1, 6)
    if not np.iscomplexobj(sos):
        sos = sos.astype(np.float64)
    A, B, C, D = _sos_abcd(sos)
    dtype = A.dtype
    N = A.shape[0]
    powers = np.empty((L + 1, N, N), dtype)
    powers[0] = np.eye(N)
    for i in range(1, L + 1):
        powers[i] = powers[i - 1] @ A
    h = np.empty(L, dtype)
    h[0] = D[0, 0]
    for m in range(1, L):
        h[m] = (C @ powers[m - 1] @ B)[0, 0]
    Hmat = np.zeros((L, L), dtype)
    for m in range(L):
        np.fill_diagonal(Hmat[m:, : L - m], h[m])
    Gy = np.stack([(C @ powers[n])[0] for n in range(L)], axis=0)
    AL = powers[L]
    M = np.stack([(powers[L - 1 - k] @ B)[:, 0] for k in range(L)], axis=1)
    return Hmat.T, Gy.T, AL.T, M.T


@lru_cache(maxsize=256)
def _al_power_table(sos_key: tuple, L: int, n_blocks: int) -> np.ndarray:
    """Static table of AL^k (k = 0..n_blocks) in float64, AL = A^L of the
    composed cascade."""
    sos = np.asarray(sos_key).reshape(-1, 6)
    if not np.iscomplexobj(sos):
        sos = sos.astype(np.float64)
    A, _, _, _ = _sos_abcd(sos)
    AL = np.linalg.matrix_power(A, L)
    N = A.shape[0]
    out = np.empty((n_blocks + 1, N, N), A.dtype)
    out[0] = np.eye(N)
    for k in range(1, n_blocks + 1):
        out[k] = out[k - 1] @ AL
    return out


def _pick_block(T: int) -> int:
    # L trades the O(L) per-sample cost of the within-block Toeplitz matmul
    # against the log2(T / L) depth of the block-boundary doubling prefix.
    if T <= 128:
        return max(8, T)
    return 128


@jax.named_scope("dsptb.sosfilt_block")
def sosfilt_block(
    sos: np.ndarray,
    x: jnp.ndarray,
    zi: jnp.ndarray | None = None,
    block_size: int | None = None,
):
    """Blocked ``sosfilt`` over the last axis of ``x (..., T)``.

    Matches ``scipy.signal.sosfilt`` numerically, including the ``zi``/``zf``
    state layout ``(..., S, 2)``. Returns ``(y, zf)``.
    """
    sos = np.asarray(sos)
    sos = sos.astype(
        np.complex128 if np.iscomplexobj(sos) else np.float64
    )
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6), got {sos.shape}")
    S = sos.shape[0]
    N = 2 * S
    T = x.shape[-1]
    if T == 0:
        zf = (
            zi
            if zi is not None
            else jnp.zeros(x.shape[:-1] + (S, 2), x.dtype)
        )
        return x, zf
    L = block_size or _pick_block(T)
    L = min(L, T)
    key = tuple(sos.reshape(-1).tolist())
    compute_dtype = jnp.result_type(
        x.dtype, jnp.complex64 if np.iscomplexobj(sos) else x.dtype
    )
    x = x.astype(compute_dtype)
    HmatT, GyT, ALT, MT = (
        jnp.asarray(m, compute_dtype) for m in _block_operators(key, L)
    )

    n_full = T // L
    rem = T - n_full * L
    lead = x[..., : n_full * L]
    xb = jnp.moveaxis(
        lead.reshape(x.shape[:-1] + (n_full, L)), -2, 0
    )  # (n_full, ..., L)

    if zi is not None:
        s0 = jnp.asarray(zi, x.dtype).reshape(x.shape[:-1] + (N,))
    else:
        s0 = jnp.zeros(x.shape[:-1] + (N,), x.dtype)

    if n_full > 0:
        # Heavy, embarrassingly parallel part: within-block convolution and
        # input→state injections for ALL blocks as two batched matmuls.
        y_free = jnp.dot(xb, HmatT, precision=_HIGH)  # (n_blk, ..., L)
        v = jnp.dot(xb, MT, precision=_HIGH)  # (n_blk, ..., N)

        # Block-boundary state recurrence s_{k+1} = s_k @ ALT + v_k solved
        # with a log-depth doubling prefix (no sequential while loop):
        # X_k = sum_{j<=k} AL^{k-j} v_j via x_k += x_{k-2^t} @ (AL^{2^t})^T.
        X = v
        ALt_pow = ALT
        shift = 1
        while shift < n_full:
            Xs = jnp.concatenate(
                [jnp.zeros((shift,) + X.shape[1:], X.dtype), X[:-shift]],
                axis=0,
            )
            X = X + jnp.dot(Xs, ALt_pow, precision=_HIGH)
            ALt_pow = jnp.dot(ALt_pow, ALt_pow, precision=_HIGH)
            shift *= 2

        # Homogeneous part AL^k s0 from a static host-side power table.
        pow_table = _al_power_table(key, L, n_full)  # (n_full+1, N, N)
        powT = jnp.asarray(np.swapaxes(pow_table, -1, -2), x.dtype)
        hom = jnp.einsum(
            "...n,knm->k...m", s0, powT, precision=_HIGH
        )  # (n_full+1, ..., N)

        # state entering block k: s0 for k=0, else AL^k s0 + X_{k-1}
        s_starts = hom[:n_full].at[1:].add(X[:-1])
        s_end = hom[n_full] + X[n_full - 1]

        # State contribution to every block output: one batched matmul.
        y = y_free + jnp.dot(s_starts, GyT, precision=_HIGH)
        y = jnp.moveaxis(y, 0, -2).reshape(x.shape[:-1] + (n_full * L,))
    else:
        s_end = s0
        y = jnp.zeros(x.shape[:-1] + (0,), x.dtype)

    if rem:
        Hr, Gr, Ar, Mr = (
            jnp.asarray(m, compute_dtype)
            for m in _block_operators(key, rem)
        )
        x_tail = x[..., n_full * L :]
        y_tail = jnp.dot(x_tail, Hr, precision=_HIGH) + jnp.dot(
            s_end, Gr, precision=_HIGH
        )
        s_end = jnp.dot(s_end, Ar, precision=_HIGH) + jnp.dot(
            x_tail, Mr, precision=_HIGH
        )
        y = jnp.concatenate([y, y_tail], axis=-1)

    zf = s_end.reshape(x.shape[:-1] + (S, 2))
    return y, zf


@jax.named_scope("dsptb.lfilter_block")
def lfilter_block(
    b: np.ndarray,
    a: np.ndarray,
    x: jnp.ndarray,
    zi: jnp.ndarray | None = None,
    block_size: int | None = None,
):
    """Blocked ``lfilter`` (TDF2 state ``(..., N)``), same machinery with the
    single (b, a) system expressed as one pseudo-section when order ≤ 2, or
    a cascade via tf2sos otherwise (zi path requires order ≤ 2)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    order = max(len(a), len(b)) - 1
    if order <= 2:
        bp = np.zeros(3)
        ap = np.zeros(3)
        bp[: len(b)] = b
        ap[: len(a)] = a
        sos = np.concatenate([bp, ap])[None, :]
        zi2 = None
        if zi is not None:
            zi2 = jnp.zeros(x.shape[:-1] + (1, 2), x.dtype)
            zi2 = zi2.at[..., 0, :order].set(jnp.asarray(zi, x.dtype))
        y, zf = sosfilt_block(sos, x, zi=zi2, block_size=block_size)
        return y, zf[..., 0, :order]
    if zi is not None:
        raise NotImplementedError(
            "Blocked lfilter with initial state is limited to order <= 2; "
            "use ops.iir.lfilter for higher-order stateful filtering."
        )
    from scipy.signal import tf2sos

    y, _ = sosfilt_block(tf2sos(b, a), x, block_size=block_size)
    zf = jnp.zeros(x.shape[:-1] + (order,), x.dtype)
    return y, zf


def sosfilt_bank_operators(
    sos_bank: np.ndarray, T: int, block_size: int | None = None
):
    """Stacked block operators for a bank of same-order SOS cascades.

    ``sos_bank (B, S, 6)`` → dict of host f64 (or c128 for complex
    cascades, e.g. gammatone) arrays: HmatT (B,L,L), GyT (B,N,L),
    ALT (B,N,N), MT (B,L,N) plus the remainder-block variants. These are
    plain arrays, so they can be sharded across a device mesh
    (band/tensor parallelism) — see
    `dsptoolbox_jax.parallel.parallel_filterbank`.
    """
    sos_bank = np.asarray(sos_bank)
    sos_bank = sos_bank.astype(
        np.complex128 if np.iscomplexobj(sos_bank) else np.float64
    )
    assert sos_bank.ndim == 3 and sos_bank.shape[-1] == 6
    L = min(block_size or _pick_block(T), T)
    n_full = T // L
    rem = T - n_full * L
    ops = {"L": L, "n_full": n_full, "rem": rem}
    for name in ("HmatT", "GyT", "ALT", "MT"):
        ops[name] = []
    ops["rem_ops"] = [] if rem else None
    for b in range(sos_bank.shape[0]):
        key = tuple(sos_bank[b].reshape(-1).tolist())
        H, G, A, M = _block_operators(key, L)
        ops["HmatT"].append(H)
        ops["GyT"].append(G)
        ops["ALT"].append(A)
        ops["MT"].append(M)
        if rem:
            ops["rem_ops"].append(_block_operators(key, rem))
    for name in ("HmatT", "GyT", "ALT", "MT"):
        ops[name] = np.stack(ops[name])
    if rem:
        ops["rem_ops"] = [
            np.stack([band[i] for band in ops["rem_ops"]])
            for i in range(4)
        ]
    return ops


@jax.named_scope("dsptb.sosfilt_bank_apply")
def sosfilt_bank_apply(ops: dict, x: jnp.ndarray) -> jnp.ndarray:
    """Apply a bank of blocked SOS cascades to ``x (..., T)`` in one
    batched program → ``(B, ..., T)`` (zero initial state).

    Same math as `sosfilt_block` with a leading band axis: the per-block
    matmuls become band-batched einsums and the boundary-state recurrence
    keeps its log-depth doubling prefix.
    """
    compute_dtype = jnp.result_type(
        x.dtype,
        jnp.complex64 if np.iscomplexobj(ops["HmatT"]) else x.dtype,
    )
    x = x.astype(compute_dtype)
    HmatT = jnp.asarray(ops["HmatT"], compute_dtype)  # (B, L, L)
    GyT = jnp.asarray(ops["GyT"], compute_dtype)  # (B, N, L)
    MT = jnp.asarray(ops["MT"], compute_dtype)  # (B, L, N)
    L, n_full, rem = ops["L"], ops["n_full"], ops["rem"]
    T = x.shape[-1]
    assert n_full * L + rem == T, "operators were built for another length"

    lead = x[..., : n_full * L]
    xb = jnp.moveaxis(
        lead.reshape(x.shape[:-1] + (n_full, L)), -2, 0
    )  # (K, ..., L)

    if n_full > 0:
        y_free = jnp.einsum(
            "k...l,blm->bk...m", xb, HmatT, precision=_HIGH
        )  # (B, K, ..., L)
        X = jnp.einsum(
            "k...l,bln->bk...n", xb, MT, precision=_HIGH
        )  # (B, K, ..., N)
        ALt_pow = jnp.asarray(ops["ALT"], x.dtype)  # (B, N, N)
        shift = 1
        while shift < n_full:
            Xs = jnp.concatenate(
                [
                    jnp.zeros(X.shape[:1] + (shift,) + X.shape[2:], X.dtype),
                    X[:, :-shift],
                ],
                axis=1,
            )
            X = X + jnp.einsum(
                "bk...n,bnm->bk...m", Xs, ALt_pow, precision=_HIGH
            )
            ALt_pow = jnp.einsum(
                "bnm,bmp->bnp", ALt_pow, ALt_pow, precision=_HIGH
            )
            shift *= 2
        # zero initial state: block k sees X_{k-1} (zeros for k=0)
        s_starts = jnp.concatenate(
            [jnp.zeros_like(X[:, :1]), X[:, :-1]], axis=1
        )
        s_end = X[:, -1]  # (B, ..., N)
        y = y_free + jnp.einsum(
            "bk...n,bnl->bk...l", s_starts, GyT, precision=_HIGH
        )
        y = jnp.moveaxis(y, 1, -2).reshape(
            (y.shape[0],) + x.shape[:-1] + (n_full * L,)
        )
    else:
        s_end = jnp.zeros((HmatT.shape[0],) + x.shape[:-1] + (GyT.shape[1],), x.dtype)
        y = jnp.zeros((HmatT.shape[0],) + x.shape[:-1] + (0,), x.dtype)

    if rem:
        Hr, Gr, Ar, Mr = (jnp.asarray(m, x.dtype) for m in ops["rem_ops"])
        x_tail = x[..., n_full * L :]
        y_tail = jnp.einsum(
            "...l,blm->b...m", x_tail, Hr, precision=_HIGH
        ) + jnp.einsum("b...n,bnl->b...l", s_end, Gr, precision=_HIGH)
        y = jnp.concatenate([y, y_tail], axis=-1)
    return y
