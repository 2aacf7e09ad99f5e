"""Array-level room acoustics backend.

Behavioral reference: `dsptoolbox/room_acoustics/_room_acoustics.py`.

Device notes:
- The energy decay curve (cumulative backward integration) runs on device;
  the RT regression windows are data-dependent scalar fits done host-side on
  the (small) EDC.
- The image-source model replaces the reference's triple Python loop
  (`_room_acoustics.py:261-268`) with a single device scatter-add over the
  enumerated image lattice: all (2L+1)³×8 image distances and dampings are
  computed as one batched tensor expression, then accumulated with
  ``.at[idx].add``.
"""

from __future__ import annotations

from warnings import warn

import jax.numpy as jnp
import numpy as np

from ..helpers.gain_and_level import from_db, to_db
from ..helpers.other import pearson_correlation as _pearson
from ..helpers.smoothing import time_smoothing_host
from ..transfer_functions._backend import trim_ir_indices
from .enums import ReverbTime


def find_ir_start(ir: np.ndarray, threshold_dbfs: float = -20) -> int:
    """Last sample below threshold before the peak (ISO 3382;
    `_room_acoustics.py:88-115`). Host-side scalar search."""
    ir_abs = np.abs(np.asarray(ir))
    start_ir = int(np.argmax(ir_abs))
    threshold = ir_abs[start_ir] * float(
        from_db(-np.abs(threshold_dbfs), True)
    )
    for start_ir in range(start_ir, -1, -1):
        if ir_abs[start_ir] < threshold:
            break
    return start_ir


def complex_mode_identification(
    spectra: np.ndarray, maximum_singular_value: bool = True
) -> np.ndarray:
    """CMIF via batched SVD over frequency (`_room_acoustics.py:118-159`) —
    the reference's per-bin SVD loop becomes one vmapped device SVD."""
    spectra = np.asarray(spectra)
    n_rir = spectra.shape[1]
    if n_rir == 1:
        return np.abs(spectra.squeeze()) ** 2
    F = spectra.shape[0]
    H = np.zeros((F, n_rir, n_rir), dtype=np.complex128)
    H[:, 0, :] = spectra
    H[:, :, 0] = spectra
    s = np.asarray(
        jnp.linalg.svd(jnp.asarray(H, jnp.complex64), compute_uv=False)
    )
    if maximum_singular_value:
        return s.max(axis=-1)
    return s[:, 0]


def _polyfit_edc(time_vector, edc, start_value, end_value):
    """Linear fit between EDC levels (`_room_acoustics.py:1097-1138`)."""
    L = len(edc)
    edc_inverted = edc[::-1]
    i1 = L - np.searchsorted(edc_inverted, start_value)
    i2 = L - np.searchsorted(edc_inverted, end_value)
    coeff = np.polyfit(time_vector[i1:i2], edc[i1:i2], 1)
    r = _pearson(time_vector[i1:i2], edc[i1:i2])
    return coeff, r


def _best_linear_fit_for_edc(time_vector, edc, start_value, steps):
    """Best ending level by Pearson correlation
    (`_room_acoustics.py:1056-1095`)."""
    edc_inverted = edc[::-1]
    i1 = len(edc) - np.searchsorted(edc_inverted, start_value)
    rs = np.zeros(len(steps))
    for ind, step in enumerate(steps):
        i2 = len(edc) - np.searchsorted(edc_inverted, step)
        rs[ind] = _pearson(time_vector[i1:i2], edc[i1:i2])
    ind_min = int(np.argmin(rs))
    return steps[ind_min], rs[ind_min]


def _optimal_reverb_time(time_vector, edc):
    """Adaptive RT (REW Topt style; `_room_acoustics.py:999-1054`)."""
    coeff_edt = _polyfit_edc(time_vector, edc, 0, -10)[0]
    coeff_t30 = _polyfit_edc(time_vector, edc, -5, -35)[0]
    very_short_edt = (-6 * 10 / coeff_edt[0]) * 10 < -60 / coeff_t30[0]
    if very_short_edt:
        x_int = (coeff_edt[1] - coeff_t30[1]) / (
            coeff_t30[0] - coeff_edt[0]
        )
        start = float(np.polyval(coeff_edt, [x_int]).squeeze())
    else:
        start = -5.0
    steps = np.arange(start - 20, start - 60, -1)
    end, r = _best_linear_fit_for_edc(time_vector, edc, start, steps)
    if r > -0.95:
        warn(
            f"Correlation coefficient for reverb computation is {r} "
            "(larger than -0.95). Computation might be invalid. "
            "-1 is the ideal value."
        )
    coefficients = _polyfit_edc(time_vector, edc, start, end)[0]
    return 60 / np.abs(coefficients[0]), r


def compute_energy_decay_curve(
    time_data: np.ndarray, trim_automatically: bool, fs_hz: int
) -> np.ndarray:
    """EDC with Chu noise correction and Lundeby compensation energy
    (`_room_acoustics.py:1140-1222`). Cumsum/smoothing on device."""
    time_data = np.asarray(time_data).reshape(-1)
    if trim_automatically:
        _, stopping_index, _ = trim_ir_indices(
            time_data, fs_hz, offset_start_s=1e-3
        )
    else:
        stopping_index = len(time_data)
    start_index = find_ir_start(time_data)
    if stopping_index != len(time_data):
        noise_power = np.var(time_data[stopping_index:])
    else:
        noise_power = np.var(time_data[:start_index])

    signal_power = time_data[start_index:stopping_index] ** 2.0
    dynamic_range_db = (
        float(to_db(np.max(signal_power) / noise_power, False)) / 2.0
    )
    # host EMA: the data is already host-side decision input, so no
    # device round trip
    signal_db = np.asarray(
        to_db(time_smoothing_host(signal_power, fs_hz, 20e-3), False)
    )
    start_index_int = np.where(
        dynamic_range_db + np.min(signal_db) > signal_db
    )[0][0]
    time_vector = np.linspace(
        0, len(signal_power) / fs_hz, len(signal_power)
    )
    p = np.polyfit(
        time_vector[start_index_int:], signal_db[start_index_int:], 1
    )
    avoid_corrections = p[1] >= 0.0
    B = float(from_db(p[0], False))
    t_1 = (float(to_db(noise_power, False)) - p[0]) / p[1]
    avoid_corrections |= t_1 <= 0.0
    with np.errstate(all="ignore"):
        A = np.log(noise_power / B) / t_1
        e_comp = -B / A * np.exp(A * t_1)

    signal_power = signal_power - noise_power
    e_comp *= fs_hz
    cums = np.cumsum(signal_power)
    edc = np.sum(signal_power) + e_comp - cums
    indices = np.where(edc <= 0)[0]
    if len(indices) > 0:
        avoid_corrections |= indices[0] <= int(30e-3 * fs_hz + 0.5)
        if not avoid_corrections:
            edc = edc[: indices[0]]
    if avoid_corrections or not np.isfinite(edc).all():
        signal_power = signal_power + noise_power
        length = int(len(signal_power) * 0.95)
        edc = (
            np.sum(signal_power)
            - np.cumsum(signal_power)[:length]
        )
    edc = np.asarray(to_db(edc, False))
    return edc - edc[0]


def reverb(
    h: np.ndarray,
    fs_hz: int,
    mode: ReverbTime,
    ir_start: int | None,
    return_ir_start: bool,
    automatic_trimming: bool,
):
    """Reverberation time of one channel (`_room_acoustics.py:17-85`)."""
    edc = compute_energy_decay_curve(h, automatic_trimming, fs_hz)
    time_vector = np.linspace(0, len(edc) / fs_hz, len(edc))
    if mode == ReverbTime.Adaptive:
        time, corr = _optimal_reverb_time(time_vector, edc)
        if return_ir_start:
            return time, corr, ir_start
        return time, corr
    bounds = {
        ReverbTime.T20: (-5, -25),
        ReverbTime.T30: (-5, -35),
        ReverbTime.T60: (-5, -65),
        ReverbTime.EDT: (0, -10),
    }
    if mode not in bounds:
        raise ValueError("Supported modes are only T20, T30, T60 and EDT")
    p, corr = _polyfit_edc(time_vector, edc, *bounds[mode])
    factor = 60 if mode != ReverbTime.EDT else 10
    if return_ir_start:
        return (factor / np.abs(p[0])), corr, ir_start
    return factor / np.abs(p[0]), corr


_U_VECTORS = np.array(
    [
        [0, 0, 0],
        [0, 0, 1],
        [0, 1, 0],
        [1, 0, 0],
        [0, 1, 1],
        [1, 0, 1],
        [1, 1, 0],
        [1, 1, 1],
    ],
    dtype=np.float64,
)  # (8, 3)

_LATER = np.triu(np.ones((8, 8), dtype=bool), 1)


def _host_group_images(lv, room_dim, beta_1, beta_2, s_pos, r_pos, sr, c):
    """f64 image math for a set of lattice rows ``lv (m, 3)``: returns
    flat (idx, vals) with the reference's duplicate-drop semantics
    (`_room_acoustics.py:259-268`: within one cell's 8 images, numpy fancy
    indexing makes the LAST duplicate win) already applied."""
    pos = (
        (1 - 2 * _U_VECTORS)[None, :, :] * s_pos
        + (2 * lv * room_dim)[:, None, :]
        - r_pos
    )
    dist = np.sqrt(np.sum(pos**2, axis=-1))  # (m, 8)
    diff = np.abs(lv[:, None, :] - _U_VECTORS[None, :, :])
    damp = np.prod(beta_1**diff, axis=-1) * np.prod(
        beta_2 ** np.abs(lv), axis=-1
    )[:, None]
    vals = damp / (4 * np.pi * dist)
    idx = (dist / c * sr + 0.5).astype(np.int64)  # truncation, like ref
    eq = idx[:, :, None] == idx[:, None, :]  # (m, 8, 8)
    dropped = (eq & _LATER).any(axis=2)  # earlier duplicate → dropped
    vals = np.where(dropped, 0.0, vals)
    return idx.reshape(-1), np.nan_to_num(vals.reshape(-1))


def _generate_rir_host(
    room_dim, beta_1, beta_2, s_pos, r_pos, sr, c, LIMIT, total_length
) -> np.ndarray:
    """Oracle path: f64 host image math + device scatter-add.

    The sample index comes from truncating ``dist/c*sr + 0.5`` and fp32
    distances flip bins near the .5 boundary, so this path keeps every
    index decision in f64 — it is the parity reference for the device
    path below. Chunked: the full (M, 8, 8) temporaries would be
    multi-GB for long reverberation times (LIMIT ~ 80 → M ≈ 4.5M)."""
    grid = np.arange(-LIMIT, LIMIT + 1, dtype=np.float64)
    ll, mm, nn = np.meshgrid(grid, grid, grid, indexing="ij")
    lvecs = np.stack(
        [ll.reshape(-1), mm.reshape(-1), nn.reshape(-1)], axis=1
    )
    rir = jnp.zeros(total_length, jnp.float32)
    CHUNK = 1 << 17
    M = lvecs.shape[0]
    for i0 in range(0, M, CHUNK):
        idx, vals = _host_group_images(
            lvecs[i0 : i0 + CHUNK], room_dim, beta_1, beta_2,
            s_pos, r_pos, sr, c,
        )
        rir = rir.at[jnp.asarray(idx)].add(
            jnp.asarray(vals, jnp.float32), mode="drop"
        )
    return np.asarray(rir, dtype=np.float64)


# ---- double-single (two-float) helpers -------------------------------
# The ISM sample index truncates ``dist/c*sr + 0.5``; plain fp32 errs by
# up to ~2e-2 samples at image distances of hundreds of meters, flipping
# bins vs the f64 oracle near the boundary. Instead of fetching a risky
# mask to repair on the host (a synchronizing round trip per call), the
# index path runs in double-single arithmetic on the device: each value is
# an (hi, lo) fp32 pair with ~2^-47 relative error, so every truncation
# decision agrees with f64 (disagreement would need the true value
# within ~1e-10 samples of a boundary). Error-free transforms follow
# Dekker/Knuth (Veltkamp splitting — no FMA assumed).


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_renorm(s, e):
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def _split(a):
    c = a * np.float32(4097.0)  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _ds_add(a, b):
    s, e = _two_sum(a[0], b[0])
    e = e + a[1] + b[1]
    return _quick_renorm(s, e)


def _ds_mul(a, b):
    p, e = _two_prod(a[0], b[0])
    e = e + a[0] * b[1] + a[1] * b[0]
    return _quick_renorm(p, e)


def _ds_sqrt(a):
    # one ds Newton correction around the fp32 sqrt
    y0 = jnp.sqrt(a[0])
    y0 = jnp.where(a[0] > 0, y0, 0.0)
    y2 = _ds_mul((y0, jnp.zeros_like(y0)), (y0, jnp.zeros_like(y0)))
    r = _ds_add(a, (-y2[0], -y2[1]))
    inv = jnp.where(y0 > 0, 0.5 / y0, 0.0)
    return _quick_renorm(y0, r[0] * inv)


def _ds_const(v):
    hi = np.float32(v)
    return hi, np.float32(np.float64(v) - np.float64(hi))


_ISM_DEV_CHUNK = 1 << 15


def _ism_program_builder(L, sr, total_length, chunk):
    """Un-jitted device ISM for lattice limit ``L``: lattice enumeration,
    distances, dampings, duplicate-drop and scatter-add ON DEVICE,
    chunked with `lax.scan` to bound the (chunk, 8, 8) temporaries.
    Damping/value math is fp32; the sample INDEX path runs in
    double-single arithmetic (see helpers above), so index placement is
    bit-identical to the f64 host oracle with zero host round trips.
    Jitted directly for single RIRs and under `vmap` for fleets."""
    import jax

    n = 2 * L + 1
    M = n**3
    n_chunks = -(-M // chunk)
    M_pad = n_chunks * chunk
    u32 = jnp.asarray(_U_VECTORS, jnp.float32)
    later = jnp.asarray(_LATER)
    # ds constant for sr/c (the host divides by c then multiplies by sr;
    # both approximate the same real number to >=47 bits here)
    scale_ds = _ds_const(np.float64(sr) / 343.0)

    def program(a_hi, a_lo, b_hi, b_lo, beta1, beta2):
        # a = (1-2u)*s - r   (8, 3) ds;  b = 2*room_dim  (3,) ds
        ids = jnp.arange(M_pad, dtype=jnp.int32)
        i = ids // (n * n)
        r0 = ids % (n * n)
        lv_all = (
            jnp.stack([i, r0 // n, r0 % n], axis=1).astype(jnp.float32)
            - L
        )
        valid = ids < M

        def body(rir, inp):
            lv, vmask = inp  # (chunk, 3), (chunk,)
            # pos_ds[m, u, ax] = a[u, ax] + lv[m, ax] * b[ax]
            lb_hi, lb_err = _two_prod(
                lv[:, None, :], b_hi[None, None, :]
            )
            lb_lo = lb_err + lv[:, None, :] * b_lo[None, None, :]
            p_hi, p_lo = _ds_add(
                (a_hi[None, :, :], a_lo[None, :, :]), (lb_hi, lb_lo)
            )
            # d2 = sum of ds squares over axis
            d2 = (jnp.zeros_like(p_hi[..., 0]),) * 2
            for ax in range(3):
                sq = _ds_mul(
                    (p_hi[..., ax], p_lo[..., ax]),
                    (p_hi[..., ax], p_lo[..., ax]),
                )
                d2 = _ds_add(d2, sq)
            dist_hi, dist_lo = _ds_sqrt(d2)  # (chunk, 8)
            x_hi, x_lo = _ds_add(
                _ds_mul((dist_hi, dist_lo), scale_ds),
                (jnp.full_like(dist_hi, 0.5), jnp.zeros_like(dist_hi)),
            )
            fl = jnp.floor(x_hi)
            frac = (x_hi - fl) + x_lo
            idx = (
                fl.astype(jnp.int32)
                + (frac >= 1).astype(jnp.int32)
                - (frac < 0).astype(jnp.int32)
            )
            # values in plain fp32 (tolerance-level, not index-critical)
            diff = jnp.abs(lv[:, None, :] - u32[None, :, :])
            damp = jnp.prod(beta1**diff, axis=-1) * jnp.prod(
                beta2 ** jnp.abs(lv), axis=-1
            )[:, None]
            vals = damp / (4 * np.float32(np.pi) * dist_hi)
            eq = idx[:, :, None] == idx[:, None, :]
            dropped = (eq & later).any(axis=2)
            keep = (~dropped) & vmask[:, None]
            vals = jnp.nan_to_num(jnp.where(keep, vals, 0.0))
            rir = rir.at[idx.reshape(-1)].add(
                vals.reshape(-1), mode="drop"
            )
            return rir, 0

        rir0 = jnp.zeros(total_length, jnp.float32)
        rir, _ = jax.lax.scan(
            body,
            rir0,
            (lv_all.reshape(n_chunks, chunk, 3),
             valid.reshape(n_chunks, chunk)),
        )
        return rir

    return program, M


def _ism_device_program(L, sr, total_length, chunk=_ISM_DEV_CHUNK):
    import jax

    key = ("ism_dev", L, sr, total_length, chunk)
    got = _ISM_PROGRAMS.get(key)
    if got is None:
        program, M = _ism_program_builder(L, sr, total_length, chunk)
        got = _ISM_PROGRAMS[key] = (jax.jit(program), M)
    return got


def _ism_device_program_batched(L, sr, total_length, chunk=4096):
    """Batched fleet variant: vmap over a leading (B,) axis of the
    source/receiver-dependent ``a`` factors; room geometry and wall
    dampings broadcast. One program generates the whole fleet."""
    import jax

    key = ("ism_dev_batched", L, sr, total_length, chunk)
    got = _ISM_PROGRAMS.get(key)
    if got is None:
        program, M = _ism_program_builder(L, sr, total_length, chunk)
        got = _ISM_PROGRAMS[key] = (
            jax.jit(
                jax.vmap(program, in_axes=(0, 0, None, None, None, None))
            ),
            M,
        )
    return got


_ISM_PROGRAMS: dict = {}

_ISM_DEVICE: bool | None = None  # None = auto (device off CPU)


def set_ism_device(enabled: bool | None) -> None:
    """Dispatch override for the image-source model: ``True`` forces the
    fp32 device lattice (+f64 boundary repair), ``False`` forces the f64
    host oracle, ``None`` (default) picks the device path on accelerator
    backends."""
    global _ISM_DEVICE
    _ISM_DEVICE = enabled


def _ism_use_device() -> bool:
    if _ISM_DEVICE is not None:
        return _ISM_DEVICE
    import jax

    return jax.default_backend() != "cpu"


def generate_rir(
    room_dim, alpha, s_pos, r_pos, rt, mo, sr
):
    """Image-source RIR (Brinkmann et al.;
    `_room_acoustics.py:161-268`).

    Replaces the reference's triple Python loop over image orders with
    the whole (2L+1)³ × 8 image lattice as a batched tensor expression +
    scatter-add. On accelerator backends the entire lattice runs ON
    DEVICE in fp32 inside one program; the few groups whose truncated
    sample index is within `_ISM_EPS` of a boundary are recomputed
    exactly in f64 on the host and added in a second (tiny) scatter —
    index placement is bit-identical to the f64 oracle path by
    construction. Returns a DEVICE array on the device path (callers
    keep it resident); the host oracle path returns f64 numpy."""
    room_dim = np.asarray(room_dim, dtype=np.float64)
    s_pos = np.asarray(s_pos, dtype=np.float64)
    r_pos = np.asarray(r_pos, dtype=np.float64)
    beta = np.atleast_1d(np.sqrt(1 - np.asarray(alpha, dtype=np.float64)))
    if len(beta) == 1:
        beta_1 = np.ones(3) * beta
        beta_2 = np.ones(3) * beta
    elif len(beta) == 6:
        beta_1 = np.array([beta[1], beta[3], beta[4]])
        beta_2 = np.array([beta[0], beta[2], beta[5]])
    else:
        raise ValueError("Wrong length for absorption coefficients")

    c = 343
    t_max = rt * 1.1
    l_max = c * t_max / 2 / room_dim
    LIMIT = int(np.ceil(np.sqrt(l_max @ l_max)))
    if mo is not None:
        LIMIT = LIMIT if mo > LIMIT else mo
    total_length = int(t_max * 5 * sr)

    if not _ism_use_device():
        return _generate_rir_host(
            room_dim, beta_1, beta_2, s_pos, r_pos, sr, c, LIMIT,
            total_length,
        )

    program, M = _ism_device_program(LIMIT, sr, total_length)
    # ds-split inputs: a = (1-2u)*s - r (8, 3), b = 2*room_dim (3,)
    a64 = (1 - 2 * _U_VECTORS) * s_pos - r_pos
    b64 = 2 * room_dim
    a_hi = a64.astype(np.float32)
    b_hi = b64.astype(np.float32)
    from .._defer import defer_call

    # defer_call: the returned handle stays pending so the downstream
    # ImpulseResponse assignment fuses its amplitude constraining into
    # the flush instead of fetching a peak scalar (a device sync per call)
    return defer_call(
        ("ism_dev_run", LIMIT, sr, total_length),
        lambda *args: program(*args),
        jnp.asarray(a_hi),
        jnp.asarray((a64 - a_hi).astype(np.float32)),
        jnp.asarray(b_hi),
        jnp.asarray((b64 - b_hi).astype(np.float32)),
        jnp.asarray(beta_1, jnp.float32),
        jnp.asarray(beta_2, jnp.float32),
    )


def add_reverberant_tail_noise(
    rir: np.ndarray, mixing_time_s, t60: float, sr: int
) -> np.ndarray:
    """Decaying-noise late tail (`_room_acoustics.py:840-887`)."""
    rir = np.asarray(rir).reshape(-1)
    ind_direct = np.squeeze(np.where(rir != 0))[0]
    mixing_time_samples = int(mixing_time_s * sr)
    noise_length = len(rir) - ind_direct - mixing_time_samples
    noise = np.abs(np.random.normal(0, 1, noise_length))
    delta = 0.02 * 343 / t60
    noise *= np.exp(-delta * np.arange(noise_length) / sr)
    noise /= np.max(noise)
    window_length = 100
    window = rir[
        -noise_length - window_length // 2 : -noise_length
        + window_length // 2
    ]
    gain = np.median(window[window != 0]) * 0.5
    noise *= gain
    indexes = rir[-noise_length:] == 0
    rir[-noise_length:][indexes] += noise[indexes]
    return rir


def d50_from_rir(td: np.ndarray, fs: int, automatic_trimming: bool) -> float:
    """Definition D50 (`_room_acoustics.py:889-921`)."""
    td = np.asarray(td).reshape(-1)
    ind = find_ir_start(td)
    td = td[ind:]
    window = int(50e-3 * fs)
    if automatic_trimming:
        _, stop, _ = trim_ir_indices(td, fs, 0)
        stop = int(np.max([window, stop]))
    else:
        stop = len(td)
    td = td**2
    return float(np.sum(td[:window]) / np.sum(td[:stop]))


def c80_from_rir(td: np.ndarray, fs: int, automatic_trimming: bool) -> float:
    """Clarity C80 in dB (`_room_acoustics.py:924-956`)."""
    td = np.asarray(td).reshape(-1)
    ind = find_ir_start(td)
    td = td[ind:]
    window = int(80e-3 * fs)
    if automatic_trimming:
        _, stop, _ = trim_ir_indices(td, fs, 0)
        stop = int(np.max([window, stop]))
    else:
        stop = len(td)
    td = td**2
    return float(
        to_db(np.sum(td[:window]) / np.sum(td[window:stop]), False)
    )


def ts_from_rir(td: np.ndarray, fs: int, automatic_trimming: bool) -> float:
    """Center time in seconds (`_room_acoustics.py:959-996`)."""
    td = np.asarray(td).reshape(-1)
    ind = find_ir_start(td)
    td = td[ind:]
    if automatic_trimming:
        _, stop, _ = trim_ir_indices(td, fs, 0)
    else:
        stop = len(td)
    td = td[:stop] ** 2
    time_vec = np.linspace(0, len(td) / fs, len(td))
    return float(np.sum(td * time_vec) / np.sum(td))
