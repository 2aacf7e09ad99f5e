"""Time decomposition of the packed-real DAS quadratic form.

Times each component of the production core (`beamforming._das_map_core`)
on the 513-bin × 64-mic × 900-point sweep so the wall clock is
attributed, then A/Bs candidate fixes (precision modes, prebuilt
factors, fused alternatives). Each timing ends in `block_until_ready`.

    python tools/bench_das_roofline.py            # on a GPU
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

_HIGH = jax.lax.Precision.HIGHEST

F, M, G = 513, 64, 900


def timeit(fn, args, n=10, warmup=2):
    for i in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        for i in range(n):
            outs = fn(*args)
        jax.block_until_ready(outs)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def main():
    rng = np.random.default_rng(0)
    ampj = jnp.asarray(
        rng.uniform(0.5, 1.0, (M, G)).astype(np.float32)
    )
    diffj = jnp.asarray(
        (rng.standard_normal((M, G)) * 0.01).astype(np.float32)
    )
    kj = jnp.asarray(
        np.linspace(10.0, 400.0, F).astype(np.float32)
    )
    cre = jnp.asarray(rng.standard_normal((F, M, M)).astype(np.float32))
    cim = jnp.asarray(rng.standard_normal((F, M, M)).astype(np.float32))

    report = {}

    # A. production core (steering build + B build + 2 einsums)
    from dsptoolbox_jax.beamforming.beamforming import _das_map_core

    core = jax.jit(_das_map_core)
    report["A_full_core_ms"] = timeit(
        core, (ampj, diffj, kj, cre, cim)
    ) * 1e3

    # B. steering build only (cos+sin over (F, G, M), concat to (F,G,2M))
    @jax.jit
    def steering_only(ampj, diffj, kj):
        ph = kj[:, None, None] * diffj.T[None]
        amp_t = ampj.T[None]
        return jnp.concatenate(
            [amp_t * jnp.cos(ph), -amp_t * jnp.sin(ph)], axis=-1
        )

    report["B_steering_build_ms"] = timeit(
        steering_only, (ampj, diffj, kj)
    ) * 1e3

    hp = steering_only(ampj, diffj, kj)

    # C. B-block build only
    @jax.jit
    def bblock_only(cre, cim):
        return jnp.concatenate(
            [
                jnp.concatenate([cre, -cim], axis=-1),
                jnp.concatenate([cim, cre], axis=-1),
            ],
            axis=-2,
        )

    report["C_bblock_build_ms"] = timeit(bblock_only, (cre, cim)) * 1e3
    Bm = bblock_only(cre, cim)

    # D. the two einsums with everything prebuilt (matmul + memory only)
    @jax.jit
    def quad_only(hp, Bm):
        t = jnp.einsum("fgk,fkl->fgl", hp, Bm, precision=_HIGH)
        return jnp.einsum("fgl,fgl->gf", hp, t, precision=_HIGH)

    report["D_quadratic_prebuilt_ms"] = timeit(quad_only, (hp, Bm)) * 1e3

    # E. first einsum alone
    @jax.jit
    def einsum1(hp, Bm):
        return jnp.einsum("fgk,fkl->fgl", hp, Bm, precision=_HIGH)

    report["E_einsum1_ms"] = timeit(einsum1, (hp, Bm)) * 1e3

    # F. default precision (single bf16 pass) + error vs HIGHEST
    @jax.jit
    def quad_default(hp, Bm):
        t = jnp.einsum("fgk,fkl->fgl", hp, Bm)
        return jnp.einsum("fgl,fgl->gf", hp, t)

    report["F_quadratic_bf16_ms"] = timeit(quad_default, (hp, Bm)) * 1e3
    a = np.asarray(quad_only(hp, Bm))
    b = np.asarray(quad_default(hp, Bm))
    report["F_bf16_rel_err"] = float(
        np.max(np.abs(a - b)) / np.max(np.abs(a))
    )

    # F2. Precision.HIGH (3-pass bf16x3) quadratic + error vs HIGHEST
    _HI3 = jax.lax.Precision.HIGH

    @jax.jit
    def quad_high(hp, Bm):
        t = jnp.einsum("fgk,fkl->fgl", hp, Bm, precision=_HI3)
        return jnp.einsum("fgl,fgl->gf", hp, t, precision=_HI3)

    report["F2_quadratic_high_ms"] = timeit(quad_high, (hp, Bm)) * 1e3
    c = np.asarray(quad_high(hp, Bm))
    report["F2_high_rel_err"] = float(
        np.max(np.abs(a - c)) / np.max(np.abs(a))
    )

    # G. full core at default precision
    from dsptoolbox_jax.beamforming import beamforming as bfmod

    def core_default(ampj, diffj, kj, cre, cim):
        ph = kj[:, None, None] * diffj.T[None]
        amp_t = ampj.T[None]
        hp = jnp.concatenate(
            [amp_t * jnp.cos(ph), -amp_t * jnp.sin(ph)], axis=-1
        )
        Bm = jnp.concatenate(
            [
                jnp.concatenate([cre, -cim], axis=-1),
                jnp.concatenate([cim, cre], axis=-1),
            ],
            axis=-2,
        )
        t = jnp.einsum("fgk,fkl->fgl", hp, Bm)
        return jnp.einsum("fgl,fgl->gf", hp, t)

    report["G_full_core_bf16_ms"] = timeit(
        jax.jit(core_default), (ampj, diffj, kj, cre, cim)
    ) * 1e3

    # G2. full core at Precision.HIGH (steering + B build + quad_high)
    def core_high(ampj, diffj, kj, cre, cim):
        ph = kj[:, None, None] * diffj.T[None]
        amp_t = ampj.T[None]
        hpv = jnp.concatenate(
            [amp_t * jnp.cos(ph), -amp_t * jnp.sin(ph)], axis=-1
        )
        Bv = jnp.concatenate(
            [
                jnp.concatenate([cre, -cim], axis=-1),
                jnp.concatenate([cim, cre], axis=-1),
            ],
            axis=-2,
        )
        t = jnp.einsum("fgk,fkl->fgl", hpv, Bv, precision=_HI3)
        return jnp.einsum("fgl,fgl->gf", hpv, t, precision=_HI3)

    report["G2_full_core_high_ms"] = timeit(
        jax.jit(core_high), (ampj, diffj, kj, cre, cim)
    ) * 1e3

    for k, v in report.items():
        if isinstance(v, float):
            report[k] = round(v, 4)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
