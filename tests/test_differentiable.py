"""Differentiable-DSP layer: traced designers, filtering, and gradient fitting.

This capability has no reference analog (the numpy reference can only apply
already-designed filters); correctness is checked against scipy and against
the package's own host-side designer.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.signal import sosfilt as scipy_sosfilt, sosfreqz as scipy_sosfreqz

from dsptoolbox_jax.classes.filter_helpers import biquad_coefficients
from dsptoolbox_jax.ops.differentiable import (
    biquad_coefficients_diff,
    fit_sos_to_magnitude,
    sosfilt_diff,
    sosfreqz_diff,
    sosfreqz_host,
)
from dsptoolbox_jax.standard.enums import BiquadEqType

FS = 48000


class TestTracedDesigner:
    @pytest.mark.parametrize(
        "eq_type",
        [
            BiquadEqType.Peaking,
            BiquadEqType.Lowpass,
            BiquadEqType.Highpass,
            BiquadEqType.BandpassSkirt,
            BiquadEqType.BandpassPeak,
            BiquadEqType.Notch,
            BiquadEqType.Allpass,
            BiquadEqType.Lowshelf,
            BiquadEqType.Highshelf,
        ],
    )
    def test_matches_host_designer(self, eq_type):
        fc, g, q = 1234.0, 5.5, 0.9
        b, a = biquad_coefficients(eq_type, FS, fc, g, q)
        expected = np.concatenate([b / a[0], a / a[0]])
        got = np.asarray(biquad_coefficients_diff(eq_type, FS, fc, g, q))
        np.testing.assert_allclose(got, expected, rtol=2e-5, atol=2e-6)

    def test_gradients_flow_to_parameters(self):
        def loss(params):
            sos = biquad_coefficients_diff(
                BiquadEqType.Peaking, FS, params[0], params[1], params[2]
            )[None]
            H = sosfreqz_diff(sos, jnp.asarray([500.0, 1000.0, 2000.0]), FS)
            return jnp.sum(jnp.abs(H) ** 2)

        g = jax.grad(loss)(jnp.asarray([1000.0, 6.0, 1.0]))
        assert np.all(np.isfinite(np.asarray(g)))
        # the gain gradient at the center frequency must be positive
        assert float(g[1]) > 0


class TestSosfreqzDiff:
    def test_matches_scipy(self):
        from scipy.signal import butter

        sos = butter(4, [400, 4000], btype="bandpass", fs=FS, output="sos")
        freqs = np.linspace(10, 20000, 64)
        H = np.asarray(sosfreqz_diff(jnp.asarray(sos), freqs, FS))
        _, H_ref = scipy_sosfreqz(sos, worN=freqs, fs=FS)
        np.testing.assert_allclose(H, H_ref, rtol=1e-4, atol=1e-5)
        # host-facing wrapper (complex-safe single jitted program)
        H_host = sosfreqz_host(sos, freqs, FS)
        np.testing.assert_allclose(H_host, H_ref, rtol=1e-4, atol=1e-5)


class TestSosfiltDiff:
    @pytest.mark.slow
    def test_matches_scipy_sosfilt(self):
        from scipy.signal import butter

        rng = np.random.default_rng(7)
        x = rng.standard_normal((3, 2048)).astype(np.float32)
        sos = butter(4, 2000, btype="lowpass", fs=FS, output="sos")
        y = np.asarray(sosfilt_diff(jnp.asarray(sos), jnp.asarray(x)))
        y_ref = scipy_sosfilt(sos, x.astype(np.float64), axis=-1)
        np.testing.assert_allclose(y, y_ref, rtol=5e-4, atol=5e-5)

    @pytest.mark.slow
    def test_grad_wrt_coefficients_matches_finite_difference(self):
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.standard_normal(256).astype(np.float32))
        sos0 = np.asarray(
            biquad_coefficients_diff(BiquadEqType.Peaking, FS, 2000.0, 3.0, 1.0)
        )[None]

        def loss(sos):
            return jnp.mean(sosfilt_diff(sos, x) ** 2)

        g = np.asarray(jax.grad(loss)(jnp.asarray(sos0)))
        assert np.all(np.isfinite(g))
        # central finite difference on b0
        eps = 1e-3
        sp, sm = sos0.copy(), sos0.copy()
        sp[0, 0] += eps
        sm[0, 0] -= eps
        fd = (float(loss(jnp.asarray(sp))) - float(loss(jnp.asarray(sm)))) / (
            2 * eps
        )
        assert g[0, 0] == pytest.approx(fd, rel=5e-2)


class TestFitting:
    def test_recovers_peaking_eq_magnitude(self):
        freqs = np.geomspace(50, 20000, 96).astype(np.float32)
        true = biquad_coefficients_diff(
            BiquadEqType.Peaking, FS, 1500.0, 6.0, 1.2
        )[None]
        target_db = 20 * np.log10(
            np.abs(np.asarray(sosfreqz_diff(true, freqs, FS))) + 1e-12
        )

        def make_sos(params):
            # log-frequency / softplus-Q reparametrization: keeps both
            # positive and puts all three parameters on comparable scales
            fc = jnp.exp(params[0])
            q = 0.1 + jax.nn.softplus(params[2])
            return biquad_coefficients_diff(
                BiquadEqType.Peaking, FS, fc, params[1], q
            )[None]

        params0 = jnp.asarray([np.log(800.0), 0.0, 0.5])
        params, losses = fit_sos_to_magnitude(
            make_sos, params0, target_db, freqs, FS, steps=400, lr=0.05
        )
        fitted_db = 20 * np.log10(
            np.abs(np.asarray(sosfreqz_diff(make_sos(params), freqs, FS)))
            + 1e-12
        )
        assert float(losses[-1]) < float(losses[0]) * 0.05
        assert np.max(np.abs(fitted_db - target_db)) < 1.0
