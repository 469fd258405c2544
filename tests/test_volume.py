import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth import constants as C
from digital_earth.models import volume as vol
from digital_earth.ops import math_utils as mu

N = 60000


def mc_phase_integral(phase_fn, key=0, n=N):
    """Monte-Carlo integrate a phase function over the sphere; should be 1."""
    u = jax.random.uniform(jax.random.PRNGKey(key), (n,))
    cos_theta = u * 2.0 - 1.0  # uniform in cos theta
    vals = phase_fn(cos_theta)
    # integral = 2*pi * mean over cos_theta in [-1, 1] * 2
    return float(2.0 * math.pi * 2.0 * jnp.mean(vals))


class TestPhaseNormalization:
    def test_rayleigh(self):
        assert mc_phase_integral(vol.rayleigh_phase) == pytest.approx(1.0, abs=0.01)

    def test_hg(self):
        for g in (0.2, 0.76, -0.4):
            assert mc_phase_integral(lambda c: vol.hg_phase(c, g)) == pytest.approx(
                1.0, abs=0.02
            )

    def test_draine(self):
        f = lambda c: vol.draine_phase(c, vol.CLOUD_G_DRAINE, vol.CLOUD_ALPHA_DRAINE)
        # importance-sample near the forward peak is hard with uniform MC; use
        # fine trapezoid instead
        ct = jnp.linspace(-1.0, 1.0, 400001)
        integral = float(2 * math.pi * jnp.trapezoid(f(ct), ct))
        assert integral == pytest.approx(1.0, abs=0.005)

    def test_klein_nishina(self):
        f = lambda c: vol.klein_nishina_phase(c, 3000.0)
        ct = jnp.linspace(-1.0, 1.0, 2000001)
        integral = float(2 * math.pi * jnp.trapezoid(f(ct), ct))
        assert integral == pytest.approx(1.0, abs=0.01)

    def test_cloud_phase_mix(self):
        f = lambda c: vol.cloud_phase(c, jnp.zeros_like(c, dtype=bool))
        ct = jnp.linspace(-1.0, 1.0, 400001)
        integral = float(2 * math.pi * jnp.trapezoid(f(ct), ct))
        assert integral == pytest.approx(1.0, abs=0.01)


class TestPhaseSamplers:
    """Sampler matches its pdf: compare sampled cos-theta moments against
    quadrature moments of the analytic phase."""

    def _moments_from_phase(self, phase_fn):
        ct = jnp.linspace(-1.0, 1.0, 200001)
        w = phase_fn(ct) * 2 * math.pi
        m1 = float(jnp.trapezoid(w * ct, ct))
        m2 = float(jnp.trapezoid(w * ct * ct, ct))
        return m1, m2

    def test_hg_sampler(self):
        g = 0.76
        u = jax.random.uniform(jax.random.PRNGKey(0), (N,))
        ct = np.asarray(vol.sample_hg_cos(u, g))
        m1, m2 = self._moments_from_phase(lambda c: vol.hg_phase(c, g))
        assert ct.mean() == pytest.approx(m1, abs=0.01)
        assert (ct**2).mean() == pytest.approx(m2, abs=0.01)

    def test_kn_sampler(self):
        e = 3000.0
        u = jax.random.uniform(jax.random.PRNGKey(1), (N,))
        ct = np.asarray(vol.sample_klein_nishina_cos(u, e))
        m1, m2 = self._moments_from_phase(lambda c: vol.klein_nishina_phase(c, e))
        assert ct.mean() == pytest.approx(m1, abs=0.02)
        assert (ct**2).mean() == pytest.approx(m2, abs=0.02)

    def test_draine_sampler(self):
        g, a = vol.CLOUD_G_DRAINE, vol.CLOUD_ALPHA_DRAINE
        u = jax.random.uniform(jax.random.PRNGKey(2), (N,))
        ct = np.asarray(vol.sample_draine_cos(u, g, a))
        assert np.all(np.isfinite(ct))
        assert ct.min() >= -1.0 - 1e-5 and ct.max() <= 1.0 + 1e-5
        m1, m2 = self._moments_from_phase(lambda c: vol.draine_phase(c, g, a))
        assert ct.mean() == pytest.approx(m1, abs=0.02)
        assert (ct**2).mean() == pytest.approx(m2, abs=0.02)

    def test_sample_phase_dirs_unit_and_weights(self):
        key = jax.random.PRNGKey(3)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        n = 4096
        view = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (n, 1))
        ids = jax.random.randint(k4, (n,), 0, 5)
        d, w = vol.sample_phase_dirs(
            jax.random.uniform(k1, (n,)),
            jax.random.uniform(k2, (n,)),
            jax.random.uniform(k3, (n,)),
            view,
            ids,
            jnp.zeros(n, dtype=bool),
        )
        np.testing.assert_allclose(np.asarray(mu.length(d)), 1.0, atol=1e-3)
        assert np.all(np.isfinite(np.asarray(w)))
        # mie/cloud importance samplers have weight exactly 1
        w = np.asarray(w)
        ids = np.asarray(ids)
        assert np.all(w[(ids == C.MIE_ID) | (ids == C.CLOUD_ID)] == 1.0)


class TestDensities:
    def test_rayleigh_sea_level(self):
        assert float(vol.get_rayl_density(jnp.array(0.0))) == pytest.approx(1.0, abs=0.02)

    def test_rayleigh_decreasing(self):
        h = jnp.linspace(0.0, 100e3, 100)
        d = np.asarray(vol.get_rayl_density(h))
        assert np.all(np.diff(d) < 0)

    def test_ozone_peaks_at_25km(self):
        h = jnp.linspace(0.0, 60e3, 601)
        d = np.asarray(vol.get_ozone_density(h))
        assert h[d.argmax()] == pytest.approx(25e3, abs=200)
        assert d.max() == pytest.approx(1.0, abs=0.01)

    def test_mie_continuous_at_boundaries(self):
        for b in (1300.0, 2400.0, 11500.0):
            lo = float(vol.get_mie_density(jnp.array(b - 0.5)))
            hi = float(vol.get_mie_density(jnp.array(b + 0.5)))
            assert lo == pytest.approx(hi, abs=0.02)

    def test_get_density_clamps_negative_elevation(self):
        d_neg = np.asarray(vol.get_density(jnp.array(-500.0)))
        d_zero = np.asarray(vol.get_density(jnp.array(0.0)))
        np.testing.assert_allclose(d_neg, d_zero)

    def test_get_elevation(self):
        pos = jnp.array([C.PLANET_R + 1234.0, 0.0, 0.0])
        assert float(vol.get_elevation(pos)) == pytest.approx(1234.0, rel=1e-6)


class TestSpectra:
    def test_rayleigh_wavelength_dependence(self):
        # roughly lambda^-4: extinction at 400nm / extinction at 700nm ~ (7/4)^4
        e400 = float(vol.spectra_extinction_rayleigh(jnp.array(400.0)))
        e700 = float(vol.spectra_extinction_rayleigh(jnp.array(700.0)))
        assert e400 / e700 == pytest.approx((700 / 400) ** 4, rel=0.15)
        # sanity: sea-level rayleigh extinction at 550nm is ~1.1e-5 1/m
        e550 = float(vol.spectra_extinction_rayleigh(jnp.array(550.0)))
        assert e550 == pytest.approx(1.15e-5, rel=0.3)

    def test_mie_positive_and_decreasing(self):
        wl = jnp.linspace(400.0, 700.0, 31)
        e = np.asarray(vol.spectra_extinction_mie(wl))
        assert np.all(e > 0)
        assert np.all(np.diff(e) < 0)

    def test_ozone_lut_lookup(self):
        lut = jnp.ones((441,), dtype=jnp.float32)
        inside = float(vol.spectra_extinction_ozone(jnp.array(500.0), lut))
        assert inside == pytest.approx(1e-4 * C.OZONE_NUM_DENSITY, rel=1e-5)
        outside = float(vol.spectra_extinction_ozone(jnp.array(880.0), lut))
        assert outside == 0.0
        below = float(vol.spectra_extinction_ozone(jnp.array(389.0), lut))
        assert below == 0.0
