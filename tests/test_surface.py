import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth.models import surface as srf
from digital_earth.ops import math_utils as mu


def _dirs(key, n):
    v = jax.random.normal(jax.random.PRNGKey(key), (n, 3))
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


class TestFresnel:
    def test_normal_incidence_equals_f0(self):
        for f0 in (0.02, 0.04):
            val = float(srf.fresnel_dielectric(jnp.array(1.0), f0))
            assert val == pytest.approx(f0, abs=2e-3)

    def test_grazing_goes_to_one(self):
        val = float(srf.fresnel_dielectric(jnp.array(0.001), 0.02))
        assert val > 0.98

    def test_monotone(self):
        c = jnp.linspace(0.01, 1.0, 100)
        f = np.asarray(srf.fresnel_dielectric(c, 0.04))
        assert np.all(np.diff(f) <= 1e-6)


class TestLobes:
    def test_ggx_d_normalization(self):
        # integral over hemisphere of D(h) cos(h) dh = 1
        alpha2 = 0.73**2
        ct = jnp.linspace(0.0, 1.0, 200001)
        d = srf.ggx_d(ct, alpha2)
        integral = float(2 * np.pi * jnp.trapezoid(d * ct, ct))
        assert integral == pytest.approx(1.0, rel=0.01)

    def test_beckmann_ndf_normalization(self):
        alpha = 0.25**2 * 2.0
        ct = jnp.linspace(1e-4, 1.0, 200001)
        d = srf.beckmann_isotropic_ndf(ct, alpha)
        integral = float(2 * np.pi * jnp.trapezoid(d * ct, ct))
        assert integral == pytest.approx(1.0, rel=0.02)

    def test_disney_diffuse_near_lambert(self):
        val = float(srf.disney_diffuse(0.73, jnp.array(1.0), jnp.array(1.0), jnp.array(1.0)))
        # at normal incidence retro term adds a bit over 1/pi
        assert val == pytest.approx(1 / np.pi, rel=0.5)
        assert val > 0


class TestEarthBrdf:
    def test_finite_and_nonnegative(self):
        n = 2048
        v = _dirs(0, n)
        l = _dirs(1, n)
        normal = _dirs(2, n)
        albedo = jax.random.uniform(jax.random.PRNGKey(3), (n,))
        ocean = jax.random.uniform(jax.random.PRNGKey(4), (n,))
        bathy = jax.random.uniform(jax.random.PRNGKey(5), (n,))
        brdf, ndl = srf.earth_brdf(albedo, ocean, bathy, v, normal, l)
        assert np.all(np.isfinite(np.asarray(brdf)))
        assert np.all(np.asarray(brdf) >= 0)
        assert np.all(np.asarray(ndl) >= 0) and np.all(np.asarray(ndl) <= 1)

    def test_ocean_specular_brighter_at_grazing(self):
        # glint: ocean reflectance should rise strongly near grazing
        normal = jnp.array([0.0, 0.0, 1.0])
        mk = lambda ct: jnp.array([np.sqrt(1 - ct**2), 0.0, ct])
        brdf_g, _ = srf.earth_brdf(
            jnp.array(0.1), jnp.array(1.0), jnp.array(0.5), mk(0.1), normal, mk(0.1)
        )
        brdf_n, _ = srf.earth_brdf(
            jnp.array(0.1), jnp.array(1.0), jnp.array(0.5), mk(0.95), normal, mk(0.95)
        )
        assert float(brdf_g) > float(brdf_n)
