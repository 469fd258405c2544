import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth.ops import math_utils as mu
from digital_earth.ops import sampling as smp

N = 20000


def _unit(v, atol=1e-4):
    np.testing.assert_allclose(np.asarray(mu.length(v)), 1.0, atol=atol)


class TestSphere:
    def test_uniform_moments(self):
        d = smp.sample_sphere_key(jax.random.PRNGKey(0), (N,))
        _unit(d)
        mean = np.asarray(d).mean(axis=0)
        np.testing.assert_allclose(mean, 0.0, atol=0.02)
        # each component^2 has expectation 1/3 for uniform sphere
        np.testing.assert_allclose((np.asarray(d) ** 2).mean(axis=0), 1 / 3, atol=0.01)


class TestCone:
    def test_within_cone(self):
        cos_max = np.cos(0.3)
        d = smp.sample_cone_key(jax.random.PRNGKey(1), cos_max, (N,))
        _unit(d)
        assert float(d[:, 2].min()) >= cos_max - 1e-5

    def test_oriented_mean_along_axis(self):
        n = jnp.tile(jnp.array([0.0, 1.0, 0.0]), (N, 1))
        d = smp.sample_cone_oriented_key(jax.random.PRNGKey(2), np.cos(0.2), n)
        _unit(d)
        assert float(mu.dot(d, n).min()) >= np.cos(0.2) - 1e-5

    def test_solid_angle_uniformity(self):
        # cos(theta) should be uniform in [cos_max, 1]
        cos_max = np.cos(1.0)
        d = smp.sample_cone_key(jax.random.PRNGKey(3), cos_max, (N,))
        ct = np.asarray(d[:, 2])
        expected_mean = (1 + cos_max) / 2
        assert ct.mean() == pytest.approx(expected_mean, abs=0.01)


class TestCosineHemisphere:
    def test_cosine_distribution(self):
        n = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (N, 1))
        d = smp.sample_hemisphere_cosine_weighted_key(jax.random.PRNGKey(4), n)
        _unit(d, atol=1e-3)
        ct = np.asarray(mu.dot(d, n))
        assert ct.min() >= -1e-3
        # E[cos theta] = 2/3 for pdf = cos/pi
        assert ct.mean() == pytest.approx(2 / 3, abs=0.01)
        # E[cos^2 theta] = 1/2
        assert (ct**2).mean() == pytest.approx(0.5, abs=0.01)
