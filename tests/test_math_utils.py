import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth.ops import math_utils as mu


class TestRsi:
    def test_hit_from_outside(self):
        pos = jnp.array([0.0, 0.0, -10.0])
        d = jnp.array([0.0, 0.0, 1.0])
        t0, t1 = mu.rsi(pos, d, 2.0)
        assert np.isclose(float(t0), 8.0)
        assert np.isclose(float(t1), 12.0)

    def test_miss_returns_minus_one(self):
        pos = jnp.array([0.0, 5.0, -10.0])
        d = jnp.array([0.0, 0.0, 1.0])
        t0, t1 = mu.rsi(pos, d, 2.0)
        assert float(t0) == -1.0 and float(t1) == -1.0
        assert np.isfinite(float(t0))  # the reference's NaN-on-miss is fixed

    def test_inside_sphere(self):
        pos = jnp.zeros(3)
        d = jnp.array([1.0, 0.0, 0.0])
        t0, t1 = mu.rsi(pos, d, 3.0)
        assert np.isclose(float(t0), -3.0)
        assert np.isclose(float(t1), 3.0)

    def test_batched(self):
        pos = jnp.stack([jnp.array([0.0, 0.0, -10.0]), jnp.array([0.0, 99.0, 0.0])])
        d = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (2, 1))
        t0, t1 = mu.rsi(pos, d, 2.0)
        assert t0.shape == (2,)
        assert float(t0[0]) == pytest.approx(8.0)
        assert float(t0[1]) == -1.0


class TestUVMap:
    def test_poles_and_equator(self):
        u, v = mu.sphere_uv_map(jnp.array([0.0, 1.0, 0.0]))
        assert float(v) == pytest.approx(1.0)
        u, v = mu.sphere_uv_map(jnp.array([0.0, -1.0, 0.0]))
        assert float(v) == pytest.approx(0.0)
        u, v = mu.sphere_uv_map(jnp.array([-1.0, 0.0, 0.0]))
        # atan2(0, 1) = 0 -> u = 0.5
        assert float(u) == pytest.approx(0.5)
        assert float(v) == pytest.approx(0.5)

    def test_range(self):
        key = jax.random.PRNGKey(0)
        n = jax.random.normal(key, (512, 3))
        n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
        u, v = mu.sphere_uv_map(n)
        assert float(u.min()) >= 0.0 and float(u.max()) <= 1.0
        assert float(v.min()) >= 0.0 and float(v.max()) <= 1.0


class TestBasis:
    def test_orthonormal(self):
        key = jax.random.PRNGKey(1)
        n = jax.random.normal(key, (64, 3))
        n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
        x, y = mu.make_orthonormal_basis(n)
        np.testing.assert_allclose(np.abs(mu.dot(x, n)), 0.0, atol=1e-5)
        np.testing.assert_allclose(np.abs(mu.dot(y, n)), 0.0, atol=1e-5)
        np.testing.assert_allclose(np.abs(mu.dot(x, y)), 0.0, atol=1e-5)
        np.testing.assert_allclose(mu.length(x), 1.0, atol=1e-4)
        np.testing.assert_allclose(mu.length(y), 1.0, atol=1e-4)

    def test_spherical_direction_recovers_frame(self):
        n = jnp.array([0.0, 0.0, 1.0])
        x, y = mu.make_orthonormal_basis(n)
        d = mu.spherical_direction(
            jnp.array(0.0), jnp.array(1.0), jnp.array(0.0), x, y, n
        )
        np.testing.assert_allclose(np.asarray(d), [0.0, 0.0, 1.0], atol=1e-6)


class TestMisc:
    def test_cone_solid_angle(self):
        assert float(mu.cone_angle_to_solid_angle(jnp.pi)) == pytest.approx(
            4.0 * np.pi, rel=1e-6
        )
        assert float(mu.cone_angle_to_solid_angle(0.0)) == pytest.approx(0.0)

    def test_smoothstep(self):
        assert float(mu.smoothstep(0.0, 1.0, 0.5)) == pytest.approx(0.5)
        assert float(mu.smoothstep(0.0, 1.0, -1.0)) == 0.0
        assert float(mu.smoothstep(0.0, 1.0, 2.0)) == 1.0

    def test_mix_allows_extrapolation(self):
        # srgb_to_spectrum relies on negative mix weights
        assert float(mu.mix(jnp.array(1.0), jnp.array(2.0), -0.5)) == pytest.approx(0.5)

    def test_np_rotate_matrix(self):
        m = mu.np_rotate_matrix(np.array([0.0, 1.0, 0.0]), np.pi / 2)
        v = m @ np.array([1.0, 0.0, 0.0, 0.0])
        np.testing.assert_allclose(v[:3], [0.0, 0.0, -1.0], atol=1e-12)
