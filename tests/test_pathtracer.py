import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth import constants as C
from digital_earth.assets.luts import load_spectral_luts
from digital_earth.assets.textures import build_atlas
from digital_earth.assets.procgen import generate_earth_textures
from digital_earth.ops import texture as tx
from digital_earth.render import pathtracer as pt
from digital_earth.render.params import TraceConfig, make_scene_params


@pytest.fixture(scope="module")
def atlas():
    return build_atlas(generate_earth_textures((128, 256), seed=3))


@pytest.fixture(scope="module")
def flat_atlas():
    """Zero topography + zero clouds: the planet is an analytic sphere."""
    t = generate_earth_textures((64, 128), seed=3)
    t["topography"] = np.zeros_like(t["topography"])
    t["clouds"] = np.zeros_like(t["clouds"])
    return build_atlas(t)


CFG = TraceConfig(max_bounces=4, land_march_steps=128, max_tracking_steps=512)


class TestCloudLimits:
    def test_above_slab_span(self):
        pos = jnp.array([[0.0, C.CLOUDS_UPPER_LIMIT + 50e3, 0.0]])
        d = jnp.array([[0.0, -1.0, 0.0]])
        t0, t1 = pt.intersect_cloud_limits(pos, d, jnp.array([-1.0]))
        assert float(t0[0]) == pytest.approx(50e3, rel=1e-3)
        assert float(t1[0]) == pytest.approx(50e3 + C.CLOUDS_THICKNESS, rel=1e-3)

    def test_inside_slab(self):
        r = C.CLOUDS_LOWER_LIMIT + 0.5 * C.CLOUDS_THICKNESS
        pos = jnp.array([[0.0, r, 0.0]])
        d = jnp.array([[0.0, 1.0, 0.0]])
        t0, t1 = pt.intersect_cloud_limits(pos, d, jnp.array([-1.0]))
        assert float(t0[0]) == 0.0
        assert float(t1[0]) == pytest.approx(0.5 * C.CLOUDS_THICKNESS, rel=1e-3)

    def test_below_slab_upward(self):
        pos = jnp.array([[0.0, C.PLANET_R + 100.0, 0.0]])
        d = jnp.array([[0.0, 1.0, 0.0]])
        t0, t1 = pt.intersect_cloud_limits(pos, d, jnp.array([-1.0]))
        assert float(t0[0]) == pytest.approx(C.CLOUDS_HEIGHT - 100.0, rel=1e-3)
        assert float(t1[0]) == pytest.approx(
            C.CLOUDS_HEIGHT - 100.0 + C.CLOUDS_THICKNESS, rel=1e-3
        )

    def test_below_with_land_hit_disables(self):
        pos = jnp.array([[0.0, C.PLANET_R + 100.0, 0.0]])
        d = jnp.array([[0.0, 1.0, 0.0]])
        _, t1 = pt.intersect_cloud_limits(pos, d, jnp.array([5000.0]))
        assert float(t1[0]) == -1.0


class TestIntersectLand:
    def test_flat_planet_matches_analytic_sphere(self, flat_atlas):
        n = 256
        key = jax.random.PRNGKey(0)
        cam = jnp.array([2.5e7, 1.0e7, -3.0e7])
        target = jax.random.normal(key, (n, 3)) * 2e6
        dirs = target - cam
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        pos = jnp.broadcast_to(cam, (n, 3))
        got = pt.intersect_land(
            flat_atlas.topography, pos, dirs, jnp.float32(7800.0),
            jnp.ones(n, bool), CFG,
        )
        from digital_earth.ops.math_utils import rsi

        t_near, _ = rsi(pos, dirs, C.PLANET_R)
        got, t_near = np.asarray(got), np.asarray(t_near)
        hit = t_near > 0
        assert ((got > 0) == hit).mean() > 0.99
        both = hit & (got > 0)
        rel = np.abs(got[both] - t_near[both]) / t_near[both]
        # convergence epsilon is |f| < t*1e-4 (reference pathtracer.py:43),
        # so grazing lanes may stop within ~1e-3 relative of the sphere
        assert np.median(rel) < 2e-4
        assert (rel < 1.5e-3).all()

    def test_miss_is_minus_one(self, atlas):
        pos = jnp.array([[3e7, 0.0, 0.0]])
        d = jnp.array([[0.0, 1.0, 0.0]])  # perpendicular to planet direction
        got = pt.intersect_land(
            atlas.topography, pos, d, jnp.float32(7800.0), jnp.ones(1, bool), CFG
        )
        assert float(got[0]) == -1.0

    def test_inactive_lane_is_miss(self, atlas):
        pos = jnp.array([[3e7, 0.0, 0.0]])
        d = jnp.array([[-1.0, 0.0, 0.0]])
        got = pt.intersect_land(
            atlas.topography, pos, d, jnp.float32(7800.0), jnp.zeros(1, bool), CFG
        )
        assert float(got[0]) == -1.0


class TestTracePaths:
    def test_apollo_frame_properties(self, atlas):
        luts = load_spectral_luts()
        scene = make_scene_params()
        n = 512
        cam = jnp.array([35963490.0, 12765367.0, -42445899.0])
        key = jax.random.PRNGKey(1)
        target = jax.random.normal(key, (n, 3)) * 5e6
        dirs = target - cam
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        pos = jnp.broadcast_to(cam, (n, 3))
        wl = jax.random.uniform(jax.random.PRNGKey(2), (n,)) * 440.0 + 390.0
        rad = pt.trace_paths(jax.random.PRNGKey(3), pos, dirs, wl, scene, atlas, luts, CFG)
        rad = np.asarray(rad)
        assert rad.shape == (n,)
        assert np.isfinite(rad).all()
        assert (rad >= 0).all()
        assert (rad > 0).any()

    @pytest.mark.slow

    def test_deterministic_same_key(self, atlas):
        luts = load_spectral_luts()
        scene = make_scene_params()
        n = 128
        cam = jnp.array([35963490.0, 12765367.0, -42445899.0])
        dirs = jnp.broadcast_to(
            -cam / jnp.linalg.norm(cam), (n, 3)
        )
        pos = jnp.broadcast_to(cam, (n, 3))
        wl = jnp.linspace(400.0, 700.0, n)
        a = pt.trace_paths(jax.random.PRNGKey(9), pos, dirs, wl, scene, atlas, luts, CFG)
        b = pt.trace_paths(jax.random.PRNGKey(9), pos, dirs, wl, scene, atlas, luts, CFG)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.slow

    def test_sun_disk_visible_on_miss(self, flat_atlas):
        luts = load_spectral_luts()
        scene = make_scene_params()
        n = 4
        # rays pointing exactly at the sun, from far outside the atmosphere,
        # offset sideways so the planet does not occlude them
        light = scene.light_direction
        perp = jnp.cross(light, jnp.array([0.0, 1.0, 0.0]))
        perp = perp / jnp.linalg.norm(perp)
        pos = jnp.broadcast_to(-light * 5e8 + perp * 5e7, (n, 3))
        dirs = jnp.broadcast_to(light, (n, 3))
        wl = jnp.full((n,), 550.0)
        rad = pt.trace_paths(
            jax.random.PRNGKey(0), pos, dirs, wl, scene, flat_atlas, luts, CFG
        )
        from digital_earth.ops.spectral import plancks

        expected = float(plancks(C.SUN_TEMPERATURE, jnp.array(550.0)))
        assert np.asarray(rad).min() >= expected * 0.99


def test_speckle_shaper():
    """Nightlight speckle field (reference pathtracer.py:272-282, rebuilt):
    deterministic, non-negative, and increasing with density."""
    from digital_earth.render.pathtracer import speckle

    p = jnp.asarray(np.random.RandomState(1).rand(64, 2) * 50.0)
    lo = np.asarray(speckle(p, jnp.full((64,), 0.1)))
    hi = np.asarray(speckle(p, jnp.full((64,), 0.67)))
    assert np.isfinite(lo).all() and (lo >= 0.0).all()
    assert hi.mean() > lo.mean()
    again = np.asarray(speckle(p, jnp.full((64,), 0.1)))
    np.testing.assert_array_equal(lo, again)


@pytest.mark.slow


def test_nee_off_diagnostic(atlas):
    """cfg.nee_off compiles the NEE path out: the render stays
    finite and can only lose energy vs the default estimator."""
    luts = load_spectral_luts()
    scene = make_scene_params()
    n = 256
    cam = jnp.array([35963490.0, 12765367.0, -42445899.0])
    target = jax.random.normal(jax.random.PRNGKey(4), (n, 3)) * 5e6
    dirs = target - cam
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    pos = jnp.broadcast_to(cam, (n, 3))
    wl = jnp.linspace(400.0, 700.0, n)
    on = np.asarray(pt.trace_paths(
        jax.random.PRNGKey(7), pos, dirs, wl, scene, atlas, luts, CFG
    ))
    off = np.asarray(pt.trace_paths(
        jax.random.PRNGKey(7), pos, dirs, wl, scene, atlas, luts,
        dataclasses.replace(CFG, nee_off=True),
    ))
    assert np.isfinite(off).all() and (off >= 0).all()
    # same RNG stream: the NEE contribution is the only difference per lane
    assert (off <= on + 1e-6).all()
    assert off.sum() < on.sum()
