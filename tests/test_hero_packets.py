"""Hero-wavelength packet estimator consistency (Wilkie et al. 2014).

The L=4 packet estimator must agree in expectation with the L=1 reference
estimator — the MIS over spectral rotations is unbiased."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth.assets.luts import load_spectral_luts
from digital_earth.assets.procgen import generate_earth_textures
from digital_earth.assets.textures import build_atlas
from digital_earth.ops import spectral as sp
from digital_earth.render import pathtracer as pt
from digital_earth.render.params import TraceConfig, make_scene_params


@pytest.fixture(scope="module")
def scene():
    atlas = build_atlas(generate_earth_textures((64, 128), seed=3))
    luts = load_spectral_luts()
    return atlas, luts, make_scene_params()


def _trace_mean_xyz(scene_fix, L, n, key):
    atlas, luts, scn = scene_fix
    cfg = TraceConfig(
        max_bounces=3, land_march_steps=64, max_tracking_steps=256, hero_lambdas=L
    )
    cam = jnp.array([35963490.0, 12765367.0, -42445899.0])
    k_d, k_u, k_t = jax.random.split(key, 3)
    target = jax.random.normal(k_d, (n, 3)) * 4e6
    dirs = target - cam
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    pos = jnp.broadcast_to(cam, (n, 3))
    u = jax.random.uniform(k_u, (n,))
    wl, resp, pdf = sp.spectrum_sample_hero(u, luts.cie_cdf, luts.cie_response, L)
    rad = pt.trace_paths(k_t, pos, dirs, wl, scn, atlas, luts, cfg, lambda_pdf=pdf)
    xyz = jnp.einsum("nl,nlc->nc", rad, resp)
    return np.asarray(xyz)


class TestHeroPackets:
    def test_rotation_sampler_properties(self):
        luts = load_spectral_luts()
        u = jax.random.uniform(jax.random.PRNGKey(0), (512,))
        wl, resp, pdf = sp.spectrum_sample_hero(u, luts.cie_cdf, luts.cie_response, 4)
        assert wl.shape == (512, 4) and resp.shape == (512, 4, 3)
        wl = np.asarray(wl)
        assert wl.min() >= 390.0 and wl.max() <= 831.0
        # rotations are spaced by a quarter of the domain
        gaps = np.sort(wl, axis=1)
        d = np.diff(gaps, axis=1)
        np.testing.assert_allclose(d, 441.0 / 4, atol=0.5)

    @pytest.mark.slow

    def test_packet_estimator_unbiased_vs_single(self, scene):
        """Multi-seed z-test: the L=4 estimator's mean must agree with the
        L=1 estimator within Monte-Carlo error (path-traced radiance is
        heavy-tailed, so single-seed comparisons are unreliable)."""
        n = 3072
        n_seeds = 6
        a = np.stack(
            [
                _trace_mean_xyz(scene, 1, n, jax.random.PRNGKey(10 + s)).mean(axis=0)
                for s in range(n_seeds)
            ]
        )
        b = np.stack(
            [
                _trace_mean_xyz(scene, 4, n, jax.random.PRNGKey(50 + s)).mean(axis=0)
                for s in range(n_seeds)
            ]
        )
        sem = np.sqrt(a.var(axis=0) / n_seeds + b.var(axis=0) / n_seeds)
        z = (b.mean(axis=0) - a.mean(axis=0)) / (sem + 1e-5 * np.abs(a.mean(0)) + 1e-9)
        assert (np.abs(z) < 4.0).all(), (a.mean(0), b.mean(0), z)

    @pytest.mark.slow

    def test_packet_reduces_variance(self, scene):
        """Packets collapse *chroma* noise (the 4 wavelengths integrate the
        spectrum along one shared geometric path), while luminance noise is
        path-dominated and barely moves. Assert the robust signal — X-Y
        chroma-residual variance, measured ~30x lower for L=4 — with
        medians over seeds (single-seed variances of a heavy-tailed
        estimator flip fixed thresholds on any RNG-stream change)."""
        n = 2048

        def chroma_var(L, s):
            xyz = _trace_mean_xyz(scene, L, n, jax.random.PRNGKey(100 * L + s))
            return (xyz[:, 0] - xyz[:, 1]).var()

        c1 = float(np.median([chroma_var(1, s) for s in range(4)]))
        c4 = float(np.median([chroma_var(4, s) for s in range(4)]))
        assert c4 < c1 * 0.3, (c1, c4)
