"""Statistical equivalence of the accelerated trackers (render/pathtracer)
against the reference-faithful naive trackers (render/tracking_naive).

These are the tests that license the wavefront redesigns (speculative K-step
tracking, cloud space-skipping with fused majorant mips, bracketed marching):
each accelerated estimator must agree with its naive counterpart within Monte
Carlo error on controlled inputs (SURVEY.md §4 'statistical tests').
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth import constants as C
from digital_earth.assets.luts import load_spectral_luts
from digital_earth.assets.procgen import cached_earth_textures
from digital_earth.assets.textures import build_atlas
from digital_earth.models import volume as vol
from digital_earth.render import pathtracer as pt
from digital_earth.render import tracking_naive as tn
from digital_earth.render.params import TraceConfig

CFG = TraceConfig(max_tracking_steps=4096)
RES = (128, 256)


@pytest.fixture(scope="module")
def setup():
    raw = cached_earth_textures(RES, seed=7)
    atlas = build_atlas(raw)
    # a direction with heavy cloud and one mostly clear
    cl = raw["clouds"]
    ys, xs = np.where(cl > 200)
    y, x = ys[len(ys) // 2], xs[len(xs) // 2]
    h, w = cl.shape
    v = 1.0 - (y + 0.5) / h
    u = (x + 0.5) / w
    lat = (v - 0.5) * math.pi
    lon = (2 * u - 1) * math.pi
    cloudy_dir = np.array(
        [-math.cos(lat) * math.cos(lon), math.sin(lat), math.cos(lat) * math.sin(lon)]
    )
    return atlas, jnp.asarray(cloudy_dir)


def _cloud_spans(origin, direction, reps):
    o = jnp.broadcast_to(origin, (reps, 3))
    d = jnp.broadcast_to(direction, (reps, 3))
    ts, tm = pt.intersect_cloud_limits(o, d, jnp.full(reps, -1.0))
    return o, d, ts, tm


class TestCloudTrackers:
    def test_delta_collision_distribution(self, setup):
        atlas, nvec = setup
        reps = 3000
        ground = nvec * (C.PLANET_R + 100.0)
        o, d, ts, tm = _cloud_spans(ground, nvec, reps)
        ext_w = jnp.full(reps, C.CLOUDS_EXTINCT)
        act = jnp.ones(reps, bool)
        e_f, t_f = pt._track_cloud(
            jax.random.PRNGKey(7), o, d, ts, tm, ext_w,
            ext_w * C.CLOUDS_DENSITY, atlas.clouds, act, CFG, "delta",
        )
        ext4 = jnp.zeros((reps, 4)).at[:, 3].set(C.CLOUDS_EXTINCT)
        e_n, t_n, _ = tn.delta_track_naive(
            jax.random.PRNGKey(8), o, d, ts, tm, ext4,
            ext_w * C.CLOUDS_DENSITY, atlas.clouds, "cloud", act, CFG,
        )
        e_f, e_n = np.asarray(e_f), np.asarray(e_n)
        t_f, t_n = np.asarray(t_f), np.asarray(t_n)
        p_f, p_n = (e_f > 0).mean(), (e_n > 0).mean()
        se = np.sqrt(p_n * (1 - p_n) / reps) + 1e-6
        assert abs(p_f - p_n) < 5 * se + 0.01
        if (e_f > 0).any() and (e_n > 0).any():
            m_f, m_n = t_f[e_f > 0].mean(), t_n[e_n > 0].mean()
            s = t_n[e_n > 0].std() / np.sqrt((e_n > 0).sum()) + 1e-3
            assert abs(m_f - m_n) < 6 * s + 0.01 * abs(m_n)

    def test_ratio_transmittance_agreement(self, setup):
        atlas, nvec = setup
        reps = 1500
        # slightly tilted so the chord crosses mixed cloud coverage
        tang = np.cross(np.asarray(nvec), [0.0, 1.0, 0.0])
        tang = tang / np.linalg.norm(tang)
        direction = jnp.asarray(
            (np.asarray(nvec) * 0.6 + tang * 0.8)
            / np.linalg.norm(np.asarray(nvec) * 0.6 + tang * 0.8)
        )
        ground = nvec * (C.PLANET_R + 100.0)
        o, d, ts, tm = _cloud_spans(ground, direction, reps)
        ext_w = jnp.full(reps, C.CLOUDS_EXTINCT)
        act = jnp.ones(reps, bool)
        t_f = pt._track_cloud(
            jax.random.PRNGKey(42), o, d, ts, tm, ext_w,
            ext_w * C.CLOUDS_DENSITY, atlas.clouds, act, CFG, "ratio",
        )
        ext4 = jnp.zeros((reps, 4)).at[:, 3].set(C.CLOUDS_EXTINCT)
        t_n = tn.ratio_track_naive(
            jax.random.PRNGKey(43), o, d, ts, tm, ext4,
            ext_w * C.CLOUDS_DENSITY, atlas.clouds, "cloud", act, CFG,
        )
        f, nv = np.asarray(t_f), np.asarray(t_n)
        se = (f.std() + nv.std()) / np.sqrt(reps) + 1e-4
        assert abs(f.mean() - nv.mean()) < 5 * se


class TestRmoTrackers:
    def _setup_rays(self, reps):
        up = jnp.array([0.0, 1.0, 0.0])
        # near-horizontal ray at low altitude: long optically-thick chord
        d = jnp.array([0.985, 0.17, 0.0])
        d = d / jnp.linalg.norm(d)
        o = jnp.broadcast_to(up * (C.PLANET_R + 200.0), (reps, 3))
        dd = jnp.broadcast_to(d, (reps, 3))
        wl = jnp.full(reps, 550.0)
        luts = load_spectral_luts()
        ext = jnp.stack(
            [
                vol.spectra_extinction_rayleigh(wl),
                vol.spectra_extinction_mie(wl),
                vol.spectra_extinction_ozone(wl, luts.o3_crossec),
            ],
            axis=-1,
        )
        max_ext = jnp.sum(ext * pt._MAX_DENS_RMO, axis=-1)
        ts, tm = pt._rmo_span(o, dd, jnp.full(reps, -1.0))
        return o, dd, ts, tm, ext, max_ext

    def test_delta_event_distribution(self, setup):
        atlas, _ = setup
        reps = 3000
        o, d, ts, tm, ext, max_ext = self._setup_rays(reps)
        act = jnp.ones(reps, bool)
        e_f, t_f, id_f = pt._delta_track_rmo(
            jax.random.PRNGKey(3), o, d, ts, tm, ext[:, None, :], max_ext, act, CFG
        )
        ext4 = jnp.concatenate([ext, jnp.zeros((reps, 1))], axis=-1)
        e_n, t_n, id_n = tn.delta_track_naive(
            jax.random.PRNGKey(4), o, d, ts, tm, ext4, max_ext,
            atlas.clouds, "rmo", act, CFG,
        )
        e_f, e_n = np.asarray(e_f), np.asarray(e_n)
        for ev in (1, 2):
            p_f, p_n = (e_f == ev).mean(), (e_n == ev).mean()
            se = np.sqrt(max(p_n * (1 - p_n), 1e-6) / reps)
            assert abs(p_f - p_n) < 5 * se + 0.01, (ev, p_f, p_n)
        # species split among events
        id_f, id_n = np.asarray(id_f)[e_f > 0], np.asarray(id_n)[e_n > 0]
        h_f = np.bincount(id_f, minlength=3) / max(len(id_f), 1)
        h_n = np.bincount(id_n, minlength=3) / max(len(id_n), 1)
        np.testing.assert_allclose(h_f, h_n, atol=0.05)

    def test_ratio_transmittance_agreement(self, setup):
        atlas, _ = setup
        reps = 2000
        o, d, ts, tm, ext, max_ext = self._setup_rays(reps)
        act = jnp.ones(reps, bool)
        t_f = pt._ratio_track_rmo(
            jax.random.PRNGKey(1), o, d, ts, tm, ext[:, None, :], max_ext, act, CFG
        )[:, 0]
        ext4 = jnp.concatenate([ext, jnp.zeros((reps, 1))], axis=-1)
        t_n = tn.ratio_track_naive(
            jax.random.PRNGKey(2), o, d, ts, tm, ext4, max_ext,
            atlas.clouds, "rmo", act, CFG,
        )
        f, nv = np.asarray(t_f), np.asarray(t_n)
        se = (f.std() + nv.std()) / np.sqrt(reps) + 1e-4
        assert abs(f.mean() - nv.mean()) < 5 * se


class TestFastLoopRng:
    """The counter-hash in-loop generator (params.fast_loop_rng,
    ops/rng.fast_uniform) must reproduce every tracker distribution the
    threefry draws produce — validated against the naive twins exactly like
    the accelerated trackers themselves, plus direct uniformity checks."""

    CFGF = TraceConfig(max_tracking_steps=4096, fast_loop_rng=True)

    def test_uniformity_and_decorrelation(self):
        from digital_earth.ops import rng as rr

        keys = rr.as_lane_keys(jax.random.PRNGKey(11), 512)
        us = np.asarray(
            jnp.stack([rr.fast_uniform(keys, i, (3, 4)) for i in range(16)])
        )  # (16, 3, 4, 512)
        flat = us.reshape(-1)
        assert 0.0 <= flat.min() and flat.max() < 1.0
        assert abs(flat.mean() - 0.5) < 3.0 / np.sqrt(flat.size)
        assert abs(flat.var() - 1.0 / 12.0) < 0.002
        # chi-square on 32 bins
        h, _ = np.histogram(flat, bins=32, range=(0.0, 1.0))
        exp = flat.size / 32.0
        chi2 = ((h - exp) ** 2 / exp).sum()
        assert chi2 < 32 + 5 * np.sqrt(2 * 32)  # ~5 sigma
        # lag-1 correlations along every axis (iteration, draw, probe, lane)
        for ax in range(4):
            a = np.moveaxis(us, ax, 0)
            x = a[:-1].reshape(-1) - 0.5
            y = a[1:].reshape(-1) - 0.5
            r = (x * y).mean() / (x.std() * y.std() + 1e-12)
            assert abs(r) < 5.0 / np.sqrt(x.size), (ax, r)

    def test_cloud_delta_matches_naive(self, setup):
        atlas, nvec = setup
        reps = 3000
        ground = nvec * (C.PLANET_R + 100.0)
        o, d, ts, tm = _cloud_spans(ground, nvec, reps)
        ext_w = jnp.full(reps, C.CLOUDS_EXTINCT)
        act = jnp.ones(reps, bool)
        e_f, t_f = pt._track_cloud(
            jax.random.PRNGKey(7), o, d, ts, tm, ext_w,
            ext_w * C.CLOUDS_DENSITY, atlas.clouds, act, self.CFGF, "delta",
        )
        ext4 = jnp.zeros((reps, 4)).at[:, 3].set(C.CLOUDS_EXTINCT)
        e_n, t_n, _ = tn.delta_track_naive(
            jax.random.PRNGKey(8), o, d, ts, tm, ext4,
            ext_w * C.CLOUDS_DENSITY, atlas.clouds, "cloud", act, CFG,
        )
        e_f, e_n = np.asarray(e_f), np.asarray(e_n)
        t_f, t_n = np.asarray(t_f), np.asarray(t_n)
        p_f, p_n = (e_f > 0).mean(), (e_n > 0).mean()
        se = np.sqrt(p_n * (1 - p_n) / reps) + 1e-6
        assert abs(p_f - p_n) < 5 * se + 0.01
        m_f, m_n = t_f[e_f > 0].mean(), t_n[e_n > 0].mean()
        s = t_n[e_n > 0].std() / np.sqrt((e_n > 0).sum()) + 1e-3
        assert abs(m_f - m_n) < 6 * s + 0.01 * abs(m_n)

    def test_rmo_trackers_match_naive(self, setup):
        atlas, _ = setup
        reps = 3000
        helper = TestRmoTrackers()
        o, d, ts, tm, ext, max_ext = helper._setup_rays(reps)
        act = jnp.ones(reps, bool)
        e_f, t_f, _ = pt._delta_track_rmo(
            jax.random.PRNGKey(3), o, d, ts, tm, ext[:, None, :], max_ext,
            act, self.CFGF,
        )
        ext4 = jnp.concatenate([ext, jnp.zeros((reps, 1))], axis=-1)
        e_n, t_n, _ = tn.delta_track_naive(
            jax.random.PRNGKey(4), o, d, ts, tm, ext4, max_ext,
            atlas.clouds, "rmo", act, CFG,
        )
        e_f, e_n = np.asarray(e_f), np.asarray(e_n)
        for ev in (1, 2):
            p_f, p_n = (e_f == ev).mean(), (e_n == ev).mean()
            se = np.sqrt(max(p_n * (1 - p_n), 1e-6) / reps)
            assert abs(p_f - p_n) < 5 * se + 0.01, (ev, p_f, p_n)
        tr_f = pt._ratio_track_rmo(
            jax.random.PRNGKey(1), o, d, ts, tm, ext[:, None, :], max_ext,
            act, self.CFGF,
        )[:, 0]
        tr_n = tn.ratio_track_naive(
            jax.random.PRNGKey(2), o, d, ts, tm, ext4, max_ext,
            atlas.clouds, "rmo", act, CFG,
        )
        f, nv = np.asarray(tr_f), np.asarray(tr_n)
        se = (f.std() + nv.std()) / np.sqrt(reps) + 1e-4
        assert abs(f.mean() - nv.mean()) < 5 * se


class TestMarchEquivalence:
    def test_camera_rays_agree(self, setup):
        atlas, _ = setup
        n = 512
        key = jax.random.PRNGKey(0)
        cam = jnp.array([35963490.0, 12765367.0, -42445899.0])
        target = jax.random.normal(key, (n, 3)) * 3e6
        dirs = target - cam
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        pos = jnp.broadcast_to(cam, (n, 3))
        act = jnp.ones(n, bool)
        scale = jnp.float32(7800.0)
        fast = np.asarray(
            pt.intersect_land(atlas.topography, pos, dirs, scale, act, CFG)
        )
        naive = np.asarray(
            tn.intersect_land_naive(atlas.topography, pos, dirs, scale, act, CFG)
        )
        agree = (fast > 0) == (naive > 0)
        assert agree.mean() > 0.98
        both = (fast > 0) & (naive > 0)
        rel = np.abs(fast[both] - naive[both]) / naive[both]
        assert np.median(rel) < 5e-4

    def test_scalar_ray_geom_matches_vector_form(self, setup):
        """The hoisted ray quadratic (params.scalar_ray_geom) is the same
        march to reassociation rounding: identical hit/miss set, hit
        parameters within the t*1e-4 convergence epsilon, from both a
        camera-distance origin (worst f32 cancellation) and near-surface
        origins (shadow-ray regime)."""
        import dataclasses

        atlas, _ = setup
        n = 512
        key = jax.random.PRNGKey(3)
        cam = jnp.array([35963490.0, 12765367.0, -42445899.0])
        target = jax.random.normal(key, (n, 3))
        target = target / jnp.linalg.norm(target, axis=-1, keepdims=True)
        target = target * 6371e3 * 1.0005
        act = jnp.ones(n, bool)
        scale = jnp.float32(7800.0)
        cfg_s = dataclasses.replace(CFG, scalar_ray_geom=True)
        cfg_v = dataclasses.replace(CFG, scalar_ray_geom=False)
        for origin in (jnp.broadcast_to(cam, (n, 3)), target * 1.002):
            dirs = target - origin
            dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
            ts = np.asarray(pt.intersect_land(
                atlas.topography, origin, dirs, scale, act, cfg_s
            ))
            tv = np.asarray(pt.intersect_land(
                atlas.topography, origin, dirs, scale, act, cfg_v
            ))
            assert ((ts > 0) == (tv > 0)).all()
            both = (ts > 0) & (tv > 0)
            rel = np.abs(ts[both] - tv[both]) / np.maximum(tv[both], 1.0)
            assert rel.max() < 2e-4

    def _skimming_rays(self, n=2048, seed=1):
        """Near-tangent rays at low altitude: the phantom-hit / floor-
        tunneling exposed population."""
        r = np.random.default_rng(seed)
        up = np.array([0.0, 1.0, 0.0])
        alt = r.uniform(2e3, 9e3, n)
        az = r.uniform(0, 2 * np.pi, n)
        pitch = np.deg2rad(r.uniform(-0.3, 1.2, n))
        tang = np.stack([np.cos(az), np.zeros(n), np.sin(az)], -1)
        d = tang * np.cos(pitch)[:, None] - up[None] * np.sin(pitch)[:, None]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pos = jnp.asarray(up[None] * (6371e3 + alt)[:, None], jnp.float32)
        return pos, jnp.asarray(d, jnp.float32)

    def test_phantom_hits_match_reference_semantics(self, setup):
        """The reference march counts budget-exhausted near-tangent escape
        rays as land hits far above the surface (reference
        pathtracer.py:46); params.march_ref_phantom emulates that crawl for
        the wavefront march's miss lanes (gather-free, h=0). On the
        skimming population where the wavefront march previously missed
        EVERY naive-only hit, the emulation must recover nearly all of
        them and invent none."""
        import dataclasses

        atlas, _ = setup
        pos, dirs = self._skimming_rays()
        n = pos.shape[0]
        act = jnp.ones(n, bool)
        scale = jnp.float32(7800.0)
        naive = np.asarray(tn.intersect_land_naive(
            atlas.topography, pos, dirs, scale, act, CFG
        ))
        ph = np.asarray(pt.intersect_land(
            atlas.topography, pos, dirs, scale, act,
            dataclasses.replace(CFG, march_ref_phantom=True),
        ))
        off = np.asarray(pt.intersect_land(
            atlas.topography, pos, dirs, scale, act,
            dataclasses.replace(CFG, march_ref_phantom=False),
        ))
        nhit, phit, ohit = naive > 0, ph > 0, off > 0
        # the emulation never invents hits the reference march lacks
        assert (~nhit & phit).sum() == 0
        # and recovers most of the naive-only population the plain
        # wavefront march misses (h=0 emulation: land-skim budget slack
        # may drop a small tail)
        assert (nhit & ~ohit).sum() > 0  # the population exists
        assert (nhit & ~phit).sum() <= 0.25 * (nhit & ~ohit).sum()

    def test_phantom_prune_threshold_provable(self, monkeypatch):
        """pathtracer._PHANTOM_PRUNE_ALT: the h=0 crawl is pure geometry —
        its outcome depends only on (line-perigee altitude, start offset).
        Sweep that 2-D space densely with pruning DISABLED: above the prune
        threshold the crawl must never phantom (so pruning is exact), and
        well below it phantoms must exist (the test bites)."""
        monkeypatch.setattr(pt, "_PHANTOM_PRUNE_ALT", float("inf"))
        r = np.random.default_rng(3)
        n = 4096
        # perigee altitudes spanning both sides of the threshold
        a = np.concatenate([
            r.uniform(0.0, 1.8e3, n // 2),            # exhaustion band
            r.uniform(16e3, 200e3, n // 2),           # pruned band
        ])
        u = r.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        w = r.normal(size=(n, 3))
        d = w - np.sum(w * u, axis=-1, keepdims=True) * u
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        # start before the perigee at random offsets up to the atmosphere
        # chord (the crawl itself re-clamps to the atmosphere entry)
        peri = u * (6371e3 + a)[:, None]
        s0 = r.uniform(0.0, 2.2e6, n)[:, None]
        pos = jnp.asarray(peri - s0 * d, jnp.float32)
        dirs = jnp.asarray(d, jnp.float32)
        res = np.asarray(pt._phantom_crawl(
            pos, dirs, jnp.ones(n, bool), jnp.full(n, -1.0), None, CFG
        ))
        phantom = res > 0
        assert phantom[n // 2:].sum() == 0, (
            "crawl phantomed above the prune threshold"
        )
        assert phantom[: n // 2].sum() > 0

    def test_certified_floor_no_worse_than_plain_floor(self, setup):
        """params.march_certified_floor: at an exaggerated floor (0.25
        texel) the certified variant's hit/miss classification vs the
        floor-free march must be at least as faithful as the plain
        floor's, and bit-close where both hit."""
        import dataclasses

        atlas, _ = setup
        pos, dirs = self._skimming_rays(seed=5)
        n = pos.shape[0]
        act = jnp.ones(n, bool)
        scale = jnp.float32(7800.0)
        base = dataclasses.replace(CFG, march_ref_phantom=False)
        truth = np.asarray(pt.intersect_land(
            atlas.topography, pos, dirs, scale, act,
            dataclasses.replace(base, march_floor_frac=1e-6),
        )) > 0
        plain = np.asarray(pt.intersect_land(
            atlas.topography, pos, dirs, scale, act,
            dataclasses.replace(base, march_floor_frac=0.25),
        )) > 0
        cert = np.asarray(pt.intersect_land(
            atlas.topography, pos, dirs, scale, act,
            dataclasses.replace(
                base, march_floor_frac=0.25, march_certified_floor=True,
                march_uncert_floor_frac=1e-6,
            ),
        )) > 0
        assert (cert != truth).sum() <= (plain != truth).sum()
