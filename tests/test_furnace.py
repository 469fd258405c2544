"""Energy-conservation (white furnace) statistical tests (SURVEY.md §4).

A homogeneous medium with single-scattering albedo 1 and an isotropic-ish
phase function must neither create nor destroy energy: the delta/ratio
trackers' event statistics must match closed-form Beer-Lambert solutions.
These exercise the *estimator machinery* with analytically known answers,
independent of the Earth scene.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth import constants as C
from digital_earth.models import volume as vol
from digital_earth.render import pathtracer as pt
from digital_earth.render.params import TraceConfig

CFG = TraceConfig(max_tracking_steps=4096)


class TestBeerLambert:
    """Ratio-tracked transmittance through the real RMO atmosphere must match
    deterministic quadrature of exp(-integral sigma_t)."""

    def _quadrature_transmittance(self, origin, direction, t0, t1, ext, steps=4096):
        ts = np.linspace(float(t0), float(t1), steps)
        pos = np.asarray(origin)[None, :] + ts[:, None] * np.asarray(direction)[None, :]
        dens = np.asarray(vol.get_density(vol.get_elevation(jnp.asarray(pos))))
        sigma = (dens * np.asarray(ext)).sum(-1)
        return math.exp(-np.trapezoid(sigma, ts))

    @pytest.mark.slow

    def test_vertical_and_slant_columns(self):
        up = jnp.array([0.0, 1.0, 0.0])
        slant = jnp.array([0.6, 0.8, 0.0])
        reps = 4000
        for direction in (up, slant):
            origin = up * (C.PLANET_R + 50.0)
            o = jnp.broadcast_to(origin, (reps, 3))
            d = jnp.broadcast_to(direction, (reps, 3))
            wl = jnp.full(reps, 550.0)
            ext = jnp.stack(
                [
                    vol.spectra_extinction_rayleigh(wl),
                    vol.spectra_extinction_mie(wl),
                    jnp.zeros(reps),
                ],
                axis=-1,
            )
            max_ext = jnp.sum(ext * pt._MAX_DENS_RMO, axis=-1)
            t0, t1 = pt._rmo_span(o, d, jnp.full(reps, -1.0))
            trans = pt._ratio_track_rmo(
                jax.random.PRNGKey(0), o, d, t0, t1, ext[:, None, :], max_ext,
                jnp.ones(reps, bool), CFG,
            )[:, 0]
            mc = float(jnp.mean(trans))
            se = float(jnp.std(trans)) / math.sqrt(reps)
            analytic = self._quadrature_transmittance(
                origin, direction, float(t0[0]), float(t1[0]), ext[0]
            )
            assert abs(mc - analytic) < 5 * se + 0.005, (mc, analytic)


class TestDeltaTrackingUnbiased:
    """P(no collision before exit) from delta tracking must equal the
    transmittance — the free-flight distribution is exponential in optical
    depth (reference pathtracer.py:77-115 semantics)."""

    def test_escape_probability_matches_transmittance(self):
        up = jnp.array([0.0, 1.0, 0.0])
        origin = up * (C.PLANET_R + 50.0)
        reps = 6000
        o = jnp.broadcast_to(origin, (reps, 3))
        d = jnp.broadcast_to(up, (reps, 3))
        wl = jnp.full(reps, 450.0)  # bluer = optically thicker
        ext = jnp.stack(
            [
                vol.spectra_extinction_rayleigh(wl),
                vol.spectra_extinction_mie(wl),
                jnp.zeros(reps),
            ],
            axis=-1,
        )
        max_ext = jnp.sum(ext * pt._MAX_DENS_RMO, axis=-1)
        t0, t1 = pt._rmo_span(o, d, jnp.full(reps, -1.0))
        event, _, _ = pt._delta_track_rmo(
            jax.random.PRNGKey(1), o, d, t0, t1, ext[:, None, :], max_ext,
            jnp.ones(reps, bool), CFG,
        )
        p_escape = float(jnp.mean(event == pt.NULL_EVENT))
        trans = pt._ratio_track_rmo(
            jax.random.PRNGKey(2), o, d, t0, t1, ext[:, None, :], max_ext,
            jnp.ones(reps, bool), CFG,
        )[:, 0]
        t_mean = float(jnp.mean(trans))
        se = math.sqrt(p_escape * (1 - p_escape) / reps) + float(
            jnp.std(trans)
        ) / math.sqrt(reps)
        assert abs(p_escape - t_mean) < 5 * se + 0.01, (p_escape, t_mean)

    @pytest.mark.slow

    def test_pure_scatter_medium_never_absorbs(self):
        """With only Rayleigh (albedo 1), every collision must scatter —
        albedo roulette conserves energy (reference pathtracer.py:263-270)."""
        up = jnp.array([0.0, 1.0, 0.0])
        origin = up * (C.PLANET_R + 50.0)
        reps = 3000
        o = jnp.broadcast_to(origin, (reps, 3))
        d = jnp.broadcast_to(up, (reps, 3))
        ext = jnp.concatenate(
            [
                vol.spectra_extinction_rayleigh(jnp.full((reps, 1), 420.0)),
                jnp.zeros((reps, 2)),
            ],
            axis=-1,
        )
        max_ext = jnp.sum(ext * pt._MAX_DENS_RMO, axis=-1)
        t0, t1 = pt._rmo_span(o, d, jnp.full(reps, -1.0))
        event, _, iid = pt._delta_track_rmo(
            jax.random.PRNGKey(3), o, d, t0, t1, ext[:, None, :], max_ext,
            jnp.ones(reps, bool), CFG,
        )
        event = np.asarray(event)
        assert (event != pt.ABSORB_EVENT).all()
        assert (np.asarray(iid)[event == pt.SCATTER_EVENT] == C.RAYLEIGH_ID).all()


class TestPhaseSamplerFurnace:
    """MC-integrating phase(w->w') over sampled directions w' must return 1
    when dividing by the sampling pdf (sampler/pdf consistency over the
    sphere) for the anisotropic phase functions used in the scene."""

    @pytest.mark.slow

    def test_cloud_phase_weight_is_unit(self):
        n = 20000
        key = jax.random.PRNGKey(4)
        k1, k2, k3 = jax.random.split(key, 3)
        view = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (n, 1))
        ids = jnp.full((n,), C.CLOUD_ID, dtype=jnp.int32)
        d, w = vol.sample_phase_dirs(
            jax.random.uniform(k1, (n,)),
            jax.random.uniform(k2, (n,)),
            jax.random.uniform(k3, (n,)),
            view, ids, jnp.zeros(n, bool),
        )
        # importance sampler: weight identically 1, direction distributed as
        # the phase: E[cos theta] must match quadrature of the phase function
        assert float(jnp.max(jnp.abs(w - 1.0))) == 0.0
        ct = np.asarray(jnp.sum(view * d, axis=-1))
        grid = jnp.linspace(-1.0, 1.0, 200001)
        pdf = vol.cloud_phase(grid, jnp.zeros_like(grid, bool)) * 2 * math.pi
        m1 = float(jnp.trapezoid(pdf * grid, grid))
        assert ct.mean() == pytest.approx(m1, abs=0.02)
