"""Statistical equivalence of the analytic RMO free-flight sampler vs the
delta tracker.

``atmosphere_lut.sample_flight_distance`` inverts tau(t) = -ln(u) on the
density-integral table, which must draw from the same distribution as
Woodcock delta tracking (reference pathtracer.py:77-115): collision
probability 1 - exp(-tau_total) over the span, collision distances with
density sigma(t) exp(-tau(t)), species by local extinction CMF
(reference pathtracer.py:102-106).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import digital_earth.constants as C
from digital_earth.assets.luts import load_spectral_luts
from digital_earth.models import atmosphere_lut as atm
from digital_earth.models import volume as vol
from digital_earth.ops import math_utils as mu
from digital_earth.render import pathtracer as pt
from digital_earth.render.params import TraceConfig


@pytest.fixture(scope="module")
def rays():
    """A fan of rays from 400 km altitude: grazing limb to steep entry."""
    n = 4096
    pos = jnp.tile(jnp.array([0.0, 0.0, C.PLANET_R + 400e3]), (n, 1))
    down = jnp.linspace(0.35, 0.999, n)
    d = jnp.stack([jnp.sqrt(1.0 - down**2), jnp.zeros(n), -down], axis=-1)
    t0, t1 = mu.rsi(pos, d, C.PLANET_R + C.ATMOS_HEIGHT)
    t_start = jnp.maximum(jnp.nan_to_num(t0, nan=-1.0), 0.0)
    tl0, _ = mu.rsi(pos, d, C.PLANET_R)
    t_max = jnp.where(jnp.isnan(tl0), jnp.nan_to_num(t1, nan=-1.0), tl0)
    lam = jnp.full((n, 1), 550.0)
    ext = jnp.stack(
        [
            vol.spectra_extinction_rayleigh(lam),
            vol.spectra_extinction_mie(lam),
            vol.spectra_extinction_ozone(lam, load_spectral_luts().o3_crossec),
        ],
        axis=-1,
    )  # (n, 1, 3)
    return pos, d, t_start, t_max, ext


def _run(rays, analytic: bool, seed: int):
    pos, d, t_start, t_max, ext = rays
    n = pos.shape[0]
    key = jax.random.PRNGKey(seed)
    active = jnp.ones(n, bool)
    if analytic:
        ev, t, iid = pt._sample_rmo_flight_analytic(
            key, pos, d, t_start, t_max, ext, active, TraceConfig()
        )
    else:
        max_ext = jnp.max(
            jnp.sum(ext * pt._MAX_DENS_RMO, axis=-1), axis=-1
        )
        ev, t, iid = pt._delta_track_rmo(
            key, pos, d, t_start, t_max, ext, max_ext, active,
            TraceConfig(analytic_flight=False),
        )
    return np.asarray(ev), np.asarray(t), np.asarray(iid)


class TestAnalyticFlight:
    @pytest.mark.slow
    def test_collision_probability_matches_beer_lambert(self, rays):
        """P(collision) per ray must be 1 - exp(-tau_total) exactly in
        expectation; with one draw per ray, compare the binned empirical
        rate over many seeds against the analytic value."""
        pos, d, t_start, t_max, ext = rays
        _, _, tau_total = atm.sample_flight_distance(
            jnp.full(pos.shape[0], 0.5), pos, d, t_start, t_max,
            ext[:, 0, :],
        )
        p_ana = np.asarray(1.0 - jnp.exp(-tau_total))
        hits = np.zeros(pos.shape[0])
        n_seeds = 32
        for s in range(n_seeds):
            ev, _, _ = _run(rays, True, s)
            hits += ev != pt.NULL_EVENT
        p_emp = hits / n_seeds
        # aggregate in 16 bins over the ray fan; binomial SE per bin
        bins = np.array_split(np.arange(pos.shape[0]), 16)
        for b in bins:
            m_emp, m_ana = p_emp[b].mean(), p_ana[b].mean()
            se = np.sqrt(max(m_ana * (1 - m_ana), 1e-6) / (len(b) * n_seeds))
            assert abs(m_emp - m_ana) < 5 * se + 1e-3, (m_emp, m_ana, se)

    @pytest.mark.slow

    def test_distance_distribution_matches_delta_tracking(self, rays):
        """Collision-distance quantiles agree between the two samplers."""
        ta, td = [], []
        for s in range(8):
            ev_a, t_a, _ = _run(rays, True, s)
            ev_d, t_d, _ = _run(rays, False, 1000 + s)
            ta.append(t_a[ev_a != pt.NULL_EVENT])
            td.append(t_d[ev_d != pt.NULL_EVENT])
        ta, td = np.concatenate(ta), np.concatenate(td)
        # sample sizes ~30k each: deciles should agree to ~1%
        qa = np.quantile(ta, np.linspace(0.1, 0.9, 9))
        qd = np.quantile(td, np.linspace(0.1, 0.9, 9))
        np.testing.assert_allclose(qa, qd, rtol=0.03)

    @pytest.mark.slow

    def test_event_and_species_rates_match(self, rays):
        """SCATTER/ABSORB split and species fractions agree."""
        ca, cd = [], []
        for s in range(8):
            ev_a, _, id_a = _run(rays, True, s)
            ev_d, _, id_d = _run(rays, False, 1000 + s)
            ca.append((ev_a, id_a))
            cd.append((ev_d, id_d))
        ev_a = np.concatenate([c[0] for c in ca])
        id_a = np.concatenate([c[1] for c in ca])[ev_a != pt.NULL_EVENT]
        ev_d = np.concatenate([c[0] for c in cd])
        id_d = np.concatenate([c[1] for c in cd])[ev_d != pt.NULL_EVENT]
        ra = np.bincount(id_a, minlength=3) / id_a.size
        rd = np.bincount(id_d, minlength=3) / id_d.size
        np.testing.assert_allclose(ra, rd, atol=0.02)
        sa = (ev_a == pt.SCATTER_EVENT).mean()
        sd = (ev_d == pt.SCATTER_EVENT).mean()
        assert abs(sa - sd) < 0.02, (sa, sd)

    def test_no_span_rays_never_collide(self, rays):
        pos, d, _, _, ext = rays
        n = pos.shape[0]
        t, collided, tau = atm.sample_flight_distance(
            jax.random.uniform(jax.random.PRNGKey(0), (n,)),
            pos, d, jnp.zeros(n), jnp.full(n, -1.0), ext[:, 0, :],
        )
        assert not bool(collided.any())
        assert np.allclose(np.asarray(tau), 0.0)
