"""Validation of the semi-analytic atmosphere integrals
(models/atmosphere_lut.py) against brute-force quadrature of the closed-form
density profiles, and of the delta-tracking density envelopes."""

import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth import constants as C
from digital_earth.models import atmosphere_lut as atm
from digital_earth.models import volume as vol


def _brute_force_integral(pos, direction, t0, t1, steps=60000):
    """Dense trapezoid of the per-species densities along [t0, t1]."""
    ts = np.linspace(t0, t1, steps)
    pts = pos[None, :] + ts[:, None] * direction[None, :]
    h = np.maximum(np.linalg.norm(pts, axis=-1) - C.PLANET_R, 0.0)
    rho = np.stack(
        [
            np.asarray(vol.get_rayl_density(h)),
            np.asarray(vol.get_mie_density(h)),
            np.asarray(vol.get_ozone_density(h)),
        ],
        axis=-1,
    )
    return np.trapezoid(rho, ts, axis=0)


def _random_segments(rng, n):
    """Realistic tracker segments: origin in the atmosphere, clipped to the
    planet surface / atmosphere exit like the path tracer clips them."""
    segs = []
    while len(segs) < n:
        alt = rng.uniform(0.0, C.ATMOS_HEIGHT)
        u = rng.normal(size=3)
        pos = (C.PLANET_R + alt) * u / np.linalg.norm(u)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        # clip to planet hit / atmosphere exit (numpy rsi)
        b = np.dot(pos, d)
        r2 = np.dot(pos, pos)
        disc_p = b * b - (r2 - C.PLANET_R**2)
        disc_a = b * b - (r2 - C.ATMOS_UPPER_LIMIT**2)
        t_exit = -b + np.sqrt(max(disc_a, 0.0))
        if disc_p > 0.0 and -b - np.sqrt(disc_p) > 0.0:
            t_exit = min(t_exit, -b - np.sqrt(disc_p))
        if t_exit <= 1.0:
            continue
        t0 = rng.uniform(0.0, 0.8) * t_exit
        t1 = rng.uniform(t0, t_exit)
        if t1 - t0 < 1.0:
            continue
        segs.append((pos, d, t0, t1))
    return segs


@pytest.mark.slow


def test_segment_integrals_match_brute_force():
    rng = np.random.default_rng(7)
    segs = _random_segments(rng, 40)
    pos = jnp.asarray(np.stack([s[0] for s in segs]), dtype=jnp.float32)
    dirs = jnp.asarray(np.stack([s[1] for s in segs]), dtype=jnp.float32)
    t0 = jnp.asarray([s[2] for s in segs], dtype=jnp.float32)
    t1 = jnp.asarray([s[3] for s in segs], dtype=jnp.float32)
    got = np.asarray(atm.density_integral_segment(pos, dirs, t0, t1))
    want = np.stack([_brute_force_integral(*s) for s in segs])
    # What matters is the optical-depth error: weight each species' integral
    # error by a (generous) visible-band extinction coefficient and require
    # the worst-case tau error to stay well under the 1% fidelity budget.
    k = np.array(
        [
            float(vol.spectra_extinction_rayleigh(jnp.asarray(420.0))),
            float(vol.spectra_extinction_mie(jnp.asarray(420.0))),
            float(
                np.max(
                    np.asarray(
                        vol.spectra_extinction_ozone(
                            jnp.arange(390.0, 831.0),
                            __import__(
                                "digital_earth.assets.luts",
                                fromlist=["load_spectral_luts"],
                            ).load_spectral_luts().o3_crossec,
                        )
                    )
                )
            ),
        ]
    )
    dtau = np.abs(got - want) @ k
    assert dtau.max() < 5e-3, dtau.max()
    # and each species integral is accurate where it is non-negligible
    scale = np.maximum(want, np.max(want, axis=0, keepdims=True) * 1e-2 + 1e-9)
    rel = np.abs(got - want) / scale
    assert rel.max() < 2e-2, rel.max()


@pytest.mark.slow


def test_transmittance_to_space_matches_brute_force():
    rng = np.random.default_rng(11)
    # upward-ish rays from random altitudes (NEE geometry: never occluded)
    n = 32
    alts = rng.uniform(0.0, 80e3, n)
    pos = []
    dirs = []
    for alt in alts:
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        p = (C.PLANET_R + alt) * u
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        if np.dot(d, u) < 0.05:  # keep above the horizon
            d = d - 2.0 * np.dot(d, u) * u
            d = d if np.dot(d, u) > 0.05 else u
        pos.append(p)
        dirs.append(d)
    pos_np = np.stack(pos)
    dirs_np = np.stack(dirs)

    wavelength = jnp.asarray(rng.uniform(400.0, 700.0, (n, 1)), dtype=jnp.float32)
    from digital_earth.assets.luts import load_spectral_luts

    luts = load_spectral_luts()
    ext = jnp.stack(
        [
            vol.spectra_extinction_rayleigh(wavelength),
            vol.spectra_extinction_mie(wavelength),
            vol.spectra_extinction_ozone(wavelength, luts.o3_crossec),
        ],
        axis=-1,
    )  # (n, 1, 3)
    got = np.asarray(
        atm.rmo_transmittance_to_space(
            ext, jnp.asarray(pos_np, dtype=jnp.float32),
            jnp.asarray(dirs_np, dtype=jnp.float32),
        )
    )[:, 0]

    for i in range(n):
        b = np.dot(pos_np[i], dirs_np[i])
        r2 = np.dot(pos_np[i], pos_np[i])
        t_exit = -b + np.sqrt(b * b - (r2 - C.ATMOS_UPPER_LIMIT**2))
        d_int = _brute_force_integral(pos_np[i], dirs_np[i], 0.0, t_exit)
        tau = float(np.dot(np.asarray(ext)[i, 0], d_int))
        want = np.exp(-tau)
        assert abs(got[i] - want) < 5e-3 * max(want, 1e-3) + 1e-5, (
            i, got[i], want,
        )


def test_density_envelope_bounds_density_above():
    """env_c(h0) must bound rho_c(h) for every h >= h0 (the delta-tracking
    majorant correctness condition)."""
    h_grid = jnp.asarray(np.linspace(0.0, 120e3, 4001), dtype=jnp.float32)
    rho = np.asarray(vol.get_density(h_grid))  # (n, 3)
    env = np.asarray(atm.density_envelope(h_grid))
    # running max of rho from the top (max over h' >= h)
    tail_max = np.maximum.accumulate(rho[::-1], axis=0)[::-1]
    assert (env * (1.0 + 1e-5) + 1e-12 >= tail_max).all(), (
        np.max((tail_max - env) / np.maximum(env, 1e-12))
    )


def test_segment_min_radius():
    rng = np.random.default_rng(3)
    rp = jnp.asarray(rng.uniform(0.0, atm.R_TOP, 64), dtype=jnp.float32)
    x_t = jnp.asarray(rng.uniform(-2e6, 2e6, 64), dtype=jnp.float32)
    x_e = x_t + jnp.asarray(rng.uniform(0.0, 3e6, 64), dtype=jnp.float32)
    got = np.asarray(atm.segment_min_radius(rp, x_t, x_e))
    xs = np.linspace(np.asarray(x_t), np.asarray(x_e), 20001)
    want = np.sqrt(np.asarray(rp)[None, :] ** 2 + xs**2).min(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_envelope_majorizes_on_random_segments():
    """End-to-end majorant check: for random segments, the envelope at the
    segment's minimum altitude bounds the true density everywhere on it."""
    rng = np.random.default_rng(5)
    segs = _random_segments(rng, 30)
    for pos, d, t0, t1 in segs:
        cr = np.cross(pos, d)
        rp = np.linalg.norm(cr)
        xp = np.dot(pos, d)
        r_min = float(
            atm.segment_min_radius(
                jnp.asarray(rp, dtype=jnp.float32),
                jnp.asarray(t0 + xp, dtype=jnp.float32),
                jnp.asarray(t1 + xp, dtype=jnp.float32),
            )
        )
        env = np.asarray(
            atm.density_envelope(jnp.asarray(r_min - C.PLANET_R, dtype=jnp.float32))
        )
        ts = np.linspace(t0, t1, 5000)
        pts = pos[None, :] + ts[:, None] * d[None, :]
        h = np.maximum(np.linalg.norm(pts, axis=-1) - C.PLANET_R, 0.0)
        rho = np.stack(
            [
                np.asarray(vol.get_rayl_density(h)),
                np.asarray(vol.get_mie_density(h)),
                np.asarray(vol.get_ozone_density(h)),
            ],
            axis=-1,
        )
        assert (rho <= env[None, :] * (1.0 + 5e-4) + 1e-12).all()
