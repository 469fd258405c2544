"""Semi-analytic atmosphere integrals: a precomputed density-integral table
and monotone density envelopes.

The reference estimates RMO (Rayleigh/Mie/ozone) transmittance by ratio
tracking and free-flight distances by delta tracking against a *global
sea-level* majorant (reference pathtracer.py:77-143, 336-337). Both are
Monte-Carlo loops; for rays high in the atmosphere the sea-level majorant
overestimates the local extinction by orders of magnitude, costing thousands
of null collisions. But the RMO densities are smooth closed-form profiles of
altitude only (reference lib/volume_rendering_models.py:229-267) — this
design replaces the loops with precomputed line integrals, the standard
sky-rendering approach (cf. Bruneton & Neyret 2008):

- ``atmos_density_table()`` tabulates, per species, the cumulative density
  line integral F(rp, x) = ∫ rho(sqrt(rp^2 + xi^2)) dxi along a ray with
  perigee radius rp, measured from the perigee. Any segment integral on any
  ray is a difference of two bilinear table lookups (exploiting F's oddness
  in x), so NEE transmittance toward the sun becomes one closed-form
  ``exp(-k . D)`` — *zero variance*, no loop — and is exact for every
  wavelength of a hero packet at once (the per-species density integrals D
  are wavelength-independent; only the extinction coefficients k differ).

- ``density_envelope(h)`` gives per-species monotone-from-above bounds
  env_c(h) >= rho_c(h') for all h' >= h, enabling *local* delta-tracking
  majorants that re-tighten as a ray ascends (the remaining segment's
  minimum altitude is analytic), which collapses null-collision counts for
  the space/limb rays that dominate orbital views.

Delta tracking with these majorants remains exactly unbiased (any majorant
>= the true extinction is valid); the table-based transmittance carries only
tabulation error, validated against brute-force quadrature in
tests/test_atmosphere_lut.py.
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..ops.math_utils import HIGHEST
from ..ops.texture import Tex2D, _fetch_texel
from . import volume as vol

# Table geometry. R_LO sits below the deepest point a ray segment can reach
# (the ocean surface is at PLANET_R; land is displaced upward), so underground
# contamination of F cancels in all physically reachable segment differences.
R_TOP = float(C.ATMOS_UPPER_LIMIT)
R_LO = float(C.PLANET_R) - 8e3
N_RP = 384  # perigee-radius rows
N_X = 1024  # distance-from-perigee columns per row
_BUILD_SUBSTEPS = 16  # fine integration substeps per table cell

# Perigee-row allocation. F's sensitivity to rp scales with the chord
# obliquity 1/sqrt(1 - (rp/r)^2): for a query at radius r, rows must be
# spaced finer than ~0.2x the perigee's depth below r. Queries live at
# r >= PLANET_R, so below the shell the required spacing grows with depth —
# rows are log-spaced in depth d = R_LO - rp from _D_MIN down to the center.
# Inside the shell [R_LO, R_TOP] rows are uniform at sub-km spacing.
_N_DEEP = 120  # rows below R_LO (log-spaced depth)
_D_MIN = 0.5e3  # shallowest log-zone depth
_LOG_RATIO = float(np.log(R_LO / _D_MIN))


def _index_to_rp(i):
    """Row index (float, vectorized) -> perigee radius."""
    i = jnp.asarray(i, dtype=jnp.float32)
    shell = R_LO + (i - _N_DEEP) / (N_RP - 1 - _N_DEEP) * (R_TOP - R_LO)
    t = (_N_DEEP - i) / _N_DEEP  # 1 at row 0 (rp=0) ... 0 at row _N_DEEP
    deep = R_LO - _D_MIN * jnp.exp(t * _LOG_RATIO)
    return jnp.where(i < _N_DEEP, deep, shell)


def _rp_to_index(rp):
    """Perigee radius -> continuous row index (inverse of _index_to_rp).
    Depths shallower than _D_MIN land on the rp = R_LO row, whose
    radius-aligned evaluation stays accurate (see _f_eval)."""
    shell_idx = _N_DEEP + (rp - R_LO) / (R_TOP - R_LO) * (N_RP - 1 - _N_DEEP)
    depth = jnp.clip(R_LO - rp, _D_MIN, R_LO)
    deep_idx = _N_DEEP * (1.0 - jnp.log(depth / _D_MIN) / _LOG_RATIO)
    return jnp.clip(
        jnp.where(rp < R_LO - _D_MIN, deep_idx, jnp.maximum(shell_idx, _N_DEEP)),
        0.0,
        N_RP - 1.0,
    )


def _row_x_bounds(rp):
    """Per-row x-grid bounds: [x_lo, x_hi] spans exactly the radii where the
    atmosphere lives (R_LO..R_TOP), so every row resolves the shell."""
    x_lo = jnp.sqrt(jnp.maximum(R_LO * R_LO - rp * rp, 0.0))
    x_hi = jnp.sqrt(jnp.maximum(R_TOP * R_TOP - rp * rp, 0.0))
    return x_lo, x_hi


@lru_cache(maxsize=1)
def atmos_density_table():
    """(N_RP, N_X, 3) float32: cumulative per-species density integrals
    F_c(rp_i, x_j) = ∫_{x_lo(i)}^{x_j} rho_c(sqrt(rp_i^2 + xi^2)) dxi,
    on each row's uniform x-grid over [x_lo(i), x_hi(i)].

    Built once by fine trapezoid quadrature (_BUILD_SUBSTEPS per cell) of the
    closed-form density profiles (models/volume.py:303-348); numpy-only and
    disk-cached (~/.cache/digital_earth), so a jit trace embedding it
    pays an np.load, not a rebuild.
    """
    with jax.ensure_compile_time_eval():
        return jnp.asarray(_build_table())


@lru_cache(maxsize=1)
def _table_tex() -> Tex2D:
    """The density-integral table packed into the row-gather layout
    (ops/texture.Tex2D): a 3-channel texel fetch is ONE aligned 128-lane
    row gather, the layout every texture of this renderer shares (whether
    a plain element gather is faster on the GPU is still to be measured)."""
    with jax.ensure_compile_time_eval():
        # f32 storage: the builder's f64 is for accumulation accuracy only;
        # f64 rows would double-to-octuple every row-gather's bytes
        return Tex2D.from_array(_build_table())


@lru_cache(maxsize=1)
def _row_totals():
    """(N_RP, 1, 3) full-row integrals F_c(rp_i, x_hi(i)) — the to-space
    query's endpoint, fetched from a tiny dedicated table instead of the
    wide one."""
    with jax.ensure_compile_time_eval():
        return Tex2D.from_array(_build_table()[:, -1:, :])


def _np_densities(h):
    """Numpy (f64) twins of the closed-form density profiles
    (models/volume.get_*_density) for the offline table build: evaluating
    the jnp originals op-by-op under ensure_compile_time_eval costs one
    eager mini-compile per op, which dominated the render step's trace."""
    rayl = 3.68082 * np.exp(-((h + 24239.99) ** 2) / 532307548.4168) / 1.225
    d_high = 0.0918 * np.exp(-1.0e-6 * (h - 11500.0) ** 2)
    d_mid = 0.3000 * np.exp(-2.5e-9 * (h + 2500.0) ** 2) - 0.092
    d_low = 0.6500 * np.exp(-5.0e-6 * (h - 1300.0) ** 2) + 0.18899
    d_ground = 1.0 - h / 8136.646
    mie = np.where(
        h > 11500.0,
        d_high,
        np.where(h > 2400.0, d_mid, np.where(h > 1300.0, d_low, d_ground)),
    ) * float(C.TURBIDITY)
    h_km = h * 0.001
    rel2 = (h_km - float(C.OZONE_PEAK_HEIGHT) * 0.001) ** 2
    o3 = (
        (1.0 - 0.375) * np.exp(-rel2 / 49.0)
        + 0.375 * np.exp(-rel2 / 256.0)
        + np.maximum(0.0, -0.000015 * (h_km - 15.0) ** 3)
    )
    return rayl, mie, o3


# bump when the table geometry or the density profiles change
_TABLE_CACHE_TAG = (
    f"v2-{N_RP}x{N_X}s{_BUILD_SUBSTEPS}-d{_N_DEEP}-"
    f"{R_LO:.0f}-{R_TOP:.0f}-t{float(C.TURBIDITY):g}"
)


@lru_cache(maxsize=1)
def _build_table():
    cache_dir = os.path.join(
        os.path.expanduser("~"), ".cache", "digital_earth"
    )
    cache_path = os.path.join(cache_dir, f"atmos_table_{_TABLE_CACHE_TAG}.npy")
    if os.path.exists(cache_path):
        return np.load(cache_path)
    i = np.arange(N_RP, dtype=np.float64)
    shell = R_LO + (i - _N_DEEP) / (N_RP - 1 - _N_DEEP) * (R_TOP - R_LO)
    t = (_N_DEEP - i) / _N_DEEP
    rp = np.where(i < _N_DEEP, R_LO - _D_MIN * np.exp(t * _LOG_RATIO), shell)
    x_lo = np.sqrt(np.maximum(R_LO * R_LO - rp * rp, 0.0))
    x_hi = np.sqrt(np.maximum(R_TOP * R_TOP - rp * rp, 0.0))
    n_fine = (N_X - 1) * _BUILD_SUBSTEPS + 1
    frac = np.linspace(0.0, 1.0, n_fine)
    xs = x_lo[:, None] + (x_hi - x_lo)[:, None] * frac[None, :]  # (N_RP, n_fine)
    r = np.sqrt(rp[:, None] ** 2 + xs**2)
    h = np.maximum(r - C.PLANET_R, 0.0)
    rho = np.stack(_np_densities(h), axis=-1)  # (N_RP, n_fine, 3) f64
    dx = ((x_hi - x_lo) / (n_fine - 1))[:, None, None]
    cells = 0.5 * (rho[:, 1:] + rho[:, :-1]) * dx
    f_fine = np.concatenate(
        [np.zeros((N_RP, 1, 3)), np.cumsum(cells, axis=1)], axis=1
    )
    table = np.ascontiguousarray(
        f_fine[:, ::_BUILD_SUBSTEPS].astype(np.float32)
    )  # (N_RP, N_X, 3)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cache_path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, table)
        os.replace(tmp, cache_path)
    except OSError:
        pass  # cache is best-effort
    return table


def _f_eval(table, rp, x_abs):
    """Bilinear F(rp, |x|) -> (..., 3) per-species integrals from perigee-side
    start.

    Interpolation across perigee rows is *radius-aligned*: each bracketing
    row is evaluated at the x whose radius equals the query's radius
    (xi^2 = x^2 + (rp - rp_i)(rp + rp_i), a cancellation-free form), because
    F at fixed radius varies slowly with rp while F at fixed x does not —
    the density is a steep function of radius. x below/above a row's grid
    clamps to 0 / the row's full integral.

    Fetches go through the row-gather table layout (_table_tex): 4 aligned
    128-lane row gathers per eval. The ``table`` argument is accepted for
    API compatibility but the packed layout is always used."""
    del table
    tex = _table_tex()
    i_f = _rp_to_index(rp)
    i0 = jnp.clip(jnp.floor(i_f).astype(jnp.int32), 0, N_RP - 2)
    wi = (i_f - i0.astype(i_f.dtype))[..., None]

    def row_val(i):
        rp_i = _index_to_rp(i)
        xi = jnp.sqrt(
            jnp.maximum(x_abs * x_abs + (rp - rp_i) * (rp + rp_i), 0.0)
        )
        x_lo, x_hi = _row_x_bounds(rp_i)
        u = jnp.clip(
            (xi - x_lo) / jnp.maximum(x_hi - x_lo, 1.0), 0.0, 1.0
        ) * (N_X - 1)
        j0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, N_X - 2)
        wj = (u - j0.astype(u.dtype))[..., None]
        v0 = _fetch_texel(tex, i, j0)
        v1 = _fetch_texel(tex, i, j0 + 1)
        return v0 * (1.0 - wj) + v1 * wj

    return row_val(i0) * (1.0 - wi) + row_val(i0 + 1) * wi


def _ray_perigee(pos, direction):
    """(rp, x0): perigee radius and the signed distance of ``pos`` from the
    perigee along the ray. Computed from the cross product, which stays
    well-conditioned in float32 where r^2 - (p.d)^2 would cancel."""
    cr = jnp.cross(pos, direction)
    rp = jnp.sqrt(jnp.sum(cr * cr, axis=-1))
    x0 = jnp.sum(pos * direction, axis=-1)
    return rp, x0


def density_integral_to_space(pos, direction, table=None):
    """(..., 3) per-species density line integrals from ``pos`` along
    ``direction`` to the top of the atmosphere (the ray must not hit the
    planet — NEE callers exclude occluded rays first)."""
    rp, x0 = _ray_perigee(pos, direction)
    f_end = _f_tot(rp)  # interpolated full-row integral
    f0 = jnp.sign(x0)[..., None] * _f_eval(table, rp, jnp.abs(x0))
    return jnp.maximum(f_end - f0, 0.0)


def _f_tot(rp):
    """F(rp, x_hi) -> (..., 3): the full-row integral, linear in rp across
    the bracketing rows (2 row gathers from the tiny totals table)."""
    tot = _row_totals()
    i_f = _rp_to_index(rp)
    i0 = jnp.clip(jnp.floor(i_f).astype(jnp.int32), 0, N_RP - 2)
    wi = (i_f - i0.astype(i_f.dtype))[..., None]
    zero = jnp.zeros_like(i0)
    v0 = _fetch_texel(tot, i0, zero)
    v1 = _fetch_texel(tot, i0 + 1, zero)
    return v0 * (1.0 - wi) + v1 * wi


def density_integral_segment(pos, direction, t0, t1, table=None):
    """(..., 3) per-species density integrals over ray parameter [t0, t1]."""
    if table is None:
        table = atmos_density_table()
    rp, xp = _ray_perigee(pos, direction)
    x0 = t0 + xp
    x1 = t1 + xp
    f0 = jnp.sign(x0)[..., None] * _f_eval(table, rp, jnp.abs(x0))
    f1 = jnp.sign(x1)[..., None] * _f_eval(table, rp, jnp.abs(x1))
    return jnp.maximum(f1 - f0, 0.0)


def rmo_transmittance_to_space(ext_rmo, pos, direction, table=None):
    """Exact per-wavelength RMO transmittance from ``pos`` to space.

    ext_rmo: (n, L, 3) per-wavelength extinction coefficients; returns
    (n, L) = exp(-sum_c k_c(lambda) * D_c). Replaces the reference's
    ratio-tracked sun transmittance (pathtracer.py:117-143) with a
    zero-variance closed form."""
    d = density_integral_to_space(pos, direction, table)  # (n, 3)
    tau = jnp.einsum("nlc,nc->nl", ext_rmo, d, precision=HIGHEST)
    return jnp.exp(-tau)


def sample_flight_distance(
    u, pos, direction, t_start, t_max, ext_h, n_iter: int = 14
):
    """Exact RMO free-flight sampling by CDF inversion on the table.

    Delta tracking (reference pathtracer.py:77-115) draws the free-flight
    distance from pdf sigma(t) exp(-tau(t)) with a rejection loop whose trip
    count is majorant-dependent and worst-lane-paced. But tau(t) along any
    ray is a closed form here (density-integral table), so the same
    distribution can be sampled *exactly*: draw one uniform, solve
    tau(t) = -ln(u) with a fixed-count safeguarded Newton/bisection
    iteration (tau is strictly increasing inside the shell; the derivative
    is the analytic extinction). No RNG in the loop, no null collisions, no
    variance in the trip count — every lane runs exactly ``n_iter``
    uniform elementwise+gather steps.

    Args:
      u: (n,) uniforms. pos/direction: (n, 3). t_start/t_max: (n,) span
        (t_max may be < t_start or negative: no span). ext_h: (n, 3) hero
        extinction coefficients.
    Returns:
      (t, collided, tau_total): the sampled distance (= span end when no
      collision), whether a collision happened inside the span, and the
      span's total hero optical depth.
    """
    valid = (t_max >= 0.0) & (t_start < t_max)
    t_end = jnp.where(valid, t_max, t_start)
    rp, xp = _ray_perigee(pos, direction)

    x0 = t_start + xp
    f0 = jnp.sign(x0)[..., None] * _f_eval(None, rp, jnp.abs(x0))  # (n, 3)

    def tau_at(t):
        x = t + xp
        f = jnp.sign(x)[..., None] * _f_eval(None, rp, jnp.abs(x))
        d = jnp.maximum(f - f0, 0.0)
        return jnp.sum(ext_h * d, axis=-1)

    tau_total = tau_at(t_end)
    target = -jnp.log(jnp.maximum(u, 1e-12))
    collided = valid & (target < tau_total)

    def body(_, carry):
        t, lo, hi = carry
        f = tau_at(t) - target
        h = jnp.maximum(jnp.sqrt(rp * rp + (t + xp) ** 2) - C.PLANET_R, 0.0)
        sigma = jnp.sum(ext_h * vol.get_density(h), axis=-1)
        lo = jnp.where(f <= 0.0, t, lo)
        hi = jnp.where(f > 0.0, t, hi)
        t_n = t - f / jnp.maximum(sigma, 1e-30)
        ok = (t_n > lo) & (t_n < hi) & jnp.isfinite(t_n)
        t = jnp.where(ok, t_n, 0.5 * (lo + hi))
        return (t, lo, hi)

    init = (0.5 * (t_start + t_end), t_start, t_end)
    t, _, _ = jax.lax.fori_loop(0, n_iter, body, init)
    t = jnp.clip(t, t_start, t_end)
    return jnp.where(collided, t, t_end), collided, tau_total


# ---------------------------------------------------------------------------
# Monotone density envelopes for local delta-tracking majorants
# ---------------------------------------------------------------------------

# Ozone profile peak (reference volume_rendering_models.py:229-246 peaks at
# OZONE_PEAK_HEIGHT); evaluated once, with margin for the cubic low-altitude
# term's contribution near the peak.
_O3_ENV_PEAK = float(
    np.max(np.asarray(vol.get_ozone_density(np.linspace(0.0, 60e3, 4096))))
)
# The aerosol profile's OPAC branches are each monotone-decreasing for h >= 0
# but the h=11500 branch switch steps *up* by a hair; the high branch never
# exceeds this plateau (reference volume_rendering_models.py:254-267).
_MIE_ENV_PLATEAU = 0.0918 * float(C.TURBIDITY)


# The OPAC mie profile's Gaussian tails fall several %/meter at altitude, so
# sub-meter float32 rounding in a segment's minimum radius could nudge the
# density above a margin-free envelope. Evaluating the envelope a few meters
# low guarantees majorization (a slightly loose majorant is still unbiased).
_ENV_SAFETY_M = 8.0


def density_envelope(h):
    """(..., 3) per-species envelopes: env_c(h) >= rho_c(h') for all h' >= h
    (up to float32 rounding of h, absorbed by _ENV_SAFETY_M).

    Used to build *local* delta-tracking majorants from the minimum altitude
    of the remaining ray segment. Rayleigh's Gaussian fit peaks below sea
    level, so its own value is the envelope; mie needs the branch-switch
    plateau; ozone is flat at its peak value below the peak altitude."""
    h = jnp.maximum(h - _ENV_SAFETY_M, 0.0)
    env_r = vol.get_rayl_density(h)
    env_m = jnp.maximum(
        vol.get_mie_density(h),
        jnp.where(h <= 11500.0, _MIE_ENV_PLATEAU, 0.0),
    )
    env_o = jnp.where(
        h < C.OZONE_PEAK_HEIGHT, _O3_ENV_PEAK, vol.get_ozone_density(h)
    )
    return jnp.stack([env_r, env_m, env_o], axis=-1)


def segment_min_radius(rp, x_t, x_e):
    """Minimum radius over the sub-segment with perigee-frame coordinates
    [x_t, x_e] (x_t <= x_e): the perigee if the segment spans it, else the
    endpoint nearer the perigee."""
    spans = (x_t < 0.0) & (x_e > 0.0)
    end_min = jnp.sqrt(rp * rp + jnp.minimum(x_t * x_t, x_e * x_e))
    return jnp.where(spans, rp, end_min)
