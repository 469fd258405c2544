"""Atmospheric volume models: phase functions + samplers, spectral extinction
coefficients, and density profiles.

Physics matches the reference lib/volume_rendering_models.py (cited per
function) but everything is batched jnp operating on wavefront arrays.

The Draine phase sampler follows the exact closed form published by
Jendersie & d'Eon, "An Approximate Mie Scattering Function for Fog and Cloud
Rendering" (SIGGRAPH 2023 talk; supplemental listing, MIT licensed) — the same
source the reference credits at volume_rendering_models.py:100-152.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from .. import constants as C
from ..ops.math_utils import make_orthonormal_basis, spherical_direction, sqr
from ..ops.sampling import sample_sphere

# ---------------------------------------------------------------------------
# Refractive index of air (reference volume_rendering_models.py:48-51);
# wavelength argument in micrometers.
# ---------------------------------------------------------------------------


def air_ior(wavelength_um):
    rcp_wl_sqr = 1.0 / (wavelength_um * wavelength_um)
    return (
        1.0
        + 8.06051e-5
        + 2.480990e-2 / (132.274 - rcp_wl_sqr)
        + 1.74557e-4 / (39.32957 - rcp_wl_sqr)
    )


# ---------------------------------------------------------------------------
# Phase functions (all normalized over the sphere; cos_theta = dir . light)
# ---------------------------------------------------------------------------


def rayleigh_phase(cos_theta):
    """Reference volume_rendering_models.py:61-63."""
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)


def klein_nishina_phase(cos_theta, e):
    """Reference volume_rendering_models.py:87-89."""
    return e / (
        2.0 * math.pi * (e * (1.0 - cos_theta) + 1.0) * jnp.log(2.0 * e + 1.0)
    )


def mie_phase(cos_theta):
    """Klein-Nishina with e=3000 (reference volume_rendering_models.py:65-67)."""
    return klein_nishina_phase(cos_theta, C.MIE_ASYMMETRY)


def hg_phase(cos_theta, g):
    """Henyey-Greenstein (reference volume_rendering_models.py:73-76)."""
    return (1.0 - g * g) / (
        4.0 * math.pi * jnp.power(1.0 + g * g - 2.0 * g * cos_theta, 1.5)
    )


def draine_phase(cos_theta, g, a):
    """Draine (1-parameter-extended HG) phase
    (reference volume_rendering_models.py:121-123)."""
    return ((1.0 - g * g) * (1.0 + a * cos_theta * cos_theta)) / (
        4.0
        * (1.0 + (a * (1.0 + 2.0 * g * g)) / 3.0)
        * math.pi
        * jnp.power(1.0 + g * g - 2.0 * g * cos_theta, 1.5)
    )


# Cloud droplet phase parameters for d = 8 um droplets, evaluated from the
# Jendersie & d'Eon fits (reference volume_rendering_models.py:154-183).
_D = C.CLOUD_DROPLET_SIZE
CLOUD_G_HG_FULL = math.exp(-0.0990567 / (_D - 1.67154))
CLOUD_G_HG_REDUCED = 0.91  # reduced forward peak once multi-scattering starts
CLOUD_G_DRAINE = math.exp(-2.20679 / (_D + 3.91029) - 0.428934)
CLOUD_ALPHA_DRAINE = math.exp(3.62489 - 8.29288 / (_D + 5.52825))
CLOUD_W_DRAINE = math.exp(-0.599085 / (_D - 0.641583) - 0.665888)


def cloud_phase(cos_theta, reduce_peak):
    """HG (+) Draine mixture for cloud droplets; ``reduce_peak`` is a traced
    bool array selecting the multi-scatter 0.91 HG peak
    (reference volume_rendering_models.py:154-162)."""
    g_hg = jnp.where(reduce_peak, CLOUD_G_HG_REDUCED, CLOUD_G_HG_FULL)
    return (
        hg_phase(cos_theta, g_hg) * (1.0 - CLOUD_W_DRAINE)
        + draine_phase(cos_theta, CLOUD_G_DRAINE, CLOUD_ALPHA_DRAINE)
        * CLOUD_W_DRAINE
    )


# ---------------------------------------------------------------------------
# Phase samplers — pure functions of uniform variates.
# ---------------------------------------------------------------------------


def _direction_about(view, cos_theta, u_phi):
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * math.pi * u_phi
    tang, bitang = make_orthonormal_basis(view)
    return spherical_direction(sin_theta, cos_theta, phi, tang, bitang, view)


def sample_hg_cos(u, g):
    """Inverse-CDF cos(theta) for HG (reference volume_rendering_models.py:79-85)."""
    sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
    return (1.0 + g * g - sqr_term * sqr_term) / (2.0 * g)


def sample_hg_phase(u0, u1, view, g):
    return _direction_about(view, sample_hg_cos(u0, g), u1)


def sample_klein_nishina_cos(u, e):
    """Reference volume_rendering_models.py:92-93."""
    return (-jnp.power(2.0 * e + 1.0, 1.0 - u) + e + 1.0) / e


def sample_klein_nishina_phase(u0, u1, view, e):
    return _direction_about(view, sample_klein_nishina_cos(u0, e), u1)


def sample_mie_phase(u0, u1, view):
    return sample_klein_nishina_phase(u0, u1, view, C.MIE_ASYMMETRY)


def sample_draine_cos(u, g, a):
    """Exact Draine inverse-CDF cos(theta) (Jendersie & d'Eon 2023, supplemental;
    reference volume_rendering_models.py:125-150)."""
    g2 = g * g
    g3 = g * g2
    g4 = g2 * g2
    g6 = g2 * g4
    pgp1_2 = (1.0 + g2) * (1.0 + g2)
    t1a = -a + a * g4
    t1a3 = t1a * t1a * t1a
    t2 = -1296.0 * (-1.0 + g2) * (a - a * g2) * t1a * (4.0 * g2 + a * pgp1_2)
    t3 = 3.0 * g2 * (1.0 + g * (-1.0 + 2.0 * u)) + a * (
        2.0 + g2 + g3 * (1.0 + 2.0 * g2) * (-1.0 + 2.0 * u)
    )
    t4a = 432.0 * t1a3 + t2 + 432.0 * (a - a * g2) * t3 * t3
    t4b = -144.0 * a * g2 + 288.0 * a * g4 - 144.0 * a * g6
    t4b3 = t4b * t4b * t4b
    t4 = t4a + jnp.sqrt(jnp.maximum(-4.0 * t4b3 + t4a * t4a, 0.0))
    t4p3 = jnp.power(t4, 1.0 / 3.0)
    cbrt2 = 2.0 ** (1.0 / 3.0)
    t6 = (
        2.0 * t1a
        + (48.0 * cbrt2 * (-(a * g2) + 2.0 * a * g4 - a * g6)) / t4p3
        + t4p3 / (3.0 * cbrt2)
    ) / (a - a * g2)
    t5 = 6.0 * (1.0 + g2) + t6
    cos_theta = (
        1.0
        + g2
        - jnp.power(
            -0.5 * jnp.sqrt(jnp.maximum(t5, 0.0))
            + jnp.sqrt(
                jnp.maximum(
                    6.0 * (1.0 + g2)
                    - (8.0 * t3) / (a * (-1.0 + g2) * jnp.sqrt(jnp.maximum(t5, 1e-20)))
                    - t6,
                    0.0,
                )
            )
            / 2.0,
            2.0,
        )
    ) / (2.0 * g)
    return jnp.clip(cos_theta, -1.0, 1.0)


def sample_draine(u0, u1, view, g, a):
    return _direction_about(view, sample_draine_cos(u0, g, a), u1)


def sample_cloud_phase(u_mix, u0, u1, view, reduce_peak):
    """Mixture sampler for the cloud phase (reference
    volume_rendering_models.py:166-183). ``u_mix`` picks the lobe."""
    g_hg = jnp.where(reduce_peak, CLOUD_G_HG_REDUCED, CLOUD_G_HG_FULL)
    cos_draine = sample_draine_cos(u0, CLOUD_G_DRAINE, CLOUD_ALPHA_DRAINE)
    cos_hg = sample_hg_cos(u0, g_hg)
    cos_theta = jnp.where(u_mix < CLOUD_W_DRAINE, cos_draine, cos_hg)
    return _direction_about(view, cos_theta, u1)


def sample_phase_dirs(u_mix, u0, u1, view, interaction_id, reduce_peak):
    """Wavefront phase sampling for all interaction species at once.

    Computes every sampler (cheap elementwise math) and selects per lane — the
    wavefront equivalent of the reference's per-thread branch
    (pathtracer.py:249-261). Returns (direction, phase_div_pdf).
    """
    sphere_dir = sample_sphere(u0, u1)
    mie_dir = sample_mie_phase(u0, u1, view)
    cloud_dir = sample_cloud_phase(u_mix, u0, u1, view, reduce_peak)

    is_rayleigh = interaction_id == C.RAYLEIGH_ID
    is_iso = interaction_id == C.ISOTROPIC_CLOUD_ID
    is_mie = interaction_id == C.MIE_ID
    uniform = is_rayleigh | is_iso

    direction = jnp.where(
        uniform[..., None], sphere_dir, jnp.where(is_mie[..., None], mie_dir, cloud_dir)
    )

    cos_theta = jnp.sum(view * sphere_dir, axis=-1)
    iso_phase = 1.0 / (4.0 * math.pi)
    uni_phase = jnp.where(is_iso, iso_phase, rayleigh_phase(cos_theta))
    # uniform-sphere pdf is 1/(4pi); mie/cloud importance samplers cancel
    phase_div_pdf = jnp.where(uniform, uni_phase * (4.0 * math.pi), 1.0)
    return direction, phase_div_pdf


def evaluate_phase(ray_dir, light_dir, interaction_id, reduce_peak):
    """Phase value toward ``light_dir`` per lane (reference pathtracer.py:235-247)."""
    cos_theta = jnp.sum(ray_dir * light_dir, axis=-1)
    phase = jnp.where(
        interaction_id == C.RAYLEIGH_ID,
        rayleigh_phase(cos_theta),
        jnp.where(
            interaction_id == C.MIE_ID,
            mie_phase(cos_theta),
            jnp.where(
                interaction_id == C.CLOUD_ID,
                cloud_phase(cos_theta, reduce_peak),
                jnp.where(
                    interaction_id == C.ISOTROPIC_CLOUD_ID,
                    1.0 / (4.0 * math.pi),
                    0.0,
                ),
            ),
        ),
    )
    return phase


# ---------------------------------------------------------------------------
# Spectral extinction coefficients (wavelength in nm)
# ---------------------------------------------------------------------------


def spectra_extinction_mie2(wavelength):
    """Simpler 1/lambda aerosol model — present but unused in the reference
    (volume_rendering_models.py:189-192); kept for capability parity."""
    return 0.0009 / wavelength


def spectra_extinction_mie(wavelength):
    """Junge/turbidity aerosol extinction
    (reference volume_rendering_models.py:195-200)."""
    junge = 4.0
    c = (0.6544 * C.TURBIDITY - 0.6510) * 4e-18
    k = (0.773335 - 0.00386891 * wavelength) / (1.0 - 0.00546759 * wavelength)
    return (
        0.434
        * c
        * math.pi
        * jnp.power(2.0 * math.pi / (wavelength * 1e-9), junge - 2.0)
        * k
    )


def spectra_extinction_rayleigh(wavelength):
    """Rayleigh extinction from the air IOR + King depolarization factor
    (reference volume_rendering_models.py:203-217)."""
    wavelength_m = wavelength * 1e-9
    f_n2 = 1.034 + 3.17e-4 / sqr(wavelength)
    f_o2 = 1.096 + 1.385e-3 / sqr(wavelength) + 1.448e-4 / sqr(sqr(wavelength))
    cco2 = 0.0421
    king_factor = (78.084 * f_n2 + 20.946 * f_o2 + 0.934 + cco2 * 1.15) / (
        78.084 + 20.946 + 0.934 + cco2
    )
    n = sqr(air_ior(wavelength * 1e-3)) - 1.0
    return (
        (8.0 * math.pi**3 * sqr(n))
        / (3.0 * C.AIR_NUM_DENSITY * jnp.power(wavelength_m, 4.0))
    ) * king_factor


def spectra_extinction_ozone(wavelength, o3_crossec_lut):
    """Ozone absorption from the measured cross-section LUT, 390-831 nm
    (reference volume_rendering_models.py:219-224)."""
    idx = jnp.clip((wavelength - 390.0).astype(jnp.int32), 0, o3_crossec_lut.shape[0] - 1)
    in_range = (wavelength >= 390.0) & (wavelength < 831.0)
    return jnp.where(in_range, 1e-4 * C.OZONE_NUM_DENSITY * o3_crossec_lut[idx], 0.0)


# ---------------------------------------------------------------------------
# Density profiles (h = elevation above sea level in meters)
# ---------------------------------------------------------------------------


def get_ozone_density(h):
    """Dual-exponential fit peaking at 25 km
    (reference volume_rendering_models.py:229-246)."""
    h_km = h * 0.001
    rel = h_km - C.OZONE_PEAK_HEIGHT * 0.001
    rel2 = rel * rel
    d = (1.0 - 0.375) * jnp.exp(-rel2 / 49.0)
    d = d + 0.375 * jnp.exp(-rel2 / 256.0)
    d = d + jnp.maximum(0.0, -0.000015 * jnp.power(h_km - 15.0, 3.0))
    return d


def get_rayl_density(h):
    """Gaussian fit to the US Standard Atmosphere
    (reference volume_rendering_models.py:248-252)."""
    density_sea_level = 1.225
    return 3.68082 * jnp.exp(-sqr(h + 24239.99) / 532307548.4168) / density_sea_level


def get_mie_density(h):
    """Piecewise OPAC aerosol profile (reference volume_rendering_models.py:254-267)."""
    d_high = 0.0918 * jnp.exp(-1.0e-6 * sqr(h - 11500.0))
    d_mid = 0.3000 * jnp.exp(-2.5e-9 * sqr(h + 2500.0)) - 0.092
    d_low = 0.6500 * jnp.exp(-5.0e-6 * sqr(h - 1300.0)) + 0.18899
    d_ground = 1.0 - h / 8136.646
    dens = jnp.where(
        h > 11500.0,
        d_high,
        jnp.where(h > 2400.0, d_mid, jnp.where(h > 1300.0, d_low, d_ground)),
    )
    return dens * C.TURBIDITY


def get_density(h):
    """(rayleigh, mie, ozone) densities, elevation clamped at 0
    (reference volume_rendering_models.py:270-273)."""
    h = jnp.maximum(h, 0.0)
    return jnp.stack(
        [get_rayl_density(h), get_mie_density(h), get_ozone_density(h)], axis=-1
    )


def get_elevation(pos):
    """Elevation above the sphere of radius PLANET_R
    (reference volume_rendering_models.py:275-277)."""
    return jnp.sqrt(jnp.sum(pos * pos, axis=-1)) - C.PLANET_R
