"""Spectral colour machinery: blackbody SPDs, hero-wavelength sampling against
the CIE curves, sRGB<->spectrum conversion, sRGB transfer functions.

Rebuilt from the semantics of the reference lib/colour.py for batched JAX.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .math_utils import HIGHEST, dot, mix, saturate

# Column-major rows of the XYZ -> linear sRGB (D65) matrix
# (reference lib/colour.py:6-10).
XYZ_TO_RGB_D65 = np.array(
    [
        [3.2409699419, -1.5373831776, -0.4986107603],
        [-0.9692436363, 1.8759675015, 0.0415550574],
        [0.0556300797, -0.2039769589, 1.0569715142],
    ],
    dtype=np.float32,
)


def xyz_to_rgb(xyz):
    """Batched XYZ -> linear sRGB, trailing axis of size 3."""
    return jnp.matmul(
        xyz, jnp.asarray(XYZ_TO_RGB_D65).T, precision=HIGHEST
    )


def plancks(temperature, wavelength):
    """Blackbody SPD with the reference's nm-scaled constants
    (lib/colour.py:51-60). ``wavelength`` in nanometers."""
    h = 6.62607015e-16
    c = 2.9e17
    k = 1.38e-5
    p1 = 2.0 * h * c * c / wavelength**5
    p2 = jnp.exp((h * c) / (wavelength * k * temperature)) - 1.0
    return p1 / p2


def spectrum_sample(u, cie_cdf, cie_response):
    """Hero-wavelength sample by inverting the averaged-CMF CDF.

    The reference (lib/colour.py:12-48) runs an 8-step binary search over a
    bilinearly-sampled (441,2) CIE LUT texture; row v=0.25 holds the
    channel-cumulative CMF and row v=0.75 the XYZ response. Here we invert the
    same piecewise-linear CDF exactly with a vectorized ``searchsorted`` —
    equivalent up to the binary search's 2^-9 tolerance, with no iteration.

    Args:
      u: uniform variates, any batch shape.
      cie_cdf: (441, 3) per-channel cumulative CMF (LUT row v=0.25).
      cie_response: (441, 3) XYZ response per nm (LUT row v=0.75).

    Returns:
      (wavelength [nm, in [390, 831)], response[...,3], rcp_pdf)
    """
    res = cie_cdf.shape[0]
    # scalar CDF used by the reference's search: saturate(mean of channels)
    g = saturate(jnp.mean(cie_cdf, axis=-1))  # (441,), monotone in [0,1]
    idx = jnp.clip(jnp.searchsorted(g, u, side="left"), 1, res - 1)
    g0 = g[idx - 1]
    g1 = g[idx]
    frac = jnp.where(g1 > g0, (u - g0) / jnp.maximum(g1 - g0, 1e-12), 0.5)
    # continuous texture coordinate of the inverse CDF; texel centers at
    # (i + 0.5)/res to match the texture-space search of the reference
    mid = ((idx - 1).astype(jnp.float32) + 0.5 + saturate(frac)) / res

    wavelength = 390.0 + 441.0 * mid

    # bilinear fetch of the response row at coordinate `mid`
    x = mid * res - 0.5
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, res - 1)
    x1 = jnp.clip(x0 + 1, 0, res - 1)
    t = (x - x0.astype(jnp.float32))[..., None]
    response = cie_response[x0] * (1.0 - t) + cie_response[x1] * t

    # pdf = response . max-of-cumulative-CMF (reference lib/colour.py:41-42;
    # the u=1.0 clamped texel of the CDF row)
    rgb_cmf_max = cie_cdf[res - 1]
    pdf = dot(response, rgb_cmf_max)
    ok = (pdf > 1e-3) & jnp.isfinite(pdf)
    rcp_pdf = jnp.where(ok, 1.0 / jnp.maximum(pdf, 1e-12), 0.0)
    return wavelength, response, rcp_pdf


def spectrum_sample_hero(u, cie_cdf, cie_response, n_lambdas: int = 4):
    """Hero-wavelength packet sampling (Wilkie et al. 2014).

    One hero wavelength is drawn by CIE inverse-CDF (as spectrum_sample);
    n_lambdas-1 companions are equal-spaced rotations of the spectral domain.
    Rotation preserves measure, so MIS over "which index is hero" with the
    balance heuristic makes the packet estimator unbiased; the tracker keeps
    the per-lambda pdf-ratio weights (see render/pathtracer.trace_paths).

    Returns (wavelengths (..., L), responses (..., L, 3), lambda_pdf (..., L))
    where lambda_pdf[j] is the probability density of lambda_j under the CIE
    sampler — the p_lambda terms of the MIS denominator.
    """
    res = cie_cdf.shape[0]
    g = saturate(jnp.mean(cie_cdf, axis=-1))
    idx = jnp.clip(jnp.searchsorted(g, u, side="left"), 1, res - 1)
    g0 = g[idx - 1]
    g1 = g[idx]
    frac = jnp.where(g1 > g0, (u - g0) / jnp.maximum(g1 - g0, 1e-12), 0.5)
    mid = ((idx - 1).astype(jnp.float32) + 0.5 + saturate(frac)) / res

    shifts = jnp.arange(n_lambdas, dtype=jnp.float32) / n_lambdas
    mids = jnp.mod(mid[..., None] + shifts, 1.0)  # (..., L)
    wavelengths = 390.0 + 441.0 * mids

    x = mids * res - 0.5
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, res - 1)
    x1 = jnp.clip(x0 + 1, 0, res - 1)
    t = (x - x0.astype(jnp.float32))[..., None]
    responses = cie_response[x0] * (1.0 - t) + cie_response[x1] * t  # (...,L,3)

    # p_lambda(lambda_j): density of the CIE sampler at each packet member.
    # The sampler draws `mid` with density g'(mid) = mean-response(mid)/S
    # per unit mid; the same density function evaluated at every member.
    rgb_cmf_max = cie_cdf[res - 1]
    pdf = dot(responses, rgb_cmf_max)  # = sum of channel responses
    ok = (pdf > 1e-3) & jnp.isfinite(pdf)
    lambda_pdf = jnp.where(ok, pdf, 0.0)
    return wavelengths, responses, lambda_pdf


def srgb_to_spectrum(lut, rgb, wavelength):
    """Spectral power of an sRGB triple at ``wavelength`` via a 300-bin
    (400-700 nm) basis LUT, reproducing the reference exactly — including its
    *negative* interpolation weight ``f = w - (wavelength-400)`` (a latent
    quirk we keep for spectral parity; reference lib/colour.py:62-71).

    Args:
      lut: (300, 3) float basis coefficients.
      rgb: (..., 3) linear-ish sRGB triple.
      wavelength: (...,) nm.
    """
    wl = wavelength - 400.0
    w = wl.astype(jnp.int32)  # truncation toward zero, as ti.cast does
    in_range = (w > 0) & (w < 299)
    wi = jnp.clip(w, 0, 298)
    f = (w.astype(jnp.float32) - wl)[..., None]  # in (-1, 0]; kept verbatim
    coeff = mix(lut[wi], lut[jnp.clip(wi + 1, 0, 299)], f)
    power = dot(rgb, coeff)
    return jnp.where(in_range, power, 0.0)


def srgb_transfer(linear):
    """Linear -> sRGB OETF (reference lib/colour.py:74-79)."""
    lo = linear * 12.92
    hi = jnp.power(jnp.abs(linear), 1.0 / 2.4) * 1.055 - 0.055
    return jnp.where(linear < 0.0031308, lo, hi)


def srgb_transfer_inverse(color):
    """sRGB -> linear EOTF (reference lib/colour.py:81-86)."""
    lo = color / 12.92
    hi = jnp.power(jnp.maximum((color + 0.055) / 1.055, 0.0), 2.4)
    return jnp.where(color < 0.04045, lo, hi)


LUM_WEIGHTS = np.array([0.2126729, 0.7151522, 0.0721750], dtype=np.float32)


def lum(x):
    """Rec.709 luminance (reference lib/colour.py:88-90)."""
    return dot(x, jnp.asarray(LUM_WEIGHTS))


def lum3(x):
    y = lum(x)
    return jnp.stack([y, y, y], axis=-1)
