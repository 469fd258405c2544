"""HDR -> SDR film chain: OpenDRT and AgX display transforms, measured
camera-response curves, vignette, exposure/gamma, sRGB encode.

- OpenDRT follows Jed Smith's open-display-transform v0.2.2 math (GPL v3),
  the same version the reference ports (reference lib/OpenDRT.py:5-10), with
  the reference's compiled configuration: Rec.709 in/out, linear EOTF,
  Lp = 100 nits (lib/OpenDRT.py:39-55).
- AgX follows Troy Sobotka's AgX as shadered by Olivier Groulx — the
  reference ships it disabled (renderer.py:356); here it is a selectable DRT.
- Camera response: 1D per-channel LUT slices of the DoRF pack
  (reference renderer.py:333-344).

Everything operates on (..., 3) float arrays.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..ops.math_utils import HIGHEST, mix, saturate
from ..ops.spectral import lum3, srgb_transfer

# ---------------------------------------------------------------------------
# OpenDRT (reference lib/OpenDRT.py)
# ---------------------------------------------------------------------------

# Compiled config (reference lib/OpenDRT.py:39-55)
LP = 100.0
GB = 0.12
CONTRAST = 1.0
FL = 0.005
RW = 0.25
BW = 0.35
DCH = 0.35
DCH_TOE = 0.0
HS_R = 0.3
HS_G = -0.1
HS_B = -0.2
V_P = 0.5

# --- Working-space gamut matrices ------------------------------------------
# The reference embeds 14 gamut->XYZ matrices (lib/OpenDRT.py:56-74). Here
# they are *derived* from the published chromaticity coordinates of each
# standard/camera colour space, with CAT02 chromatic adaptation to D65 for
# the non-D65 whites (the reference's matrices state the same adaptation in
# their header comment) — identical values up to float rounding, validated
# in tests/test_film.py.

_WHITE_D65 = (0.3127, 0.3290)
_WHITE_ACES = (0.32168, 0.33767)

# name: (red xy, green xy, blue xy, white xy)
_GAMUT_CHROMATICITIES = {
    "rec709": ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06), _WHITE_D65),
    "p3d65": ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060), _WHITE_D65),
    "rec2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046), _WHITE_D65),
    "ap0": ((0.7347, 0.2653), (0.0, 1.0), (0.0001, -0.077), _WHITE_ACES),
    "ap1": ((0.713, 0.293), (0.165, 0.830), (0.128, 0.044), _WHITE_ACES),
    "arriwg3": ((0.6840, 0.3130), (0.2210, 0.8480), (0.0861, -0.1020), _WHITE_D65),
    "arriwg4": ((0.7347, 0.2653), (0.1424, 0.8576), (0.0991, -0.0308), _WHITE_D65),
    "redwg": ((0.780308, 0.304253), (0.121595, 1.493994), (0.095612, -0.084589), _WHITE_D65),
    "sonysgamut3": ((0.730, 0.280), (0.140, 0.855), (0.100, -0.050), _WHITE_D65),
    "sonysgamut3cine": ((0.766, 0.275), (0.225, 0.800), (0.089, -0.087), _WHITE_D65),
    "bmdwg": ((0.7177215, 0.3171181), (0.2280410, 0.8615690), (0.1005841, -0.0820452), (0.3127170, 0.3290312)),
    "egamut": ((0.8000, 0.3177), (0.1800, 0.9000), (0.0650, -0.0805), _WHITE_D65),
    "davinciwg": ((0.8000, 0.3130), (0.1682, 0.9877), (0.0790, -0.1155), _WHITE_D65),
}

# CAT02 cone response matrix (CIECAM02)
_CAT02 = np.array(
    [
        [0.7328, 0.4296, -0.1624],
        [-0.7036, 1.6975, 0.0061],
        [0.0030, 0.0136, 0.9834],
    ]
)


def _xy_to_xyz_np(xy):
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def _rgb_to_xyz_from_chromaticities(r, g, b, w):
    prim = np.stack([_xy_to_xyz_np(r), _xy_to_xyz_np(g), _xy_to_xyz_np(b)], axis=1)
    scale = np.linalg.solve(prim, _xy_to_xyz_np(w))
    return prim * scale[None, :]


def _cat02_adaptation(src_white_xy, dst_white_xy):
    """Von-Kries adaptation in CAT02 cone space (full adaptation)."""
    src = _CAT02 @ _xy_to_xyz_np(src_white_xy)
    dst = _CAT02 @ _xy_to_xyz_np(dst_white_xy)
    return np.linalg.inv(_CAT02) @ np.diag(dst / src) @ _CAT02


@lru_cache(maxsize=None)
def gamut_to_xyz(name: str) -> np.ndarray:
    """RGB->XYZ(D65) matrix of a named working space (reference
    lib/OpenDRT.py:56-74 embeds the same matrices as constants)."""
    if name == "xyz":
        return np.eye(3, dtype=np.float32)
    r, g, b, w = _GAMUT_CHROMATICITIES[name]
    m = _rgb_to_xyz_from_chromaticities(r, g, b, w)
    if w != _WHITE_D65:
        m = _cat02_adaptation(w, _WHITE_D65) @ m
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def xyz_to_display(name: str) -> np.ndarray:
    """XYZ->display-RGB for the three display gamuts the reference supports
    (lib/OpenDRT.py:76-78)."""
    assert name in ("rec709", "p3d65", "rec2020"), name
    return np.linalg.inv(gamut_to_xyz(name).astype(np.float64)).astype(np.float32)


# Compiled default: in = Rec709, display = Rec709 — the gamut round-trip
# composes to ~identity but we keep both multiplies for parity with the
# reference's chain (lib/OpenDRT.py:327-329).
_IN_TO_XYZ = gamut_to_xyz("rec709")
_XYZ_TO_DISPLAY = xyz_to_display("rec709")


def _sdiv(a, b):
    """Safe divide: 0 where |b| < 1e-4 (reference lib/OpenDRT.py:92-97)."""
    return jnp.where(jnp.abs(b) < 1e-4, 0.0, a / jnp.where(jnp.abs(b) < 1e-4, 1.0, b))


def _spow(a, b):
    """Safe power: passthrough for a <= 0 (reference lib/OpenDRT.py:111-116)."""
    return jnp.where(a <= 0.0, a, jnp.power(jnp.maximum(a, 1e-12), b))


def _tonescale(x, m, s, c, invert=False):
    """Daniele-curve tonescale (reference lib/OpenDRT.py:200-208)."""
    if not invert:
        return _spow(m * x / (x + s), c)
    ip = 1.0 / c
    return _spow(s * x, ip) / (m - _spow(x, ip))


def _flare(x, fl, invert=False):
    """Parabolic toe compression (reference lib/OpenDRT.py:211-218)."""
    if not invert:
        return _spow(x, 2.0) / (x + fl)
    return (x + jnp.sqrt(x * (4.0 * fl + x))) / 2.0


def _flare_scalar(x, fl):
    """Host-side inverse flare for the intersection constants."""
    return (x + math.sqrt(x * (4.0 * fl + x))) / 2.0


def _narrow_hue_angles(v):
    """Reference lib/OpenDRT.py:191-197."""
    r = jnp.clip(v[..., 0] - (v[..., 1] + v[..., 2]), 0.0, 2.0)
    g = jnp.clip(v[..., 1] - (v[..., 0] + v[..., 2]), 0.0, 2.0)
    b = jnp.clip(v[..., 2] - (v[..., 0] + v[..., 1]), 0.0, 2.0)
    return jnp.stack([r, g, b], axis=-1)


# --- Display EOTFs (reference lib/OpenDRT.py:134-189) -----------------------


def eotf_hlg(rgb, inverse: bool = False):
    """Hybrid Log-Gamma EOTF with the BT.2100/BT.2390 surround model
    (reference lib/OpenDRT.py:134-165; Lw=1000, Ls=5)."""
    hlg_lw, hlg_ls = 1000.0, 5.0
    a = 0.17883277
    b = 1.0 - 4.0 * a
    c = 0.5 - a * math.log10(4.0 * a)
    g = (
        1.2
        * math.pow(1.111, math.log2(hlg_lw / 1000.0))
        * math.pow(0.98, math.log2(max(1e-6, hlg_ls) / 5.0))
    )
    lum_w = jnp.asarray([0.2627, 0.6780, 0.0593])
    if inverse:
        yd = jnp.sum(rgb * lum_w, axis=-1, keepdims=True)
        rgb = rgb * _spow(yd, (1.0 - g) / g)  # inverse OOTF
        return jnp.where(  # OETF
            rgb <= 1.0 / 12.0,
            jnp.sqrt(jnp.maximum(3.0 * rgb, 0.0)),
            a * jnp.log10(jnp.maximum(12.0 * rgb - b, 1e-12)) + c,
        )
    rgb = jnp.where(  # inverse OETF
        rgb <= 0.5,
        rgb * rgb / 3.0,
        (jnp.power(10.0, (rgb - c) / a) + b) / 12.0,
    )
    ys = jnp.sum(rgb * lum_w, axis=-1, keepdims=True)
    return rgb * _spow(ys, g - 1.0)  # OOTF


def eotf_pq(rgb, inverse: bool = False):
    """ST-2084 PQ EOTF, normalized so 1.0 = 10,000 nits
    (reference lib/OpenDRT.py:167-189)."""
    m1 = 2610.0 / 16384.0
    m2 = 2523.0 / 32.0
    c1 = 107.0 / 128.0
    c2 = 2413.0 / 128.0
    c3 = 2392.0 / 128.0
    if inverse:
        y = _spow(rgb, m1)
        return _spow((c1 + c2 * y) / (1.0 + c3 * y), m2)
    e = _spow(rgb, 1.0 / m2)
    return _spow(jnp.maximum(e - c1, 0.0) / (c2 - c3 * e), 1.0 / m1)


_EOTF_NAMES = ("lin", "srgb", "rec1886", "dci", "pq", "hlg")


@lru_cache(maxsize=None)
def _drt_constants(lp: float, eotf: str):
    """Tonescale intersection constants + display scale for a (peak
    luminance, EOTF) pair (reference lib/OpenDRT.py:260-319)."""
    e = _EOTF_NAMES.index(eotf)
    ds = 0.01 if e == 4 else (0.1 if e == 5 else 100.0 / lp)
    px = 128.0 * math.log10(lp) / math.log10(100.0) - 64.0
    py = lp / 100.0
    gx = 0.18
    gy = 11.696 / 100.0 * (1.0 + GB * math.log2(py))
    s0 = _flare_scalar(gy, FL)
    m0 = _flare_scalar(py, FL)
    ip = 1.0 / CONTRAST
    s = (px * gx * (m0**ip - s0**ip)) / (px * s0**ip - gx * m0**ip)
    m = m0**ip * (s + px) / px
    clamp_max = ds * lp / 100.0
    return m, s, ds, clamp_max


def opendrt_transform(
    rgb,
    in_gamut: str = "rec709",
    display_gamut: str = "rec709",
    eotf: str = "lin",
    lp: float = LP,
):
    """OpenDRT HDR->SDR (reference lib/OpenDRT.py:221-485).

    Defaults reproduce the reference's compiled config (Rec709 in/out,
    linear EOTF, Lp=100 — lib/OpenDRT.py:39-55); the full working-space /
    display-gamut / EOTF matrix the reference carries as dead branches is
    selectable here.
    """
    _M, _S, _DS, _CLAMP_MAX = _drt_constants(float(lp), eotf)
    rgb = jnp.matmul(
        rgb, jnp.asarray(gamut_to_xyz(in_gamut)).T, precision=HIGHEST
    )
    rgb = jnp.matmul(
        rgb, jnp.asarray(xyz_to_display(display_gamut)).T, precision=HIGHEST
    )

    mx = jnp.max(rgb, axis=-1)
    mn = jnp.min(rgb, axis=-1)

    h_rgb = _narrow_hue_angles(_sdiv(rgb - mn[..., None], mx[..., None]))

    w = np.array([RW, 1.0, BW], dtype=np.float32)
    w = w / np.linalg.norm(w)
    wrgb = jnp.asarray(w) * jnp.maximum(rgb, 1e-5)
    lum = jnp.sqrt(jnp.sum(wrgb * wrgb, axis=-1))

    rats = _sdiv(rgb, lum[..., None])

    ts = _tonescale(lum, _M, _S, CONTRAST)
    ts = _flare(ts, FL)
    ts = ts * _DS

    dch_s = DCH / _S
    ccf = _sdiv(jnp.ones_like(lum), lum * dch_s + 1.0)
    toe_ccf = (DCH_TOE + 1.0) * _sdiv(lum, lum + DCH_TOE) * ccf

    hs_w = (1.0 - ccf)[..., None] * h_rgb
    rats = jnp.stack(
        [
            rats[..., 0] + hs_w[..., 2] * HS_B - hs_w[..., 1] * HS_G,
            rats[..., 1] + hs_w[..., 0] * HS_R - hs_w[..., 2] * HS_B,
            rats[..., 2] + hs_w[..., 1] * HS_G - hs_w[..., 0] * HS_R,
        ],
        axis=-1,
    )
    rats = 1.0 - toe_ccf[..., None] + rats * toe_ccf[..., None]
    rats = jnp.maximum(rats, 0.0)

    rats_mx = jnp.max(rats, axis=-1)
    rats_mn = jnp.min(rats, axis=-1)
    rats_ch = _sdiv(rats_mx - rats_mn, rats_mx)
    chf = _spow(rats_ch * ts, V_P)
    rats_n = _sdiv(rats, rats_mx[..., None])
    rats = rats_n * chf[..., None] + rats * (1.0 - chf[..., None])

    rgb = rats * ts[..., None]
    rgb = jnp.minimum(rgb, _CLAMP_MAX)

    # Inverse display EOTF (reference lib/OpenDRT.py:476-484); "lin" is a
    # no-op — the compiled path the reference actually runs.
    e = _EOTF_NAMES.index(eotf)
    if 0 < e < 4:  # srgb / rec1886 / dci: pure power of 2.2 / 2.4 / 2.6
        rgb = _spow(rgb, 1.0 / (2.0 + e * 0.2))
    elif eotf == "pq":
        rgb = eotf_pq(rgb, inverse=True)
    elif eotf == "hlg":
        rgb = eotf_hlg(rgb, inverse=True)
    return rgb


# ---------------------------------------------------------------------------
# AgX (reference lib/AgX.py)
# ---------------------------------------------------------------------------

AGX_MIDDLE_GREY = 0.18
AGX_SLOPE = 2.3
AGX_TOE_POWER = 1.9
AGX_SHOULDER_POWER = 3.1
AGX_COMPRESSION = 0.15
AGX_MIN_EV = -10.0
AGX_MAX_EV = 6.5
AGX_SATURATION = 1.4


def _xy_to_xyz(xy):
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def _primaries_to_matrix(xy_r, xy_g, xy_b, xy_w):
    """RGB->XYZ from chromaticities (reference lib/AgX.py:60-74)."""
    xyz_r, xyz_g, xyz_b = _xy_to_xyz(xy_r), _xy_to_xyz(xy_g), _xy_to_xyz(xy_b)
    xyz_w = _xy_to_xyz(xy_w)
    temp = np.array(
        [
            [xyz_r[0], xyz_g[0], xyz_b[0]],
            [1.0, 1.0, 1.0],
            [xyz_r[2], xyz_g[2], xyz_b[2]],
        ]
    )
    scale = np.linalg.inv(temp) @ xyz_w
    return np.array(
        [
            [scale[0] * xyz_r[0], scale[1] * xyz_g[0], scale[2] * xyz_b[0]],
            [scale[0] * xyz_r[1], scale[1] * xyz_g[1], scale[2] * xyz_b[1]],
            [scale[0] * xyz_r[2], scale[1] * xyz_g[2], scale[2] * xyz_b[2]],
        ]
    )


def _compression_matrix(xy_r, xy_g, xy_b, xy_w, compression):
    """Inset-primaries matrix (reference lib/AgX.py:77-84)."""
    s = 1.0 / (1.0 - compression)
    f = lambda xy: tuple((np.asarray(xy) - np.asarray(xy_w)) * s + np.asarray(xy_w))
    return _primaries_to_matrix(f(xy_r), f(xy_g), f(xy_b), xy_w)


_SRGB_CHROMA = ((0.64, 0.33), (0.3, 0.6), (0.15, 0.06), (0.3127, 0.3290))
_AGX_SRGB_TO_XYZ = _primaries_to_matrix(*_SRGB_CHROMA).astype(np.float32)
_AGX_XYZ_TO_ADJ = np.linalg.inv(
    _compression_matrix(*_SRGB_CHROMA, AGX_COMPRESSION)
).astype(np.float32)


def _agx_scale(x_pivot, y_pivot, slope_pivot, power):
    """Reference lib/AgX.py:97-98."""
    a = jnp.power(slope_pivot * x_pivot, -power)
    b = jnp.power(slope_pivot * (x_pivot / y_pivot), power) - 1.0
    return jnp.power(a * b, -1.0 / power)


def _agx_hyperbolic(x, power):
    return x / jnp.power(1.0 + jnp.power(jnp.abs(x), power), 1.0 / power)


def _agx_full_curve(x, x_pivot, y_pivot, slope_pivot, toe_power, shoulder_power):
    """Reference lib/AgX.py:100-127 (both branches evaluated, selected)."""
    above = x >= x_pivot
    sxp = jnp.where(above, 1.0 - x_pivot, x_pivot)
    syp = jnp.where(above, 1.0 - y_pivot, y_pivot)
    toe_scale = _agx_scale(sxp, syp, slope_pivot, toe_power)
    shoulder_scale = _agx_scale(sxp, syp, slope_pivot, shoulder_power)
    scale = jnp.where(above, shoulder_scale, -toe_scale)
    power = jnp.where(above, shoulder_power, toe_power)
    term = (slope_pivot * (x - x_pivot)) / scale
    return scale * _agx_hyperbolic(term, power) + y_pivot


def agx_transform(rgb):
    """AgX HDR Rec.709 -> LDR (reference lib/AgX.py:129-160)."""
    xyz = jnp.matmul(rgb, jnp.asarray(_AGX_SRGB_TO_XYZ).T, precision=HIGHEST)
    adjusted = jnp.matmul(
        xyz, jnp.asarray(_AGX_XYZ_TO_ADJ).T, precision=HIGHEST
    )

    x_pivot = abs(AGX_MIN_EV) / (AGX_MAX_EV - AGX_MIN_EV)
    y_pivot = 0.5
    log_v = jnp.clip(
        jnp.log2(jnp.maximum(adjusted, 1e-10) / AGX_MIDDLE_GREY), AGX_MIN_EV, AGX_MAX_EV
    )
    log_v = (log_v - AGX_MIN_EV) / (AGX_MAX_EV - AGX_MIN_EV)
    out = _agx_full_curve(
        log_v, x_pivot, y_pivot, AGX_SLOPE, AGX_TOE_POWER, AGX_SHOULDER_POWER
    )
    out = saturate(out)
    out = mix(lum3(out), out, AGX_SATURATION)
    return saturate(out)


# ---------------------------------------------------------------------------
# Camera response (reference renderer.py:333-344)
# ---------------------------------------------------------------------------


def camera_response(crf_curves, crf_index, tristimulus):
    """Per-channel 1D film-response LUT. crf_curves: (1024, n_films, 3);
    crf_index: traced int; tristimulus (..., 3) in [0, 1]."""
    res = crf_curves.shape[0]
    curve = jnp.take(crf_curves, crf_index, axis=1)  # (1024, 3)
    t = saturate(tristimulus)
    u_offset = 0.5 / res
    u = jnp.minimum(t + u_offset, 1.0 - u_offset)
    x = u * res - 0.5
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, res - 1)
    x1 = jnp.clip(x0 + 1, 0, res - 1)
    frac = x - x0.astype(jnp.float32)
    ch = jnp.arange(3)
    v0 = curve[x0, ch]
    v1 = curve[x1, ch]
    return saturate(v0 * (1.0 - frac) + v1 * frac)


# ---------------------------------------------------------------------------
# Full post chain (reference renderer.py:346-365)
# ---------------------------------------------------------------------------

VIGNETTE_STRENGTH = 0.9
VIGNETTE_RADIUS = 0.0
VIGNETTE_CENTER = (0.5, 0.5)


def postprocess(
    color_buffer, spp, exposure, gamma, crf_curves, crf_index, image_res,
    drt: str = "opendrt",
):
    """color_buffer (W, H, 3) accumulated linear RGB -> display sRGB in [0,1].

    Chain (reference renderer.py:346-365): /spp, vignette, 2^exposure, DRT
    (OpenDRT default / AgX selectable), camera response, gamma, sRGB OETF.
    """
    w, h = image_res
    u = jnp.arange(w, dtype=jnp.float32)[:, None] / w
    v = jnp.arange(h, dtype=jnp.float32)[None, :] / h
    darken = 1.0 - VIGNETTE_STRENGTH * jnp.maximum(
        jnp.sqrt((u - VIGNETTE_CENTER[0]) ** 2 + (v - VIGNETTE_CENTER[1]) ** 2)
        - VIGNETTE_RADIUS,
        0.0,
    )
    spp = jnp.maximum(spp, 1)
    linear = (
        color_buffer / spp * darken[..., None] * jnp.power(2.0, exposure)
    )
    if drt == "opendrt":
        tonemapped = opendrt_transform(linear)
    elif drt == "agx":
        tonemapped = agx_transform(linear)
    elif drt == "none":
        tonemapped = linear
    else:
        raise ValueError(f"unknown display transform {drt!r}")
    cam = camera_response(crf_curves, crf_index, tonemapped)
    graded = jnp.power(jnp.maximum(cam, 0.0), gamma)
    return saturate(srgb_transfer(graded))
