"""Texture configuration and loading into a device pytree.

Mirrors the role of the reference lib/textures.py (quality tiers + file
paths) and renderer.py:60-94 (upload). Real NASA equirect imagery is used
when present under ``textures/``; otherwise a deterministic procedural set is
synthesized (assets/procgen.py) so the renderer is always runnable.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from ..ops.texture import Tex2D
from .procgen import cached_earth_textures

# Quality tiers, mirroring reference lib/textures.py:1-8. Tier 0 = 4K is the
# default here (SURVEY.md §7: ship 4K first, tier up later).
TEXTURE_QUALITY = int(os.environ.get("DE_TEXTURE_QUALITY", "0"))
TEX_RES_4K = (3840, 1920)
TEX_RES_8K = (8100, 4050)
TEX_RES_10K = (10800, 5400)
TEX_RES_16K = (16200, 8100)
TEX_RES_21K = (21600, 10800)

_TIER_FILES = {
    0: dict(
        albedo="earth_color_4K.png",
        topography="topography_4K.png",
        ocean="earth_landocean_4K.png",
        clouds="earth_clouds_4K.png",
        bathymetry="earth_bathymetry_4k.png",
        emissive="earth_nightlights_4K.png",
        stars="stars_8K.jpg",
    ),
    1: dict(
        albedo="earth_color_10K.png",
        topography="topography_10K.png",
        ocean="earth_landocean_8K.png",
        clouds="earth_clouds_8K.png",
        bathymetry="earth_bathymetry_10k.png",
        emissive="earth_nightlights_10K.png",
        stars="stars_16K.png",
    ),
    2: dict(
        albedo="earth_color_21K.png",
        topography="topography_21K.png",
        ocean="earth_landocean_16K.png",
        clouds="earth_clouds_21K.png",
        bathymetry="earth_bathymetry_21k.png",
        emissive="earth_nightlights_21K.png",
        stars="stars_16K.png",
    ),
}

_SINGLE_CHANNEL = ("topography", "ocean", "clouds", "bathymetry", "emissive")

# Channel order of the packed material texture (see build_atlas)
MAT_ALBEDO = slice(0, 3)
MAT_OCEAN = 3
MAT_BATHYMETRY = 4
MAT_EMISSIVE = 5
MAT_TOPOGRAPHY = 6
MAT_CLOUDS = 7


class TextureAtlas(NamedTuple):
    """Scene textures in row-gather layout (ops/texture.Tex2D).

    material: 8-channel pack [albedo rgb, ocean, bathymetry, emissive,
              topography, clouds] — one row gather per surface-material tap
              instead of the reference's 4+ separate texture samples
              (reference pathtracer.py:284-313).
    topography: 4-channel pack [height, fine max-mip, coarse max-mip, 0]
              for the in-loop land march: one row gather returns the SDF
              height AND two conservative regional height bounds (valid
              within MIP_FINE_VALID_KM / MIP_COARSE_VALID_KM of the tap) for
              analytic sphere skips at two scales.
    clouds:   4-channel pack [cloud map, fine max-mip, coarse max-mip, 0].
              The fine mip is the local Woodcock majorant and certifies
              short skips through broken clouds; the coarse mip certifies
              ~100 km strides through clear sky — the space-skipping cloud
              tracker (render/pathtracer._track_cloud) pays zero extra
              gathers for either.
    stars:    3-channel background (reference pathtracer.py:461).
    """

    material: Tex2D
    topography: Tex2D
    clouds: Tex2D
    stars: Tex2D


# Majorant mip geometry. A tap certifies a bound within the VALID radius;
# the build dilation exceeds it by the cell diagonal (taps can sit anywhere
# inside their cell), computed per build from the actual mip cell size.
# Validity radii must match the skip strides in render/pathtracer.py.
#
# The CLOUD fine validity is deliberately small: dilation widens every
# "cloudy" zone by ~dilate on each side, and sun-facing NEE chords
# Woodcock-crawl through that fake-cloudy margin at ~350 m majorant steps —
# the dominant loop of a cloudy frame. 8 km validity + one ~20 km cell
# dilates ~36 km less than a 45 km build at identical safety.
# TOPO keeps the wider 25 km validity: the land march *benefits* from long
# certified skips and its cost is bounded by the analytic bound-sphere cull.
MIP_FINE_H = 4096  # capped at map resolution (cells = texels below 4096 rows)
MIP_COARSE_H = 128  # ~156 km cells
MIP_FINE_VALID_KM = 25.0          # topo march fine validity
MIP_CLOUD_FINE_VALID_KM = 8.0     # cloud tracker fine validity
MIP_COARSE_VALID_KM = 115.0


def build_max_mip(
    img: np.ndarray,
    dilate_km: float = None,
    mip_h: int = MIP_COARSE_H,
    mip_w: int = 2 * MIP_COARSE_H,
    shell_r: float = 6371e3 + 10e3,
    valid_km: float = None,
) -> np.ndarray:
    """Coarse (mip_h, mip_w) max-pool of a scalar map, dilated so that the
    cell containing any point conservatively bounds the texture max within
    ``dilate_km`` of it (latitude-aware in longitude, wrapping).

    Pass ``valid_km`` instead to derive the dilation from the actual cell
    size: validity + ~one cell per axis (the dilation is axis-separable, so
    covering the L-infinity ball of radius valid+cell covers the Euclidean
    validity ball for a tap anywhere inside its cell)."""
    h, w = img.shape[:2]
    mip_h = min(mip_h, h)  # tiny (test-size) maps: one cell per texel at most
    mip_w = min(mip_w, w)
    if dilate_km is None:
        # per-axis tap-offset margin: one cell on whichever axis is coarser
        # (for maps narrower than 2:1, equatorial longitude cells are wider
        # than latitude cells, and the latitude cell alone would be a
        # non-conservative bound)
        cell_h_km = np.pi * shell_r / mip_h / 1e3
        cell_w_km = 2 * np.pi * shell_r / mip_w / 1e3
        dilate_km = valid_km + 1.05 * max(cell_h_km, cell_w_km)
    c = img if img.ndim == 2 else img[..., 0]
    c = c.astype(np.float32) / (255.0 if img.dtype == np.uint8 else 1.0)
    ph = -h % mip_h
    pw = -w % mip_w
    cp = np.pad(c, ((0, ph), (0, pw)), mode="edge")
    bh, bw = cp.shape[0] // mip_h, cp.shape[1] // mip_w
    coarse = cp.reshape(mip_h, bh, mip_w, bw).max(axis=(1, 3))

    cell_h_km = np.pi * shell_r / mip_h / 1e3
    dil_v = int(np.ceil(dilate_km / cell_h_km))
    out = coarse.copy()
    for dv in range(-dil_v, dil_v + 1):
        shifted = coarse[np.clip(np.arange(mip_h) + dv, 0, mip_h - 1)]
        out = np.maximum(out, shifted)
    lat = (0.5 - (np.arange(mip_h) + 0.5) / mip_h) * np.pi
    cell_w_km = 2 * np.pi * shell_r * np.maximum(np.cos(lat), 1e-3) / mip_w / 1e3
    dilated = out.copy()
    for row in range(mip_h):
        du = int(np.ceil(dilate_km / cell_w_km[row]))
        if du >= mip_w // 2:
            dilated[row, :] = out[row].max()
            continue
        for d in range(1, du + 1):
            dilated[row] = np.maximum(dilated[row], np.roll(out[row], d))
            dilated[row] = np.maximum(dilated[row], np.roll(out[row], -d))
    return dilated


def build_cloud_mip(clouds: np.ndarray) -> np.ndarray:
    return build_max_mip(clouds, valid_km=MIP_COARSE_VALID_KM)


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.shape[:2] == (h, w):
        return img
    ys = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[ys][:, xs]


def build_atlas_arrays(arrays: dict) -> dict:
    """Image-space packed planes of the atlas (all uint8): ``material``
    (H, W, 8), ``topography`` (H, W, 4), ``clouds`` (H, W, 4), ``stars``
    (H, W, 3). The expensive step (max-mip builds) lives here so the result
    can be disk-cached and/or upsampled on device (see
    ``upsampled_procedural_atlas``)."""
    albedo = arrays["albedo"]
    h, w = albedo.shape[:2]
    mat = np.concatenate(
        [
            albedo[..., :3],
            _resize_nearest(arrays["ocean"], h, w)[..., None],
            _resize_nearest(arrays["bathymetry"], h, w)[..., None],
            _resize_nearest(arrays["emissive"], h, w)[..., None],
            _resize_nearest(arrays["topography"], h, w)[..., None],
            _resize_nearest(arrays["clouds"], h, w)[..., None],
        ],
        axis=-1,
    )
    def with_mips(img, fine_valid_km, extra_valid_km):
        """(H, W, 4) uint8: [map, fine max-mip, coarse max-mip, extra
        max-mip], each mip upsampled to full resolution and ceil-quantized
        so it stays a conservative upper bound.

        Channel 3 carries a second fine-scale bound at ``extra_valid_km``:
        clouds pair a TIGHT majorant/budget bound (ch 1) with a WIDE
        skip-certification bound (ch 3) so clear-sky lanes stride far while
        tracking budgets stay tight; topography pairs its wide march bound
        (ch 1) with a tight bound (ch 3) for the march-on-demand free ball
        near terrain."""
        if img.ndim == 3:
            img = img[..., 0]
        ih, iw = img.shape

        def mip_channel(mip_h, valid_km):
            mip = build_max_mip(
                img, mip_h=mip_h, mip_w=2 * mip_h, valid_km=valid_km
            )
            return _resize_nearest(
                (mip * 255.0 + 0.999).clip(0, 255).astype(np.uint8), ih, iw
            )

        fine = mip_channel(MIP_FINE_H, fine_valid_km)
        coarse = mip_channel(MIP_COARSE_H, MIP_COARSE_VALID_KM)
        extra = mip_channel(MIP_FINE_H, extra_valid_km)
        return np.stack([img, fine, coarse, extra], axis=-1)

    return {
        "material": mat,
        "topography": with_mips(
            arrays["topography"], MIP_FINE_VALID_KM, MIP_CLOUD_FINE_VALID_KM
        ),
        "clouds": with_mips(
            arrays["clouds"], MIP_CLOUD_FINE_VALID_KM, MIP_FINE_VALID_KM
        ),
        "stars": np.ascontiguousarray(arrays["stars"][..., :3]),
    }


# Terrain-honesty jitter for device-upsampled tiers: a
# pure NN upsample has zero gradient above base-texel scale, flattering every
# march/tracking-trip-count-sensitive number. Each upsampled topography/cloud
# texel is scaled by (1 - U*jitter) with a per-texel hash U — downward-only,
# so the base-built max-mips stay conservative. 0.06 puts ~0-120 m of
# texel-scale relief on a 0.25-height mountain at the tier-2 texel (~1.9 km),
# the scale of real ETOPO texel gradients outside cliff terrain.
UPSAMPLE_JITTER = float(os.environ.get("DE_UPSAMPLE_JITTER", "0.06"))


def pack_atlas(packs: dict, upsample: int = 1,
               jitter: float = None) -> TextureAtlas:
    """Row-gather-pack the image-space planes into a TextureAtlas,
    optionally nearest-neighbour-upsampling each plane by an integer factor
    on device (Tex2D.from_upsampled). Upsampled topography/cloud maps get
    per-texel terrain-honesty jitter (UPSAMPLE_JITTER; channel 0 only — the
    mip bounds stay exact)."""
    if jitter is None:
        jitter = UPSAMPLE_JITTER
    if upsample > 1:
        f = lambda a, **kw: Tex2D.from_upsampled(a, upsample, **kw)  # noqa: E731
    else:
        f = lambda a, **kw: Tex2D.from_array(a)  # noqa: E731
    return TextureAtlas(
        material=f(packs["material"]),
        topography=f(packs["topography"], jitter=jitter, jitter_seed=0x7071),
        clouds=f(packs["clouds"], jitter=jitter, jitter_seed=0xC10D),
        stars=f(packs["stars"]),
    )


def build_atlas(arrays: dict) -> TextureAtlas:
    """Pack raw (H, W[, C]) uint8 maps into the row-gather atlas."""
    return pack_atlas(build_atlas_arrays(arrays), upsample=1)


# Bump when the packed-plane layout or the mip parameters above change: the
# packed-atlas disk cache (cached_atlas_arrays) keys on it.
ATLAS_PACK_VERSION = "r4a"


def _atlas_cache_dir(cache_dir=None):
    if cache_dir is None:
        cache_dir = os.path.join(
            os.path.expanduser("~"), ".cache", "digital_earth"
        )
    os.makedirs(cache_dir, exist_ok=True)
    return cache_dir


def cached_atlas_arrays(resolution, seed: int = 7, cache_dir=None) -> dict:
    """Build-or-load the packed procedural atlas planes for ``resolution``.

    Each plane is cached as its own .npy as soon as it is built, so an
    interrupted build still makes progress (the mip builds are the
    expensive, per-plane step on this environment's slow host CPU)."""
    from .procgen import cached_earth_textures

    h, w = resolution
    cache_dir = _atlas_cache_dir(cache_dir)
    stem = os.path.join(
        cache_dir, f"atlas_{ATLAS_PACK_VERSION}_{h}x{w}_s{seed}"
    )
    names = ("material", "topography", "clouds", "stars")
    paths = {n: f"{stem}_{n}.npy" for n in names}
    if all(os.path.exists(p) for p in paths.values()):
        return {n: np.load(paths[n]) for n in names}
    packs = build_atlas_arrays(cached_earth_textures(resolution, seed))
    for n in names:
        tmp = paths[n] + ".tmp"
        with open(tmp, "wb") as f:  # np.save(path) would append ".npy"
            np.save(f, packs[n])
        os.replace(tmp, paths[n])
    return packs


def upsampled_procedural_atlas(
    target_resolution,
    base_resolution=(1350, 2700),
    seed: int = 7,
    cache_dir=None,
    jitter: float = None,
) -> TextureAtlas:
    """Tier-2-scale procedural atlas: nearest-neighbour-upsample the cached
    base planes ON DEVICE by an integer factor, then row-gather-pack on
    device.

    Scale-representative by construction: the upsampled atlas has exactly
    the device-memory footprint and random-gather cost of a real
    ``target_resolution`` texture set (gathers are content-blind), while
    the content is the base set block-repeated. The majorant mips packed in
    the base planes stay conservative for the repeated content (a base
    cell's max bounds its 8x8 repeat exactly). Synthesizing natively at
    21600x10800 costs tens of minutes of single-threaded numpy."""
    th, tw = target_resolution
    bh, bw = base_resolution
    if th % bh or tw % bw or th // bh != tw // bw:
        raise ValueError(
            f"target {target_resolution} must be an integer multiple of "
            f"base {base_resolution}"
        )
    factor = th // bh
    packs = cached_atlas_arrays(base_resolution, seed, cache_dir)
    return pack_atlas(packs, upsample=factor, jitter=jitter)


def _load_image(path: str, single_channel: bool) -> np.ndarray:
    # NASA imagery is off the main path (no textures/ -> procedural), so
    # PIL is imported only here, and only needed when such files exist
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path} exists, and decoding it needs PIL (Pillow), which is not "
            "installed; install it or remove the file to use procedural "
            "textures"
        ) from e

    Image.MAX_IMAGE_PIXELS = None  # 21600x10800 tiers exceed PIL's default cap
    img = np.asarray(Image.open(path))
    if single_channel:
        if img.ndim == 3:
            img = img[..., 0]
    else:
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        img = img[..., :3]
    return img.astype(np.uint8)


def load_texture_atlas(
    texture_dir: str = "textures",
    quality: Optional[int] = None,
    procedural_resolution=(1024, 2048),
    procedural_seed: int = 7,
) -> TextureAtlas:
    """Load real textures when available, else the procedural fallback.

    Per-texture fallback: any missing file is substituted procedurally, so a
    partial NASA download still works.
    """
    quality = TEXTURE_QUALITY if quality is None else quality
    files = _TIER_FILES[quality]
    arrays = {}
    missing = []
    for name, fn in files.items():
        path = os.path.join(texture_dir, fn)
        if os.path.exists(path):
            arrays[name] = _load_image(path, name in _SINGLE_CHANNEL)
        else:
            missing.append(name)
    if len(missing) == len(files):
        # fully-procedural: large tiers route through the device-upsampled
        # base (native numpy synthesis at 21600x10800 costs tens of
        # minutes); small tiers keep the exact byte-stable numpy path the
        # golden tests cover.
        h, w = procedural_resolution
        if h >= 4050 and h % 1350 == 0 and w == 2 * h:
            return upsampled_procedural_atlas(
                procedural_resolution, (1350, 2700), procedural_seed
            )
        return build_atlas(cached_earth_textures(
            procedural_resolution, procedural_seed
        ))
    if missing:
        proc = cached_earth_textures(procedural_resolution, procedural_seed)
        for name in missing:
            arrays[name] = proc[name]
    return build_atlas(arrays)


def procedural_texture_atlas(resolution=(1024, 2048), seed: int = 7) -> TextureAtlas:
    return build_atlas(cached_earth_textures(resolution, seed))
