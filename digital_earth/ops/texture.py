"""Equirectangular texture sampling as device-memory gathers.

The reference's hardware sampler calls (``sampler.sample_lod(fract(uv*scale),
0)``, lib/math_utils.py:39-44) become gathers against arrays resident in
device memory. Textures are stored in a row-gather layout (``Tex2D``): texels
packed C-channels-contiguous into (n_rows, 128) arrays, fetched one row per
texel with a one-hot select of the texel's lanes. A multi-channel fetch
(albedo+masks+topo packed into one 8-channel texture) then costs the same one
row gather as a single-channel fetch. The layout was chosen where element
gathers were slow; whether a plain (texel, C) element gather beats it on the
GPU is an open measurement.

Longitude (u) wraps, latitude (v) clamps. Texel centers at (i+0.5)/N, the
standard GPU convention the reference's Vulkan sampler uses. Layout: row 0 of
the source image is the NORTH pole; ``v`` from ``sphere_uv_map`` is 0 at the
south pole, so rows are addressed with (1 - v).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .math_utils import fract, normalize, sphere_uv_map

LANES = 128


@jax.tree_util.register_pytree_node_class
class Tex2D:
    """Texture in row-gather layout.

    rows: (n_rows, 128) array; texel t's channel c lives at
          rows[t // tpr, (t % tpr) * C + c] with tpr = 128 // C.
    h, w, channels: static image dims (aux data, not traced).
    """

    def __init__(self, rows, h, w, channels):
        self.rows = rows
        self.h = h
        self.w = w
        self.channels = channels

    @property
    def texels_per_row(self):
        return LANES // self.channels

    def tree_flatten(self):
        return (self.rows,), (self.h, self.w, self.channels)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    @classmethod
    def from_array(cls, arr) -> "Tex2D":
        """Pack an (H, W) or (H, W, C) image array into row-gather layout."""
        arr = np.asarray(arr)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, c = arr.shape
        tpr = LANES // c
        n_texels = h * w
        n_rows = -(-n_texels // tpr)
        flat = np.zeros((n_rows * tpr, c), dtype=arr.dtype)
        flat[:n_texels] = arr.reshape(n_texels, c)
        rows = flat.reshape(n_rows, tpr * c)
        if tpr * c < LANES:
            rows = np.pad(rows, ((0, 0), (0, LANES - tpr * c)))
        return cls(jnp.asarray(rows), h, w, c)

    @classmethod
    def from_upsampled(cls, arr, factor: int, jitter: float = 0.0,
                       jitter_channel: int = 0, jitter_seed: int = 0x9E3779B9,
                       ) -> "Tex2D":
        """Nearest-neighbour-upsample an (h, w[, C]) uint8 image by an
        integer ``factor`` and row-gather-pack it, entirely ON DEVICE —
        bit-identical to ``from_array(np.repeat(np.repeat(arr, f, 0), f,
        1))`` (asserted in tests/test_texture.py).

        ``jitter`` > 0 makes the upsample terrain-honest:
        a pure NN upsample has ZERO gradient above base-texel scale, so
        march/tracking trip counts and the march-floor bias — both driven by
        texel-scale terrain statistics — see an artificially smooth easy
        case. Each full-res texel's ``jitter_channel`` value is scaled by
        (1 - jitter * u) with u a per-texel deterministic integer hash in
        [0, 1): texel-scale relief proportional to local height (mountains
        rough, ocean stays exactly 0). The reduction is DOWNWARD-ONLY so the
        dilated max-mips packed from the base stay conservative bounds, and
        it is applied to the packed (n_rows, 128) form — never materializing
        an (H, W, C) array.

        Every materialized intermediate is 1-D/2-D with a large minor
        dimension, so no backend's layout tiling can pad a small channel
        dimension into a multi-GB blow-up (a tier-2 material plane is
        1.9 GB). The horizontal texel-repeat is done in transpose space
        ((w, C, h) repeat along the major axis), the vertical repeat on
        (H, w·C) directly; packing on the host instead would move the
        multi-GB planes through host memory."""
        arr = jnp.asarray(arr)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, c = arr.shape
        f = int(factor)
        W, H = w * f, h * f
        tpr = LANES // c
        n_texels = H * W
        n_rows = -(-n_texels // tpr)

        @jax.jit
        def _up_pack(a2d):  # (h, w*C) u8 -> (n_rows, 128)
            t = a2d.T.reshape(w, c, h)
            t = jnp.repeat(t, f, axis=0).reshape(W * c, h)
            v = jnp.repeat(t.T, f, axis=0)  # (H, W*C)
            flat = v.reshape(-1)
            pad = n_rows * tpr * c - flat.shape[0]
            if pad:
                flat = jnp.pad(flat, (0, pad))
            rows = flat.reshape(n_rows, tpr * c)
            if jitter > 0.0:
                # per-texel hash (lowbias32, Walker 2018) of the texel id,
                # evaluated on the packed layout: lane l of row r holds
                # texel r*tpr + l//c, channel l%c
                lane = jnp.arange(tpr * c, dtype=jnp.uint32)
                texel = (
                    jnp.arange(n_rows, dtype=jnp.uint32)[:, None] * tpr
                    + lane[None, :] // c
                )
                x = texel ^ jnp.uint32(jitter_seed)
                x ^= x >> 16
                x *= jnp.uint32(0x7FEB352D)
                x ^= x >> 15
                x *= jnp.uint32(0x846CA68B)
                x ^= x >> 16
                u = x.astype(jnp.float32) * jnp.float32(2.0**-32)
                scaled = jnp.round(
                    rows.astype(jnp.float32) * (1.0 - jitter * u)
                ).astype(rows.dtype)
                is_ch = (lane % c) == jitter_channel
                rows = jnp.where(is_ch[None, :], scaled, rows)
            if tpr * c < LANES:
                rows = jnp.pad(rows, ((0, 0), (0, LANES - tpr * c)))
            return rows

        return cls(_up_pack(arr.reshape(h, w * c)), H, W, c)

    def __repr__(self):
        return f"Tex2D({self.h}x{self.w}x{self.channels}, rows={self.rows.shape})"


def _fetch_texel(tex: Tex2D, iy, ix):
    """Row-gather fetch of texel (iy, ix) -> (..., C) float in [0,1] for uint8.

    One (n, 128) row gather + a one-hot texel select (elementwise math). The
    row layout is texel-contiguous (texel t's C channels sit at lanes
    [t%tpr*C, ...+C)), so the select reshapes the row to (tpr, C) and
    one-hots over the tpr texels — C-fold less select math than one-hotting
    each channel over all 128 lanes (profiled equal to the gather itself in
    the tracking loops before this change).
    """
    c = tex.channels
    tpr = tex.texels_per_row
    texel = iy * tex.w + ix
    r = texel // tpr
    ti = texel % tpr
    rows = tex.rows[r]  # (..., 128) row gather — the only memory access
    g = rows[..., : tpr * c].reshape(rows.shape[:-1] + (tpr, c))
    sel = jnp.arange(tpr, dtype=ti.dtype) == ti[..., None]
    if rows.dtype == jnp.uint8:
        # select in uint8 (one-hot row ⇒ the u8 reduce cannot overflow) and
        # convert only the C selected channels — converting the full
        # 128-lane row first was the top leaf op in the tracking loops
        picked = jnp.sum(
            jnp.where(sel[..., None], g, jnp.uint8(0)), axis=-2,
            dtype=jnp.uint8,
        )
        return picked.astype(jnp.float32) * (1.0 / 255.0)
    return jnp.sum(g * sel[..., None].astype(rows.dtype), axis=-2)


def _wrap_coords(tex: Tex2D, u, v):
    """(u, v) in [0,1] -> continuous texel coords (x wraps, y clamps)."""
    x = u * tex.w - 0.5
    y = jnp.clip((1.0 - v) * tex.h - 0.5, 0.0, tex.h - 1.0)
    return x, y


def sample_equirect(tex: Tex2D, u, v, bilinear: bool = True):
    """Sample at (u, v) in [0,1]^2. Returns (..., C), squeezed for C=1."""
    x, y = _wrap_coords(tex, u, v)
    if bilinear:
        x0f = jnp.floor(x)
        y0f = jnp.floor(y)
        tx = (x - x0f)[..., None]
        ty = (y - y0f)[..., None]
        x0 = jnp.mod(x0f.astype(jnp.int32), tex.w)
        x1 = jnp.mod(x0 + 1, tex.w)
        y0 = jnp.clip(y0f.astype(jnp.int32), 0, tex.h - 1)
        y1 = jnp.clip(y0 + 1, 0, tex.h - 1)
        v00 = _fetch_texel(tex, y0, x0)
        v10 = _fetch_texel(tex, y0, x1)
        v01 = _fetch_texel(tex, y1, x0)
        v11 = _fetch_texel(tex, y1, x1)
        out = (v00 * (1 - tx) + v10 * tx) * (1 - ty) + (
            v01 * (1 - tx) + v11 * tx
        ) * ty
    else:
        x0 = jnp.mod(jnp.round(x).astype(jnp.int32), tex.w)
        y0 = jnp.clip(jnp.round(y).astype(jnp.int32), 0, tex.h - 1)
        out = _fetch_texel(tex, y0, x0)
    if tex.channels == 1:
        out = out[..., 0]
    return out


def sample_sphere_texture(tex: Tex2D, pos, scale=1.0, bilinear: bool = True):
    """Sample an equirect texture at the direction of ``pos``
    (reference lib/math_utils.py:39-44)."""
    u, v = sphere_uv_map(normalize(pos))
    if scale != 1.0:
        u = fract(u * scale)
        v = fract(v * scale)
    return sample_equirect(tex, u, v, bilinear=bilinear)


def sample_dir_texture(tex: Tex2D, direction, bilinear: bool = True):
    """Sample an equirect texture by unit direction (stars background)."""
    u, v = sphere_uv_map(direction)
    return sample_equirect(tex, u, v, bilinear=bilinear)


def sample_ray_texture(tex: Tex2D, ray_pos, ray_dir, ts, rlen,
                       bilinear: bool = True):
    """Equirect sample at ``ray_pos + ts * ray_dir`` given the precomputed
    radius ``rlen = |ray_pos + ts * ray_dir|`` (TraceConfig.scalar_ray_geom:
    callers on a fixed ray get |pos| for one sqrt of the hoisted ray
    quadratic, so this never materializes (..., 3) position arrays — the
    equirect UV only needs the three components and the radius).

    ray_pos/ray_dir: (n, 3); ts/rlen: (..., n). Equivalent to
    sample_sphere_texture(tex, ray_pos + ts[..., None] * ray_dir) because
    atan2 is scale-invariant and v uses y/|pos|.
    """
    x = ray_pos[..., 0] + ts * ray_dir[..., 0]
    y = ray_pos[..., 1] + ts * ray_dir[..., 1]
    z = ray_pos[..., 2] + ts * ray_dir[..., 2]
    u = (jnp.arctan2(z, -x) * (1.0 / np.pi) + 1.0) * 0.5
    v = jnp.arcsin(jnp.clip(y / rlen, -1.0, 1.0)) * (1.0 / np.pi) + 0.5
    return sample_equirect(tex, u, v, bilinear=bilinear)
