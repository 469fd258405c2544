"""Renderer orchestration: owns the accumulation buffer, camera/scene state,
textures and LUTs, and the jitted tiled render step.

API parity with the reference Renderer (renderer.py:16-384): ``set_*``
setters, ``accumulate()`` (one progressive spp), ``fetch_image()`` (post
chain), ``reset_framebuffer()``. Differences by design:

- all state lives in pytrees passed to jitted functions (no recompiles on
  parameter changes, no global fields);
- the pixel grid is traced in tiles (``lax.map``) so the bounce/tracking
  while-loops exit early per tile instead of per frame — the wavefront
  replacement for the reference's 16x8 block-interleaved buffer
  (renderer.py:43-46);
- the accumulation buffer is donated between spp steps (no copies);
- rendering is deterministic: frame seed + spp index + tile index derive all
  randomness.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..assets.luts import CRFPack, SpectralLUTs, load_crf_pack, load_spectral_luts
from ..assets.textures import TextureAtlas, load_texture_atlas
from ..ops import rng
from ..ops import spectral as sp
from ..ops.math_utils import HIGHEST
from . import film
from .camera import CameraParams, cast_dirs
from .params import SceneParams, TraceConfig, make_scene_params
from . import pathtracer as pt

# Frame-level RNG sites (folded into per-lane pixel keys; disjoint from the
# pathtracer's per-bounce site ids by construction — different chain depth —
# and kept out of the bounce-index range anyway).
_SITE_JITTER = 101
_SITE_WL = 102
# spp-free pixel key domain for the Cranley-Patterson rotations of the
# stratified primary dimensions (cfg.stratify_spp)
_PIXEL_DOMAIN = 0x70697865
# R3 low-discrepancy sequence step (inverse powers of the plastic constant,
# Roberts 2018): x_n = frac(alpha * n), jointly low-discrepancy in 3D.
# Stored as 32-bit fixed point so frac() is exact uint32 wraparound at any
# spp (float32 alpha*n loses the fractional part past n ~ 1e5).
_R3_G = 1.2207440846057596
_R3_A32 = tuple(
    int(round((1.0 / _R3_G**i % 1.0) * 2**32)) & 0xFFFFFFFF for i in (1, 2, 3)
)


def _pick_block_dims(w: int, h: int, target: int) -> Tuple[int, int]:
    """Near-square (bw, bh) with bw | w, bh | h and bw*bh <= target.

    Tiles are rectangular pixel blocks rather than flat spans: rays in a
    block are spatially coherent, so whole sky blocks exit the bounce loop
    immediately and only blocks that actually contain the planet limb pay
    the worst-case march/tracking iteration counts. This is the wavefront
    counterpart of the reference's 16x8 block-interleaved framebuffer
    (reference renderer.py:43-46), used for coherence instead of
    divergence-hiding.
    """
    divs_w = [d for d in range(1, w + 1) if w % d == 0]
    divs_h = [d for d in range(1, h + 1) if h % d == 0]
    best = (1, 1)
    best_score = -1.0
    for bw in divs_w:
        for bh in divs_h:
            n = bw * bh
            if n > target:
                continue
            squareness = min(bw, bh) / max(bw, bh)
            score = n * (0.5 + 0.5 * squareness)
            if score > best_score:
                best_score = score
                best = (bw, bh)
    return best


def _compact_by_alive(tree, alive, work_class=None, n_bins=3):
    """Stable partition of every (N, ...) leaf: alive lanes first, dead
    last. With ``work_class`` (int32 in [0, n_bins)), alive lanes are
    additionally binned by class — a stable counting sort — so each
    compact-tile's lanes share an iteration profile (tracking loops run at
    worst-lane pace; a mixed tile runs every lane at the slowest class's
    trip count).

    Static shapes throughout: cumsum-based ranks, one scatter to build the
    permutation, one gather per leaf. Returns (permuted_tree, src_perm)."""
    n = alive.shape[0]
    if work_class is None:
        key = jnp.where(alive, 0, 1)
        n_bins = 2
    else:
        key = jnp.where(alive, jnp.clip(work_class, 0, n_bins - 1), n_bins)
        n_bins = n_bins + 1
    one_hot = key[None, :] == jnp.arange(n_bins, dtype=key.dtype)[:, None]
    ranks = jnp.cumsum(one_hot, axis=1)  # (n_bins, N) 1-based rank in bin
    counts = ranks[:, -1]
    offsets = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                               jnp.cumsum(counts)[:-1]])
    dest = (offsets[key] + ranks[key, jnp.arange(n)] - 1).astype(jnp.int32)
    src = jnp.zeros((n,), dtype=jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32)
    )
    return jax.tree_util.tree_map(lambda a: a[src], tree), src


def _stage_bounds(cfg: TraceConfig):
    """Static bounce-stage boundaries [0, b1, b2, ..., max_bounces]. (The
    compiled scheduler sweeps stages after b1 dynamically with one stage
    executable; this helper documents/tests the boundary schedule.)"""
    if cfg.compact_after <= 0 or cfg.compact_after >= cfg.max_bounces:
        return [0, cfg.max_bounces]
    bounds = [0, cfg.compact_after]
    while bounds[-1] < cfg.max_bounces:
        bounds.append(min(bounds[-1] + cfg.compact_every, cfg.max_bounces))
    return bounds


def _trace_tile_range(
    base_key, spp, cam: CameraParams, scene: SceneParams, atlas, luts,
    image_res: Tuple[int, int], block: Tuple[int, int], cfg: TraceConfig,
    tile0, n_tiles_range: int, mode: str = "path", tile_ids=None,
):
    """Render the pixel blocks [tile0, tile0 + n_tiles_range): stage-1
    bounces per spatially-coherent (bw, bh) block, then compacted tail
    stages over this range's whole wavefront. Returns
    (n_tiles_range * bw * bh, 3) linear RGB in tile-major lane order.

    This is THE render pipeline, shared verbatim by the single-chip renderer
    (one range covering the frame) and the multi-chip renderer (one range
    per "px"-axis device, ``tile0`` from the device's mesh coordinate).
    All randomness is per-lane, keyed by (frame key, global pixel id)
    (ops/rng.py), and compaction/tiling only permute lanes, so a pixel's
    value is bit-identical no matter how the frame is cut into ranges —
    asserted across mesh shapes and against the single-chip renderer in
    tests/test_parallel.py.

    Two-level scheduling (cfg.compact_after > 0): blocks trace bounces
    [0, compact_after) and shade misses; the surviving wavefront is then
    compacted alive-lanes-first (binned by workload class) between each
    subsequent stage of compact_every bounces, so the long cloud
    multi-scatter tail runs only ceil(alive/compact_tile) tiles instead of
    every tile at worst-lane pace."""
    w, h = image_res
    bw, bh = block
    tile = bw * bh
    nbx, nby = w // bw, h // bh
    n_tiles = n_tiles_range
    stages = _stage_bounds(cfg)
    spp = jnp.asarray(spp, jnp.int32)
    spp_key = jax.random.fold_in(base_key, spp)

    def gen_rays(tidx, li):
        """Per-lane ray gen + primary-dimension sampling for lanes at
        in-tile index ``li`` of pixel-block ``tidx`` (both (m,) arrays).

        All randomness is per-lane, keyed by (frame key, global pixel id)
        (ops/rng.py), so the rendered frame is bit-identical under any
        tile/block/mesh layout — including the binned_stage1 frame-wide
        path, which calls this once for every lane in the range."""
        bx = tidx // nby
        by = tidx % nby
        pu_i = bx * bw + li // bh
        pv_i = by * bh + li % bh
        pid = pu_i * h + pv_i  # global pixel id
        lkeys = rng.lane_keys(spp_key, pid)
        pu = pu_i.astype(jnp.float32)
        pv = pv_i.astype(jnp.float32)
        if cfg.stratify_spp:
            # randomized-QMC primary dims: per-pixel Cranley-Patterson
            # shift (spp-free key) + R3 sequence point for this spp
            pkeys = rng.lane_keys(
                jax.random.fold_in(base_key, _PIXEL_DOMAIN), pid
            )
            shift = rng.uniform(rng.fold(pkeys, _SITE_JITTER), (3,))
            seq = (
                jnp.asarray(_R3_A32, jnp.uint32)
                * (spp + 1).astype(jnp.uint32)
            ).astype(jnp.float32) * jnp.float32(2.0**-32)
            u3 = jnp.mod(shift + seq[:, None], 1.0)  # (3, n)
            u_jit, u = u3[:2], u3[2]
        else:
            u_jit = rng.uniform(rng.fold(lkeys, _SITE_JITTER), (2,))
            u = rng.uniform(rng.fold(lkeys, _SITE_WL))
        dirs = cast_dirs(cam, pu, pv, u_jit[0], u_jit[1], image_res)
        pos = jnp.broadcast_to(cam.position, (tidx.shape[0], 3))
        return lkeys, dirs, pos, u

    def render_tile(tile_idx):
        """Ray gen + spectral sampling + stage-1 bounces (+ miss shading),
        one spatially-coherent pixel block at a time."""
        lane = jnp.arange(tile)
        tidx = jnp.full((tile,), tile_idx)
        lkeys, dirs, pos, u = gen_rays(tidx, lane)
        if mode == "preview":
            from .raymarcher import march_paths

            wavelength, response, rcp_pdf = sp.spectrum_sample(
                u, luts.cie_cdf, luts.cie_response
            )
            radiance = march_paths(
                jax.random.fold_in(spp_key, tile_idx), pos, dirs, wavelength,
                scene, atlas, luts, cfg,
            )
            xyz = radiance[:, None] * response * rcp_pdf[:, None]
            return sp.xyz_to_rgb(xyz), None
        wavelengths, responses, lambda_pdf = sp.spectrum_sample_hero(
            u, luts.cie_cdf, luts.cie_response, cfg.hero_lambdas
        )
        st = pt.init_state(pos, dirs, wavelengths, lambda_pdf,
                           rng_keys=lkeys)
        st = pt.run_bounces(
            st, scene, atlas, luts, cfg, 0, stages[1],
            unroll=stages[1],
        )
        st = pt.shade_primary_miss(st, scene, atlas, luts, cfg)
        return responses, st

    def run_staged(st, responses, lane_id, n, b_init):
        """Compacted-stage sweep: ONE compiled stage executable swept over a
        dynamic bounce window; the while_loop exits as soon as the whole
        range dies, so cloudless frames pay zero tail stages."""
        width = cfg.compact_every
        # largest divisor of n that is <= compact_tile and a multiple of
        # 128 (an alignment not yet retuned for the GPU). Falling back
        # to ctile = tile whenever compact_tile doesn't divide n would run
        # the ENTIRE tail at stage-1 tile granularity (1080p: 2,073,600 is
        # no multiple of a power-of-two budget).
        ctile = tile
        for d in range(cfg.compact_tile, 127, -1):
            if n % d == 0 and d % 128 == 0:
                ctile = d
                break
        n_ctiles = n // ctile

        def stage_cond(carry):
            b0 = carry[0]
            alive = carry[1].alive
            return (b0 < cfg.max_bounces) & jnp.any(alive)

        def stage_body(carry):
            b0, st, responses, lane_id = carry
            (st, responses, lane_id), _ = _compact_by_alive(
                (st, responses, lane_id), st.alive, st.work_class,
                n_bins=cfg.work_bins,
            )
            # the first window after b_init=0 (binned_stage1) covers
            # compact_after bounces, mirroring the block-tiled schedule
            b1 = jnp.minimum(
                jnp.where(
                    b0 == 0, jnp.maximum(cfg.compact_after, 1), b0 + width
                ),
                cfg.max_bounces,
            )

            def stage_tile(args):
                i, sub = args

                def live(_):
                    # NOT unrolled: a tail tile whose lanes all die mid
                    # stage skips the remaining bounces through the
                    # while condition
                    return pt.run_bounces(
                        sub, scene, atlas, luts, cfg, b0, b1,
                    )

                # compaction packs alive lanes into a tile prefix, so
                # late stages sweep mostly-dead tiles; the cond skips
                # their per-tile pre-loop setup (spectral constants,
                # extinction stacks), not just the bounce loop
                return jax.lax.cond(
                    jnp.any(sub.alive), live, lambda _: sub, None
                )

            sub_states = jax.tree_util.tree_map(
                lambda a: a.reshape((n_ctiles, ctile) + a.shape[1:]), st
            )
            st = jax.lax.map(
                stage_tile, (jnp.arange(n_ctiles), sub_states)
            )
            st = jax.tree_util.tree_map(
                lambda a: a.reshape((n,) + a.shape[2:]), st
            )
            return (b1, st, responses, lane_id)

        _, st, responses, lane_id = jax.lax.while_loop(
            stage_cond,
            stage_body,
            (jnp.asarray(b_init, jnp.int32), st, responses, lane_id),
        )
        return st, responses, lane_id

    if tile_ids is None:
        tile_ids = tile0 + jnp.arange(n_tiles)
    n = n_tiles * tile
    if mode == "preview":
        return jax.lax.map(
            lambda i: render_tile(i)[0], tile_ids
        ).reshape(n, 3)
    elif cfg.binned_stage1:
        # frame-wide class-binned scheduling from bounce 0 (see
        # params.binned_stage1): generate every ray in the range, pre-kill
        # atmosphere misses, and let the compacted-stage sweep (which bins
        # by work_class, including the analytic bounce-0 class) run ALL
        # bounces in width-flat latency-bound tiles.
        lane = jnp.arange(n)
        tidx = tile_ids[lane // tile]
        lkeys, dirs, pos, u = gen_rays(tidx, lane % tile)
        wavelengths, responses, lambda_pdf = sp.spectrum_sample_hero(
            u, luts.cie_cdf, luts.cie_response, cfg.hero_lambdas
        )
        st = pt.init_state(pos, dirs, wavelengths, lambda_pdf,
                           rng_keys=lkeys)
        st = pt.classify_primary(st, scene.land_height_scale, cfg)
        lane_id = jnp.arange(n, dtype=jnp.int32)
        st, responses, lane_id = run_staged(st, responses, lane_id, n, 0)
        # primary-miss lanes froze at bounce 0 (or were pre-killed) with
        # radiance 0 and their camera direction intact, so shading them
        # after the sweep is bit-identical to the per-tile order
        st = pt.shade_primary_miss(st, scene, atlas, luts, cfg)
    else:
        responses, st = jax.lax.map(render_tile, tile_ids)
        responses, st = jax.tree_util.tree_map(
            lambda a: a.reshape((n,) + a.shape[2:]), (responses, st)
        )
        lane_id = jnp.arange(n, dtype=jnp.int32)
        if len(stages) > 2:
            st, responses, lane_id = run_staged(
                st, responses, lane_id, n, stages[1]
            )

    radiance = pt.finalize_radiance(st)
    xyz = jnp.einsum(
        "nl,nlc->nc", radiance, responses, precision=HIGHEST
    )
    rgb = sp.xyz_to_rgb(xyz)
    # un-permute back to tile-major pixel order
    rgb = jnp.zeros_like(rgb).at[lane_id].set(rgb)
    return rgb


@partial(
    jax.jit,
    static_argnames=("image_res", "block", "cfg", "mode"),
    donate_argnames=("color_buffer",),
)
def _render_step(
    base_key, spp, color_buffer, cam: CameraParams, scene: SceneParams,
    atlas, luts,
    image_res: Tuple[int, int], block: Tuple[int, int], cfg: TraceConfig,
    mode: str = "path",
):
    """Add one spp to the (W, H, 3) accumulation buffer. ``mode`` selects the
    integrator: "path" = full spectral path tracing, "preview" = the
    deterministic single-scatter ray marcher (render/raymarcher.py). The
    pipeline itself lives in _trace_tile_range (shared with the multi-chip
    renderer)."""
    w, h = image_res
    bw, bh = block
    tile = bw * bh
    nbx, nby = w // bw, h // bh
    n_tiles = nbx * nby
    rgb = _trace_tile_range(
        base_key, spp, cam, scene, atlas, luts, image_res, block, cfg, 0,
        n_tiles, mode,
    )
    # (nbx*nby, bw*bh, 3) -> (W, H, 3)
    frame = (
        rgb.reshape(nbx, nby, bw, bh, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(w, h, 3)
    )
    return color_buffer + frame


@partial(
    jax.jit,
    static_argnames=("image_res", "block", "cfg", "mode", "n_chunk_tiles"),
    donate_argnames=("staging",),
)
def _render_chunk(
    base_key, spp, staging, cam: CameraParams, scene: SceneParams, atlas,
    luts, tile0,
    image_res: Tuple[int, int], block: Tuple[int, int], cfg: TraceConfig,
    n_chunk_tiles: int, mode: str = "path",
):
    """Render ``n_chunk_tiles`` pixel blocks starting at dynamic ``tile0``
    into the flat tile-major staging buffer. One compiled executable sweeps
    a whole spp chunk by chunk, so the viewer can poll for camera input
    between chunks instead of sitting behind a full-frame dispatch
    (worst-case input-to-preview: one chunk instead of one 1080p spp).
    Per-lane pixel-keyed RNG (ops/rng.py) makes the chunked spp
    bit-identical to the unchunked one."""
    rgb = _trace_tile_range(
        base_key, spp, cam, scene, atlas, luts, image_res, block, cfg,
        tile0, n_chunk_tiles, mode,
    )
    tile = block[0] * block[1]
    return jax.lax.dynamic_update_slice(staging, rgb, (tile0 * tile, 0))


@partial(jax.jit, static_argnames=("image_res", "block"))
def _merge_staging(color_buffer, staging, image_res, block):
    w, h = image_res
    bw, bh = block
    nbx, nby = w // bw, h // bh
    frame = (
        staging.reshape(nbx, nby, bw, bh, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(w, h, 3)
    )
    return color_buffer + frame


@partial(jax.jit, static_argnames=("image_res", "block", "k"))
def _select_tiles(
    color_buffer, count_buffer, lum2_buffer, image_res, block, k: int,
):
    """Pick the ``k`` pixel blocks with the highest estimated relative
    error of their current mean: per pixel, Var[mean] ~ (E[l^2] - E[l]^2)/n
    over the n samples drawn so far, normalized by (mean luminance + eps)^2
    so dark pixels compete fairly with bright ones; per tile, the score is
    the pixel average. Never-sampled tiles score +inf.

    The selection drives the adaptive accumulate (fewer paths to the same
    image — a variance-reduction route; the reference's commented-out
    adaptive-spp controller,
    earth_viewer.py:253-257, adapted the FRAME's spp count, never the
    spatial distribution)."""
    w, h = image_res
    bw, bh = block
    nbx, nby = w // bw, h // bh
    n = jnp.maximum(count_buffer, 1.0)
    mean_lum = sp.lum(color_buffer) / n
    var_mean = jnp.maximum(lum2_buffer / n - mean_lum**2, 0.0) / n
    m_bar = jnp.mean(mean_lum)
    # mid-gray anchor: bright pixels resolve by RELATIVE error, dark ones
    # by absolute error against ~1/5 of the frame mean — matching how the
    # display transform compresses brightness (pure relative normalization
    # lets near-black pixels' tiny denominators dominate the ranking)
    anchor = 0.2 * m_bar + 1e-20
    # exploration optimism: a pixel whose few samples all came back (near)
    # zero reads as zero-variance and would otherwise starve forever, yet
    # deep-shadow pixels lit by RARE paths are exactly the noisiest
    # content. Pretend an undiscovered fifth-of-frame-mean contribution
    # could arrive with probability ~1/n: an O(1/n^2) additive variance
    # floor that decays quadratically as a tile accumulates real evidence
    # (the 0.2 scale keeps early exploration below typical content scores
    # so genuinely noisy tiles still win the first rounds).
    explore = (0.2 * m_bar) ** 2 / n**2
    score = (var_mean + explore) / (mean_lum + anchor) ** 2
    score = jnp.where(count_buffer < 1.0, jnp.inf, score)
    tile_score = (
        score.reshape(nbx, bw, nby, bh).mean(axis=(1, 3)).reshape(-1)
    )  # (nbx*nby,) in bx-major order = tile_idx order
    _, ids = jax.lax.top_k(tile_score, k)
    return ids.astype(jnp.int32)


def _tile_pixel_coords(tile_ids, image_res, block):
    """Global (pu, pv) integer coords for every lane of every tile in
    ``tile_ids``, in the tile-major lane order _trace_tile_range returns."""
    w, h = image_res
    bw, bh = block
    nby = h // bh
    lane = jnp.arange(bw * bh)
    bx = tile_ids[:, None] // nby
    by = tile_ids[:, None] % nby
    pu = bx * bw + lane[None, :] // bh
    pv = by * bh + lane[None, :] % bh
    return pu.reshape(-1), pv.reshape(-1)


@partial(
    jax.jit,
    static_argnames=("image_res", "block", "cfg", "k", "mode"),
    donate_argnames=("color_buffer", "count_buffer", "lum2_buffer"),
)
def _render_selected(
    base_key, rng_round, color_buffer, count_buffer, lum2_buffer, tile_ids,
    cam: CameraParams, scene: SceneParams, atlas, luts,
    image_res: Tuple[int, int], block: Tuple[int, int], cfg: TraceConfig,
    k: int, mode: str = "path",
):
    """Trace one sample per pixel of the ``k`` selected blocks and
    scatter-add into the per-pixel (sum, count, sum-lum^2) buffers. Uses the
    same per-lane (rng_round, global pixel id) keying as _render_step, so a
    pixel's sample for a given round is bit-identical whether it arrives via
    a uniform or an adaptive pass."""
    rgb = _trace_tile_range(
        base_key, rng_round, cam, scene, atlas, luts, image_res, block, cfg,
        0, k, mode, tile_ids=tile_ids,
    )
    pu, pv = _tile_pixel_coords(tile_ids, image_res, block)
    lum = sp.lum(rgb)
    return (
        color_buffer.at[pu, pv].add(rgb),
        count_buffer.at[pu, pv].add(1.0),
        lum2_buffer.at[pu, pv].add(lum * lum),
    )


@partial(jax.jit, static_argnames=("image_res", "drt"))
def _postprocess(
    color_buffer, spp, exposure, gamma, crf_curves, crf_index,
    image_res: Tuple[int, int], drt: str,
):
    return film.postprocess(
        color_buffer, spp, exposure, gamma, crf_curves, crf_index, image_res, drt
    )


class Renderer:
    """Progressive spectral renderer (reference renderer.py:16)."""

    def __init__(
        self,
        image_res: Tuple[int, int] = (1920, 1080),
        up=(0.0, 1.0, 0.0),
        atlas: Optional[TextureAtlas] = None,
        luts: Optional[SpectralLUTs] = None,
        crf: Optional[CRFPack] = None,
        tile_pixels: int = 2048,
        seed: int = 0,
        cfg: TraceConfig = TraceConfig(),
        drt: str = "opendrt",
        mode: str = "path",
    ):
        self.image_res = tuple(image_res)
        self.aspect_ratio = image_res[0] / image_res[1]
        self.cfg = cfg
        self.drt = drt
        self.mode = mode
        self.atlas = atlas if atlas is not None else load_texture_atlas()
        self.luts = luts if luts is not None else load_spectral_luts()
        self.crf = crf if crf is not None else load_crf_pack()
        self.crf_names = list(self.crf.names)

        self.block = _pick_block_dims(image_res[0], image_res[1], tile_pixels)
        self.tile = self.block[0] * self.block[1]

        # Host-side scalar state, mirroring reference defaults
        # (renderer.py:49-58)
        self.camera_pos = np.zeros(3, dtype=np.float64)
        self.look_at = np.zeros(3, dtype=np.float64)
        self.up = np.asarray(up, dtype=np.float64)
        self.up /= np.linalg.norm(self.up)
        self.fov = C.DEFAULT_FOV
        self.aspect_scale = 1.0
        self.exposure = C.DEFAULT_EXPOSURE
        self.gamma = C.DEFAULT_GAMMA
        self.selected_crf = 0
        self.sun_angle = C.DEFAULT_SUN_ANGLE
        self.sun_path_rot = C.DEFAULT_SUN_PATH_ROT
        self.land_height_scale = C.DEFAULT_LAND_HEIGHT_SCALE

        self._base_key = jax.random.PRNGKey(seed)
        self.current_spp = 0
        self.color_buffer = jnp.zeros(
            (image_res[0], image_res[1], 3), dtype=jnp.float32
        )
        self._step = None  # resolved on first accumulate (AOT trace cache)
        # Adaptive-sampling state (accumulate_adaptive): per-pixel sample
        # counts and sum of squared sample luminance; None until the first
        # adaptive pass. _rng_round is the global RNG round counter shared
        # by uniform and adaptive passes (== current_spp when only
        # accumulate() is used, keeping uniform rendering bit-identical).
        self.count_buffer = None
        self.lum2_buffer = None
        self.total_samples = 0
        self._rng_round = 0
        self._adaptive_rounds = 0

    # --- setters (reference renderer.py:224-266) -------------------------
    def set_camera_pos(self, x, y, z):
        self.camera_pos = np.array([x, y, z], dtype=np.float64)

    def set_look_at(self, x, y, z):
        self.look_at = np.array([x, y, z], dtype=np.float64)

    def set_up(self, x, y, z):
        up = np.array([x, y, z], dtype=np.float64)
        self.up = up / np.linalg.norm(up)

    def set_fov(self, fov):
        self.fov = float(fov)

    def set_aspect_scale(self, scale):
        self.aspect_scale = float(scale)

    def set_exposure(self, exposure):
        self.exposure = float(exposure)

    def set_gamma(self, gamma):
        self.gamma = float(gamma)

    def set_crf(self, index):
        self.selected_crf = int(index)

    def set_sun_angle(self, ang):
        self.sun_angle = float(ang)

    def set_sun_path_rot(self, ang):
        self.sun_path_rot = float(ang)

    def set_land_height_scale(self, scale):
        self.land_height_scale = float(scale)

    # --- pytree assembly ---------------------------------------------------
    def _camera_params(self) -> CameraParams:
        return CameraParams(
            position=jnp.asarray(self.camera_pos, dtype=jnp.float32),
            look_at=jnp.asarray(self.look_at, dtype=jnp.float32),
            up=jnp.asarray(self.up, dtype=jnp.float32),
            fov=jnp.asarray(self.fov, dtype=jnp.float32),
            aspect_scale=jnp.asarray(self.aspect_scale, dtype=jnp.float32),
        )

    def _scene_params(self) -> SceneParams:
        return make_scene_params(
            self.sun_angle, self.sun_path_rot, self.land_height_scale
        )

    # --- main API (reference renderer.py:367-384) ---------------------------
    def reset_framebuffer(self):
        self.current_spp = 0
        self.color_buffer = jnp.zeros_like(self.color_buffer)
        self.total_samples = 0
        self._rng_round = 0
        self._adaptive_rounds = 0
        if self.count_buffer is not None:
            self.count_buffer = jnp.zeros_like(self.count_buffer)
            self.lum2_buffer = jnp.zeros_like(self.lum2_buffer)

    def accumulate(self):
        """Trace one sample per pixel into the accumulation buffer."""
        if self.count_buffer is not None:
            # adaptive bookkeeping is live: a uniform pass must keep the
            # per-pixel counts/variance right, so route through it
            self.accumulate_adaptive(frac=1.0)
            return
        rnd = jnp.asarray(self._rng_round, jnp.int32)
        if self._step is None:
            self._step = self._resolve_step(rnd)
        self.color_buffer = self._step(
            self._base_key, rnd, self.color_buffer, self._camera_params(),
            self._scene_params(), self.atlas, self.luts,
        )
        self.current_spp += 1
        self._rng_round += 1
        self.total_samples += self.image_res[0] * self.image_res[1]

    def accumulate_adaptive(self, frac: float = 0.25, min_warmup: int = 2):
        """One adaptive pass: the top ``frac`` fraction of pixel blocks by
        estimated relative variance of their current mean each receive one
        more sample per pixel (_select_tiles). The first ``min_warmup``
        passes (and any pass with ``frac >= 1``) sample every block while
        priming the variance estimate.

        Pixel estimates stay unbiased: each pixel's value is the mean of
        its own samples (fetch_image divides by the per-pixel count), and
        sample round keys don't depend on the selection. The standard
        progressive-adaptive caveat applies: the number of samples a pixel
        receives depends on its earlier samples (a stopping-time effect,
        negligible at the warm-up depths used here and shared by every
        production adaptive sampler); tools/adaptive_bench.py measures the
        end-to-end error-vs-budget win."""
        w, h = self.image_res
        if self.count_buffer is None:
            if self.current_spp:
                raise ValueError(
                    "adaptive accumulation must start from a reset "
                    "framebuffer (per-pixel counts for the earlier uniform "
                    "passes were not tracked)"
                )
            self.count_buffer = jnp.zeros((w, h), dtype=jnp.float32)
            self.lum2_buffer = jnp.zeros((w, h), dtype=jnp.float32)
        bw, bh = self.block
        n_tiles = (w // bw) * (h // bh)
        uniform = self._adaptive_rounds < min_warmup or frac >= 1.0
        k = n_tiles if uniform else max(1, int(n_tiles * frac))
        if k >= n_tiles:
            tile_ids = jnp.arange(n_tiles, dtype=jnp.int32)
            k = n_tiles
        else:
            tile_ids = _select_tiles(
                self.color_buffer, self.count_buffer, self.lum2_buffer,
                self.image_res, self.block, k,
            )
        self.color_buffer, self.count_buffer, self.lum2_buffer = (
            _render_selected(
                self._base_key, jnp.asarray(self._rng_round, jnp.int32),
                self.color_buffer, self.count_buffer, self.lum2_buffer,
                tile_ids, self._camera_params(), self._scene_params(),
                self.atlas, self.luts, image_res=self.image_res,
                block=self.block, cfg=self.cfg, k=k, mode=self.mode,
            )
        )
        self._rng_round += 1
        self._adaptive_rounds += 1
        self.total_samples += k * self.tile
        if uniform:
            self.current_spp += 1

    @property
    def mean_spp(self) -> float:
        """Average samples per pixel (== current_spp for uniform-only)."""
        return self.total_samples / (self.image_res[0] * self.image_res[1])

    def accumulate_interruptible(self, n_chunks: int, interrupt=None) -> bool:
        """Trace one spp in ~``n_chunks`` pixel-block chunks, calling
        ``interrupt()`` between chunks; abort (discarding the partial spp)
        when it returns True. Returns whether the spp completed.

        Bit-identical to ``accumulate()`` for the same seed — the per-lane
        RNG (ops/rng.py) doesn't care how the frame is cut — so the two can
        be mixed freely. Each chunk blocks until the device finishes (that
        is the point: bounded time between interrupt polls)."""
        w, h = self.image_res
        bw, bh = self.block
        n_tiles = (w // bw) * (h // bh)
        n_chunks = max(
            (d for d in range(1, min(n_chunks, n_tiles) + 1)
             if n_tiles % d == 0),
            default=1,
        )
        per = n_tiles // n_chunks
        if self.count_buffer is not None:
            raise ValueError(
                "interruptible accumulation does not track the adaptive "
                "per-pixel counts; use accumulate_adaptive or reset first"
            )
        spp = jnp.asarray(self._rng_round, jnp.int32)
        cam, scene = self._camera_params(), self._scene_params()
        staging = jnp.zeros((n_tiles * self.tile, 3), dtype=jnp.float32)
        for c in range(n_chunks):
            staging = _render_chunk(
                self._base_key, spp, staging, cam, scene, self.atlas,
                self.luts, jnp.asarray(c * per, jnp.int32),
                image_res=self.image_res, block=self.block, cfg=self.cfg,
                n_chunk_tiles=per, mode=self.mode,
            )
            if interrupt is not None and c + 1 < n_chunks:
                staging.block_until_ready()
                if interrupt():
                    return False
        self.color_buffer = _merge_staging(
            self.color_buffer, staging, self.image_res, self.block
        )
        self.current_spp += 1
        self._rng_round += 1
        self.total_samples += w * h
        return True

    def _resolve_step(self, spp):
        """Bind the static render-step arguments and route through the AOT
        trace cache (utils/cache.aot_cached): a warm process deserializes the
        exported StableHLO instead of re-tracing the 1080p graph."""
        from ..utils.cache import aot_cached

        statics = dict(
            image_res=self.image_res, block=self.block, cfg=self.cfg,
            mode=self.mode,
        )

        def bound_step(base_key, spp, color_buffer, cam, scene, atlas, luts):
            return _render_step(base_key, spp, color_buffer, cam, scene,
                                atlas, luts, **statics)

        example = (
            self._base_key, spp, self.color_buffer, self._camera_params(),
            self._scene_params(), self.atlas, self.luts,
        )
        return aot_cached(
            "render_step", jax.jit(bound_step), example, repr(statics)
        )

    def fetch_image(self):
        """Post-process the accumulation buffer; returns (W, H, 3) float sRGB."""
        spp_arg = (
            self.count_buffer[..., None]
            if self.count_buffer is not None
            else jnp.asarray(self.current_spp, dtype=jnp.float32)
        )
        return _postprocess(
            self.color_buffer,
            spp_arg,
            jnp.asarray(self.exposure, dtype=jnp.float32),
            jnp.asarray(self.gamma, dtype=jnp.float32),
            self.crf.curves,
            jnp.asarray(self.selected_crf, dtype=jnp.int32),
            self.image_res,
            self.drt,
        )

    def fetch_image_np(self) -> np.ndarray:
        """(H, W, 3) uint8, row 0 at top — ready for PIL/imageio."""
        img = np.asarray(self.fetch_image())
        img = np.transpose(img, (1, 0, 2))[::-1]
        return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    # --- render-state checkpointing (capability noted in SURVEY.md §5) ------
    def save_checkpoint(self, path: str):
        """Serialize the resumable render state (accumulation buffer + spp,
        plus the adaptive per-pixel bookkeeping when live)."""
        extra = {}
        if self.count_buffer is not None:
            extra = dict(
                count_buffer=np.asarray(self.count_buffer),
                lum2_buffer=np.asarray(self.lum2_buffer),
            )
        np.savez_compressed(
            path,
            color_buffer=np.asarray(self.color_buffer),
            current_spp=self.current_spp,
            seed_key=np.asarray(self._base_key),
            rng_round=self._rng_round,
            adaptive_rounds=self._adaptive_rounds,
            total_samples=self.total_samples,
            **extra,
        )

    def load_checkpoint(self, path: str):
        with np.load(path) as z:
            self.color_buffer = jnp.asarray(z["color_buffer"])
            self.current_spp = int(z["current_spp"])
            self._base_key = jnp.asarray(z["seed_key"], dtype=jnp.uint32)
            # pre-adaptive checkpoints carry no round counters
            self._rng_round = int(z["rng_round"]) if "rng_round" in z else (
                self.current_spp
            )
            self._adaptive_rounds = (
                int(z["adaptive_rounds"]) if "adaptive_rounds" in z else 0
            )
            self.total_samples = (
                int(z["total_samples"]) if "total_samples" in z
                else self.current_spp * self.image_res[0] * self.image_res[1]
            )
            if "count_buffer" in z:
                self.count_buffer = jnp.asarray(z["count_buffer"])
                self.lum2_buffer = jnp.asarray(z["lum2_buffer"])
            else:
                self.count_buffer = None
                self.lum2_buffer = None
