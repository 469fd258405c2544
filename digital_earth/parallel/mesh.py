"""Multi-chip rendering over a ``jax.sharding.Mesh``.

The reference is single-GPU (SURVEY.md §2.4); its only parallelism is the
per-pixel grid. Samples are embarrassingly parallel and the only reduction is
the accumulation-buffer sum, so the scaling design is:

- a 2D mesh ("px", "spp"): the frame's pixel blocks are sharded across the
  "px" axis (each device owns a contiguous range of blocks), and
  independent spp batches run across the "spp" axis;
- each device runs THE single-chip pipeline — renderer._trace_tile_range,
  with its stage compaction and class binning — on its block range, with
  per-lane RNG keyed by (frame key, global pixel id) (ops/rng.py);
- one ``psum`` over the "spp" axis merges the per-spp partial sums (XLA
  hands it to NCCL, over NVLink between the GPUs of one host); the result
  stays sharded over "px" (gathered lazily only when the host fetches the
  image).

The mesh follows the algorithm, not the interconnect: every GPU of a host
reaches every other at the same rate, so any (px, spp) split of the devices
is as good a fit as another.

Because the pipeline and the RNG are layout-independent, the multi-chip
frame is **bit-identical** to the single-chip ``Renderer``'s for the same
seed — asserted in tests/test_parallel.py — so scaling out never changes
the image, only the wall-clock.

Textures and LUTs are replicated onto every device once, at construction
(a tier-2 atlas is ~4.4 GB; sharding it would put the random texture
gathers on the wrong side of the interconnect).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import spectral as sp
from ..render.camera import CameraParams
from ..render.params import SceneParams, TraceConfig
from ..render.renderer import Renderer, _pick_block_dims, _trace_tile_range


def make_render_mesh(
    devices: Optional[Sequence] = None, spp_axis: Optional[int] = None
) -> Mesh:
    """Build the ("px", "spp") render mesh over the given devices.

    ``spp_axis`` controls how many devices trace independent spp batches;
    default: 2 when the device count is even, else 1.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if spp_axis is None:
        spp_axis = 2 if n % 2 == 0 and n > 1 else 1
    assert n % spp_axis == 0, (n, spp_axis)
    arr = np.array(devices).reshape(n // spp_axis, spp_axis)
    return Mesh(arr, ("px", "spp"))


def _pick_sharded_block(w: int, h: int, tile_pixels: int, n_px: int):
    """Block dims whose tile count divides the px axis (largest block
    <= tile_pixels with that property)."""
    for target in range(tile_pixels, 0, -1):
        bw, bh = _pick_block_dims(w, h, target)
        if ((w // bw) * (h // bh)) % n_px == 0:
            return bw, bh
    raise ValueError((w, h, n_px))


def make_sharded_render_step(
    mesh: Mesh,
    image_res: Tuple[int, int],
    cfg: TraceConfig = TraceConfig(),
    tile_pixels: int = 2048,
):
    """Build a jitted multi-chip render step running the single-chip staged
    pipeline (renderer._trace_tile_range) on each device's block range.

    Returns ``(step, n_spp, block)`` where
    ``step(base_key, spp0, color_buffer, cam, scene, atlas, luts)`` adds
    ``n_spp`` spp to the tile-major flat (W*H, 3) accumulation buffer
    (sharded over "px"), and ``spp0`` is the global spp counter before the
    call — spp i uses ``fold_in(base_key, i)``, the exact key chain of the
    single-chip ``Renderer.accumulate``, so frames match it bit for bit.
    """
    w, h = image_res
    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    block = _pick_sharded_block(w, h, tile_pixels, n_px)
    bw, bh = block
    n_tiles = (w // bw) * (h // bh)
    tiles_per_dev = n_tiles // n_px

    def shard_fn(base_key, spp0, color_buffer, cam, scene, atlas, luts):
        px_idx = jax.lax.axis_index("px")
        spp_idx = jax.lax.axis_index("spp")
        rgb = _trace_tile_range(
            base_key, spp0 + spp_idx, cam, scene, atlas, luts, image_res,
            block, cfg, px_idx * tiles_per_dev, tiles_per_dev,
        )
        if n_spp > 1:
            # merge the spp batches; pixels stay sharded
            rgb = jax.lax.psum(rgb, "spp")
        return color_buffer + rgb

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("px"), P(), P(), P(), P()),
        out_specs=P("px"),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(2,)), n_spp, block


def make_sharded_chunk_step(
    mesh: Mesh,
    image_res: Tuple[int, int],
    cfg: TraceConfig,
    block: Tuple[int, int],
    n_chunk_tiles: int,
):
    """Chunked variant of the sharded step for interruptible accumulation:
    every device renders ``n_chunk_tiles`` of ITS tile range per call,
    starting at the dynamic within-range offset ``chunk0``, into the
    "px"-sharded tile-major staging buffer. The host polls for input between
    chunks — the multi-chip twin of renderer._render_chunk. Same per-lane pixel-keyed RNG, so the striped spp is
    bit-identical to the unchunked one."""
    w, h = image_res
    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    bw, bh = block
    tile = bw * bh
    tiles_per_dev = ((w // bw) * (h // bh)) // n_px

    def shard_fn(base_key, spp0, staging, cam, scene, atlas, luts, chunk0):
        px_idx = jax.lax.axis_index("px")
        spp_idx = jax.lax.axis_index("spp")
        rgb = _trace_tile_range(
            base_key, spp0 + spp_idx, cam, scene, atlas, luts, image_res,
            block, cfg, px_idx * tiles_per_dev + chunk0, n_chunk_tiles,
        )
        if n_spp > 1:
            rgb = jax.lax.psum(rgb, "spp")
        return jax.lax.dynamic_update_slice(staging, rgb, (chunk0 * tile, 0))

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("px"), P(), P(), P(), P(), P()),
        out_specs=P("px"),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(2,))


def make_sharded_adaptive_step(
    mesh: Mesh,
    image_res: Tuple[int, int],
    cfg: TraceConfig,
    block: Tuple[int, int],
    k_local: int,
):
    """Sharded adaptive pass: every "px" device scores ITS tiles from its
    shard of the (sum, count, sum-lum^2) buffers and traces one more sample
    per pixel of its ``k_local`` highest-variance tiles (the multi-chip twin
    of renderer._select_tiles + _render_selected).

    Selection is per-device top-k rather than global top-k: it needs no
    cross-device gather, keeps shapes static, and doubles as load balancing
    (every chip refines its own worst tiles, so the pass is never gated by
    one chip owning all the noisy content). The scoring statistic matches
    the single-chip one, including the frame-mean luminance anchor
    (a scalar ``pmean`` over "px" — the only communication besides the
    "spp" psum). Estimates stay unbiased for the same reason the
    single-chip pass's do: per-pixel means over that pixel's own samples,
    with sample keys independent of the selection."""
    w, h = image_res
    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    bw, bh = block
    tile = bw * bh
    tiles_per_dev = ((w // bw) * (h // bh)) // n_px

    def shard_fn(base_key, rng_round, color, count, lum2, cam, scene, atlas,
                 luts, uniform):
        px_idx = jax.lax.axis_index("px")
        spp_idx = jax.lax.axis_index("spp")

        # --- local tile scores (renderer._select_tiles, shard-local) ----
        n = jnp.maximum(count, 1.0)
        mean_lum = sp.lum(color) / n
        var_mean = jnp.maximum(lum2 / n - mean_lum**2, 0.0) / n
        m_bar = jax.lax.pmean(jnp.mean(mean_lum), "px")
        anchor = 0.2 * m_bar + 1e-20
        explore = (0.2 * m_bar) ** 2 / n**2
        score = (var_mean + explore) / (mean_lum + anchor) ** 2
        score = jnp.where(count < 1.0, jnp.inf, score)
        tile_score = score.reshape(tiles_per_dev, tile).mean(axis=1)
        _, local_ids = jax.lax.top_k(tile_score, k_local)
        local_ids = jnp.where(
            uniform, jnp.arange(k_local, dtype=jnp.int32),
            local_ids.astype(jnp.int32),
        )
        tile_ids = px_idx * tiles_per_dev + local_ids

        rgb = _trace_tile_range(
            base_key, rng_round + spp_idx, cam, scene, atlas, luts,
            image_res, block, cfg, 0, k_local, tile_ids=tile_ids,
        )
        lum_s = sp.lum(rgb)
        if n_spp > 1:
            rgb = jax.lax.psum(rgb, "spp")
            lum2_add = jax.lax.psum(lum_s * lum_s, "spp")
        else:
            lum2_add = lum_s * lum_s
        # scatter-add into the local flat tile-major shards
        lanes = (
            local_ids[:, None] * tile + jnp.arange(tile, dtype=jnp.int32)
        ).reshape(-1)
        color = color.at[lanes].add(rgb)
        count = count.at[lanes].add(float(n_spp))
        lum2 = lum2.at[lanes].add(lum2_add)
        return color, count, lum2

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P("px"), P("px"), P("px"), P(), P(), P(), P(), P(),
        ),
        out_specs=(P("px"), P("px"), P("px")),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(2, 3, 4))


class MultiChipRenderer(Renderer):
    """Multi-chip Renderer: the full single-chip API (``set_*``,
    ``accumulate()``, ``fetch_image()``, ``reset_framebuffer()``,
    checkpointing), executing over the device mesh — so the viewer and
    offline render paths run multi-chip by just constructing this class
    instead of Renderer (``main.py --multichip``). Each ``accumulate()``
    adds ``spp_per_step`` samples per pixel (one per "spp"-axis device).

    The accumulation buffer lives flat tile-major, sharded over "px";
    ``fetch_image``/``fetch_buffer`` reassemble the (W, H, 3) frame.
    ``accumulate(cam, scene)`` also accepts explicit params for the
    driver-dryrun/test call shape."""

    def __init__(
        self, mesh, image_res, atlas, luts, cfg=TraceConfig(), seed=0,
        tile_pixels=2048, **renderer_kwargs,
    ):
        super().__init__(
            image_res=image_res, atlas=atlas, luts=luts, cfg=cfg, seed=seed,
            tile_pixels=tile_pixels, **renderer_kwargs,
        )
        self.mesh = mesh
        # replicate once: an array left on one device would be copied to
        # every device on every step
        replicated = NamedSharding(mesh, P())
        self.atlas, self.luts = jax.device_put(
            (self.atlas, self.luts), replicated
        )
        self.step, self.spp_per_step, self.block = make_sharded_render_step(
            mesh, image_res, cfg, tile_pixels
        )
        self.tile = self.block[0] * self.block[1]
        w, h = image_res
        self.tiles_per_dev = (
            (w // self.block[0]) * (h // self.block[1]) // mesh.shape["px"]
        )
        self._sharding = NamedSharding(mesh, P("px"))
        self.color_buffer = self._zeros()
        self._chunk_steps = {}  # n_chunk_tiles -> compiled chunk step
        self._adaptive_steps = {}  # k_local -> compiled adaptive step

    def _zeros(self, channels=3):
        w, h = self.image_res
        shape = (w * h, channels) if channels else (w * h,)
        return jax.device_put(
            jnp.zeros(shape, dtype=jnp.float32), self._sharding
        )

    def reset_framebuffer(self):
        self.current_spp = 0
        self.color_buffer = self._zeros()
        self.total_samples = 0
        self._rng_round = 0
        self._adaptive_rounds = 0
        if self.count_buffer is not None:
            self.count_buffer = self._zeros(channels=0)
            self.lum2_buffer = self._zeros(channels=0)

    def accumulate(self, cam: CameraParams = None, scene: SceneParams = None):
        if self.count_buffer is not None:
            # adaptive bookkeeping is live: keep per-pixel counts right
            self.accumulate_adaptive(frac=1.0, cam=cam, scene=scene)
            return
        cam = self._camera_params() if cam is None else cam
        scene = self._scene_params() if scene is None else scene
        self.color_buffer = self.step(
            self._base_key,
            jnp.asarray(self.current_spp, dtype=jnp.int32),
            self.color_buffer,
            cam,
            scene,
            self.atlas,
            self.luts,
        )
        self.current_spp += self.spp_per_step
        self._rng_round = self.current_spp
        self.total_samples += (
            self.image_res[0] * self.image_res[1] * self.spp_per_step
        )

    def accumulate_interruptible(self, n_chunks, interrupt=None) -> bool:
        """One spp batch in ~``n_chunks`` chunks of every device's tile
        range, polling ``interrupt()`` between chunks (the multi-chip twin
        of Renderer.accumulate_interruptible; bit-identical to
        ``accumulate()`` for the same seed). Worst-case input-to-abort is
        one chunk instead of a full sharded step."""
        if self.count_buffer is not None:
            raise ValueError(
                "interruptible accumulation does not track the adaptive "
                "per-pixel counts; use accumulate_adaptive or reset first"
            )
        n_chunks = max(
            (d for d in range(1, min(n_chunks, self.tiles_per_dev) + 1)
             if self.tiles_per_dev % d == 0),
            default=1,
        )
        per = self.tiles_per_dev // n_chunks
        if per not in self._chunk_steps:
            self._chunk_steps[per] = make_sharded_chunk_step(
                self.mesh, self.image_res, self.cfg, self.block, per
            )
        step = self._chunk_steps[per]
        cam, scene = self._camera_params(), self._scene_params()
        spp0 = jnp.asarray(self.current_spp, jnp.int32)
        staging = self._zeros()
        for c in range(n_chunks):
            staging = step(
                self._base_key, spp0, staging, cam, scene, self.atlas,
                self.luts, jnp.asarray(c * per, jnp.int32),
            )
            if interrupt is not None and c + 1 < n_chunks:
                staging.block_until_ready()
                if interrupt():
                    return False
        self.color_buffer = self.color_buffer + staging
        self.current_spp += self.spp_per_step
        self._rng_round = self.current_spp
        self.total_samples += (
            self.image_res[0] * self.image_res[1] * self.spp_per_step
        )
        return True

    def accumulate_adaptive(
        self, frac: float = 0.25, min_warmup: int = 2, cam=None, scene=None,
    ):
        """Sharded adaptive pass (make_sharded_adaptive_step): each "px"
        device refines the top ``frac`` of ITS tiles by estimated relative
        variance. Selection is per-device (see the step builder's note);
        sample keys follow the same global rng-round chain as the
        single-chip adaptive pass."""
        if self.count_buffer is None:
            if self.current_spp:
                raise ValueError(
                    "adaptive accumulation must start from a reset "
                    "framebuffer (per-pixel counts for the earlier uniform "
                    "passes were not tracked)"
                )
            self.count_buffer = self._zeros(channels=0)
            self.lum2_buffer = self._zeros(channels=0)
        uniform = self._adaptive_rounds < min_warmup or frac >= 1.0
        k_local = (
            self.tiles_per_dev if uniform
            else max(1, min(self.tiles_per_dev,
                            int(self.tiles_per_dev * frac)))
        )
        if k_local not in self._adaptive_steps:
            self._adaptive_steps[k_local] = make_sharded_adaptive_step(
                self.mesh, self.image_res, self.cfg, self.block, k_local
            )
        step = self._adaptive_steps[k_local]
        cam = self._camera_params() if cam is None else cam
        scene = self._scene_params() if scene is None else scene
        self.color_buffer, self.count_buffer, self.lum2_buffer = step(
            self._base_key, jnp.asarray(self._rng_round, jnp.int32),
            self.color_buffer, self.count_buffer, self.lum2_buffer,
            cam, scene, self.atlas, self.luts,
            jnp.asarray(uniform, bool),
        )
        self._rng_round += self.spp_per_step
        self._adaptive_rounds += 1
        self.total_samples += (
            k_local * self.mesh.shape["px"] * self.tile * self.spp_per_step
        )
        if uniform:
            self.current_spp += self.spp_per_step

    def _assemble(self, flat):
        """Undo the tile-major block interleave -> (W, H, ...), on device."""
        w, h = self.image_res
        bw, bh = self.block
        nbx, nby = w // bw, h // bh
        tail = flat.shape[1:]
        perm = (0, 2, 1, 3) + tuple(4 + i for i in range(len(tail)))
        return (
            flat.reshape((nbx, nby, bw, bh) + tail)
            .transpose(perm)
            .reshape((w, h) + tail)
        )

    def _flatten(self, frame):
        """(W, H, ...) image layout -> tile-major flat (W*H, ...)."""
        w, h = self.image_res
        bw, bh = self.block
        nbx, nby = w // bw, h // bh
        tail = frame.shape[2:]
        perm = (0, 2, 1, 3) + tuple(4 + i for i in range(len(tail)))
        return (
            frame.reshape((nbx, bw, nby, bh) + tail)
            .transpose(perm)
            .reshape((w * h,) + tail)
        )

    def _assembled_buffer(self):
        return self._assemble(self.color_buffer)

    def fetch_image(self):
        from ..render.renderer import _postprocess

        spp_arg = (
            self._assemble(self.count_buffer)[..., None]
            if self.count_buffer is not None
            else jnp.asarray(self.current_spp, dtype=jnp.float32)
        )
        return _postprocess(
            self._assembled_buffer(),
            spp_arg,
            jnp.asarray(self.exposure, dtype=jnp.float32),
            jnp.asarray(self.gamma, dtype=jnp.float32),
            self.crf.curves,
            jnp.asarray(self.selected_crf, dtype=jnp.int32),
            self.image_res,
            self.drt,
        )

    def fetch_buffer(self):
        """(W, H, 3) accumulated linear RGB, gathered to host."""
        return np.asarray(self._assembled_buffer())

    def save_checkpoint(self, path: str):
        extra = {}
        if self.count_buffer is not None:
            extra = dict(
                count_buffer=np.asarray(self._assemble(self.count_buffer)),
                lum2_buffer=np.asarray(self._assemble(self.lum2_buffer)),
            )
        np.savez_compressed(
            path,
            color_buffer=self.fetch_buffer(),
            current_spp=self.current_spp,
            seed_key=np.asarray(self._base_key),
            rng_round=self._rng_round,
            adaptive_rounds=self._adaptive_rounds,
            total_samples=self.total_samples,
            **extra,
        )

    def load_checkpoint(self, path: str):
        def _shard(frame):
            return jax.device_put(
                jnp.asarray(self._flatten(np.asarray(frame)), jnp.float32),
                self._sharding,
            )

        with np.load(path) as z:
            self.color_buffer = _shard(z["color_buffer"])
            self.current_spp = int(z["current_spp"])
            self._base_key = jnp.asarray(z["seed_key"], dtype=jnp.uint32)
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
                self.count_buffer = _shard(z["count_buffer"])
                self.lum2_buffer = _shard(z["lum2_buffer"])
            else:
                self.count_buffer = None
                self.lum2_buffer = None
