#!/usr/bin/env python
"""Measure the REAL march/tracker loop-body cost as a function of lane width.

Round-4/5 negative results (straggler narrowing, scalar ray geometry, stacked
skip ops, fast in-loop RNG) killed every *op-diet* theory of the ~95 us/
iteration cost. The remaining fork:

(a) cost/iteration ~ flat in lane width  -> batching more lanes per loop
    iteration (frame-wide subsystem passes with straggler compaction) is a
    multiplicative win: N tiles' loops collapse into one loop whose
    iteration count is the same worst-lane count but paid ONCE;
(b) cost/iteration ~ width               -> only iteration-count reduction
    helps.

Method: one fixed 512-ray workload (grazing limb + steep + in-cloud mix,
deterministic), tiled W/512 times so every width runs the IDENTICAL
distribution and the while trip count is width-invariant. Times
intersect_land and the cloud ratio track at widths 512..30720 in one
process, reporting ns per lane-iteration-equivalent (time / W).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--texture-res", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    from digital_earth.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from digital_earth import constants as C
    from digital_earth.assets.textures import load_texture_atlas
    from digital_earth.render import pathtracer as pt
    from digital_earth.render.params import TraceConfig

    atlas = load_texture_atlas(
        procedural_resolution=(args.texture_res, 2 * args.texture_res)
    )
    cfg = TraceConfig()
    base = 512
    rng = np.random.default_rng(3)
    # grazing limb rays: origin 50 km up, directions pitched -2..+0.5 deg
    # from tangent, random azimuth — the worst-lane march population
    up = np.array([0.0, 1.0, 0.0])
    origin = up * (C.PLANET_R + 50e3)
    az = rng.uniform(0, 2 * np.pi, base)
    pitch = np.deg2rad(rng.uniform(-2.0, 0.5, base))
    tang = np.stack([np.cos(az), np.zeros(base), np.sin(az)], -1)
    d = tang * np.cos(pitch)[:, None] - up[None] * np.sin(pitch)[:, None]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    scale = jnp.float32(7800.0)

    print("width   march_ms  march_ns/lane   ratio_ms  ratio_ns/lane")
    for w in (512, 2048, 4096, 8192, 16384, 32768):
        reps_tile = w // base
        pos = jnp.asarray(np.tile(origin[None], (w, 1)), jnp.float32)
        dirs = jnp.asarray(np.tile(d, (reps_tile, 1)), jnp.float32)
        act = jnp.ones((w,), bool)

        march = jax.jit(
            lambda p, dd, a: pt.intersect_land(
                atlas.topography, p, dd, scale, a, cfg
            )
        )
        r = march(pos, dirs, act)
        r.block_until_ready()
        t0 = time.time()
        for _ in range(args.reps):
            r = march(pos, dirs, act)
        r.block_until_ready()
        march_ms = (time.time() - t0) / args.reps * 1e3

        ext_w = jnp.full((w,), C.CLOUDS_EXTINCT)
        t0s = jnp.zeros((w,))
        t1s = jnp.full((w,), 600e3)
        keys = jnp.asarray(
            np.tile(
                np.asarray(
                    jax.vmap(jax.random.fold_in, (None, 0))(
                        jax.random.PRNGKey(0), jnp.arange(base)
                    )
                ),
                (reps_tile, 1),
            ),
            jnp.uint32,
        )
        ratio = jax.jit(
            lambda k, p, dd, a, e: pt._track_cloud(
                k, p, dd, t0s, t1s, e, e * C.CLOUDS_DENSITY,
                atlas.clouds, a, cfg, mode="ratio",
            )
        )
        rr2 = ratio(keys, pos, dirs, act, ext_w)
        rr2.block_until_ready()
        t0 = time.time()
        for _ in range(args.reps):
            rr2 = ratio(keys, pos, dirs, act, ext_w)
        rr2.block_until_ready()
        ratio_ms = (time.time() - t0) / args.reps * 1e3

        print(
            f"{w:6d} {march_ms:9.3f} {march_ms * 1e6 / w:12.1f} "
            f"{ratio_ms:10.3f} {ratio_ms * 1e6 / w:12.1f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
