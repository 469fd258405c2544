#!/usr/bin/env python
"""Instrument the PRODUCTION intersect_land loop (tools/march_hist.py keeps
a frozen round-2 replica for budget-sensitivity archaeology; this tool
records the real loop, stall termination / tight-mip skip / exact ocean hit
included, by swapping lax.while_loop for a recording fixed-length scan).

Reports the per-iteration still-marching curve and, for the lanes that
exhaust the probe budget, their geometry (altitude, grazing angle, stride
regime) — the worst-lane tail that paces every march while_loop.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

APOLLO = {
    "pos": (35963490.23139822, 12765367.037276791, -42445899.29884433),
    "look": (23201393.603171505, 8394073.279136525, -26074562.13501193),
    "up": (0.26080361881808384, 0.6750209397555819, -0.6901653449014103),
    "fov": 0.12692034034212948,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--texture-res", type=int, default=1024)
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--any-hit", action="store_true")
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
    scale = jnp.float32(7800.0)

    rng = np.random.default_rng(0)
    n = args.n
    cam = np.asarray(APOLLO["pos"])
    look = np.asarray(APOLLO["look"])
    fwd = (look - cam) / np.linalg.norm(look - cam)
    up = np.asarray(APOLLO["up"])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    vup = np.cross(right, fwd)
    half = n // 2
    uv = (rng.random((half, 2)) - 0.5) * APOLLO["fov"]
    dirs_cam = fwd[None] + uv[:, :1] * right[None] + uv[:, 1:] * vup[None]
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    pos_cam = np.broadcast_to(cam, (half, 3))
    u = rng.normal(size=(n - half, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pos_srf = u * (C.PLANET_R + rng.random((n - half, 1)) * 30e3)
    d = rng.normal(size=(n - half, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    flip = np.sum(d * u, axis=-1) < 0.0
    d[flip] -= 2 * np.sum(d[flip] * u[flip], axis=-1, keepdims=True) * u[flip]
    pos = jnp.asarray(np.concatenate([pos_cam, pos_srf]), jnp.float32)
    dirs = jnp.asarray(np.concatenate([dirs_cam, d]), jnp.float32)
    active = jnp.ones((n,), bool)

    # swap while_loop for a recording scan of the same trip budget
    records = {}
    orig_while = jax.lax.while_loop

    def recording_while(cond, body, init):
        length = cfg.land_march_steps // cfg.march_k + 1

        def sbody(s, _):
            run = cond(s)
            s2 = body(s)
            s_next = jax.tree_util.tree_map(
                lambda a, b: jnp.where(run, b, a), s, s2
            )
            # state layout (pathtracer.intersect_land): i, t, stride, done,
            # missed, stall
            return s_next, (jnp.sum(~s[3]), s[1], s[2])

        final, (alive, t_hist, stride_hist) = jax.lax.scan(
            sbody, init, None, length=length
        )
        records["alive"] = alive
        records["t_hist"] = t_hist
        records["stride_hist"] = stride_hist
        records["final"] = final
        return final

    jax.lax.while_loop = recording_while
    try:
        res = pt.intersect_land(
            atlas.topography, pos, dirs, scale, active, cfg,
            any_hit=args.any_hit,
        )
        res, alive, t_hist, stride_hist, final = jax.device_get(
            (res, records["alive"], records["t_hist"],
             records["stride_hist"], records["final"])
        )
    finally:
        jax.lax.while_loop = orig_while

    done = final[3]
    may = int(n - int(alive[0] == 0) * n) if alive.ndim == 0 else None
    print(f"lanes: {n}, marching at iter 0: {int(alive[0])}")
    print("iteration -> lanes still marching:")
    for m in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, len(alive) - 1):
        if m < len(alive):
            print(f"  iter {m:3d} ({m*cfg.march_k:4d} probes): "
                  f"{int(alive[m]):6d}")

    exhausted = ~np.asarray(done)
    n_ex = int(exhausted.sum())
    print(f"\nbudget-exhausted lanes: {n_ex}")
    if n_ex:
        p = np.asarray(pos)[exhausted]
        dd = np.asarray(dirs)[exhausted]
        t_end = np.asarray(final[1])[exhausted]
        stride_end = np.asarray(final[2])[exhausted]
        probe = p + t_end[:, None] * dd
        r = np.linalg.norm(probe, axis=-1)
        alt = r - C.PLANET_R
        up_p = probe / r[:, None]
        graze = np.abs(np.sum(up_p * dd, axis=-1))  # |cos| vs local up
        origin_alt = np.linalg.norm(p, axis=-1) - C.PLANET_R
        tex_arc = np.pi * C.PLANET_R / atlas.topography.w
        print("  at-budget altitude km: p10/p50/p90 = "
              f"{np.percentile(alt/1e3,10):.1f}/"
              f"{np.percentile(alt/1e3,50):.1f}/"
              f"{np.percentile(alt/1e3,90):.1f}")
        print("  |cos(dir, local up)|: p10/p50/p90 = "
              f"{np.percentile(graze,10):.4f}/"
              f"{np.percentile(graze,50):.4f}/"
              f"{np.percentile(graze,90):.4f}")
        print("  origin altitude km: p10/p50/p90 = "
              f"{np.percentile(origin_alt/1e3,10):.1f}/"
              f"{np.percentile(origin_alt/1e3,50):.1f}/"
              f"{np.percentile(origin_alt/1e3,90):.1f}")
        print("  final stride / texel arc: p10/p50/p90 = "
              f"{np.percentile(stride_end/tex_arc,10):.3f}/"
              f"{np.percentile(stride_end/tex_arc,50):.3f}/"
              f"{np.percentile(stride_end/tex_arc,90):.3f}")
        print("  camera-ray fraction: "
              f"{np.mean(np.where(exhausted)[0] < half):.2f}")


if __name__ == "__main__":
    main()
