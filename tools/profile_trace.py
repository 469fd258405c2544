#!/usr/bin/env python
"""Per-op device profile of the render step's two schedules:

- stage 1: one spatially-coherent pixel-block tile (ray gen + bounce 0 +
  miss shading), the `render_tile` closure of renderer._render_step;
- tail stage: one compacted-wavefront `run_bounces` call over a
  class-binned tile (the post-compaction workload).

A full-frame trace can overflow the profiler's event cap, so each call is
traced in isolation: warm up, trace a few repeats, then
aggregate the XLA-Ops thread events from the chrome trace by op category.

Usage: python tools/profile_trace.py [--which stage1|tail|both] [--scene N]
"""

import argparse
import collections
import glob
import gzip
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

APOLLO = {
    "pos": (35963490.23139822, 12765367.037276791, -42445899.29884433),
    "look": (23201393.603171505, 8394073.279136525, -26074562.13501193),
    "up": (0.26080361881808384, 0.6750209397555819, -0.6901653449014103),
    "fov": 0.12692034034212948,
    "sun_angle": 5.0813688841507325,
    "sun_path_rot": -1.7096024133386984,
}
def _categorize(name: str) -> str:
    """Map an XLA op name to a coarse category."""
    n = name.lower()
    if "gather" in n or "dynamic-slice" in n or "dynamicslice" in n:
        return "gather"
    if "scatter" in n or "dynamic-update" in n:
        return "scatter"
    if "fusion" in n:
        return "fusion"
    if "while" in n:
        return "while(overhead)"
    if "copy" in n or "bitcast" in n or "transpose" in n or "reshape" in n:
        return "copy/layout"
    if "all-reduce" in n or "collective" in n:
        return "collective"
    if "convert" in n:
        return "convert"
    if "rng" in n:
        return "rng"
    return "other"


def aggregate_trace(trace_dir: str, top: int = 40):
    """Aggregate XLA-Ops events from the newest chrome trace under
    trace_dir; returns (by_source, by_name, total_us)."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime,
    )
    assert paths, f"no trace under {trace_dir}"
    with gzip.open(paths[-1], "rt") as f:
        data = json.load(f)
    events = data["traceEvents"]
    # find the XLA Ops thread(s) on the device
    op_tids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tname = e["args"].get("name", "")
            if "XLA Ops" in tname:
                op_tids.add((e["pid"], e["tid"]))
    by_source = collections.Counter()
    by_name = collections.Counter()
    name_counts = collections.Counter()
    total = 0.0
    n_events = 0
    for e in events:
        if e.get("ph") != "X" or (e.get("pid"), e.get("tid")) not in op_tids:
            continue
        dur = e.get("dur", 0.0)
        total += dur
        n_events += 1
        args = e.get("args", {})
        src = args.get("source", "") or args.get("tf_op", "") or "?"
        by_source[src] += dur
        by_name[e.get("name", "?")] += dur
        name_counts[e.get("name", "?")] += 1
    return by_source, by_name, total, n_events, name_counts


def report(tag, trace_dir, reps, wall_s):
    by_source, by_name, total_us, n_events, name_counts = aggregate_trace(
        trace_dir
    )
    print(f"\n=== {tag}: {wall_s/reps*1e3:.1f} ms/call, device ops "
          f"{total_us/reps/1e3:.1f} ms/call, {n_events} events "
          f"({n_events/reps:.0f}/call) ===")
    print("-- by source line --")
    for src, us in by_source.most_common(30):
        print(f"  {us/reps/1e3:9.3f} ms  {src[:110]}")
    print("-- by op name (total ms/call | count/call | us/event) --")
    for name, us in by_name.most_common(40):
        c = name_counts[name]
        print(f"  {us/reps/1e3:9.3f} ms  {c/reps:7.1f}x  "
              f"{us/max(c,1):7.2f} us  {name[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", default="both",
                    choices=["stage1", "tail", "both", "march"])
    ap.add_argument("--texture-res", type=int, default=1024)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--outdir", default="/tmp/de_trace")
    args = ap.parse_args()

    from digital_earth.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from digital_earth.assets.textures import load_texture_atlas
    from digital_earth.render import pathtracer as pt
    from digital_earth.render.renderer import (
        Renderer, _compact_by_alive, _stage_bounds,
    )
    from digital_earth.ops import spectral as sp
    from digital_earth.render.camera import cast_dirs

    atlas = load_texture_atlas(
        procedural_resolution=(args.texture_res, 2 * args.texture_res)
    )
    r = Renderer(
        image_res=(args.width, args.height), atlas=atlas, tile_pixels=args.tile
    )
    r.set_camera_pos(*APOLLO["pos"])
    r.set_look_at(*APOLLO["look"])
    r.set_up(*APOLLO["up"])
    r.set_fov(APOLLO["fov"])
    r.set_sun_angle(APOLLO["sun_angle"])
    r.set_sun_path_rot(APOLLO["sun_path_rot"])

    cam, scene, luts, cfg = r._camera_params(), r._scene_params(), r.luts, r.cfg
    image_res, (bw, bh) = r.image_res, r.block
    tile = bw * bh
    w, h = image_res
    nbx, nby = w // bw, h // bh
    n_tiles = nbx * nby
    stages = _stage_bounds(cfg)
    key = jax.random.PRNGKey(7)

    # --- replicate render_tile for a mid-frame tile (contains the limb) ---
    def stage1_tile(tkey, tile_idx):
        tile_idx = jnp.asarray(tile_idx, jnp.int32)
        k_jit_u, k_jit_v, k_wl, k_tr = jax.random.split(tkey, 4)
        bx = tile_idx // nby
        by = tile_idx % nby
        lane = jnp.arange(tile)
        pu = (bx * bw + lane // bh).astype(jnp.float32)
        pv = (by * bh + lane % bh).astype(jnp.float32)
        dirs = cast_dirs(
            cam, pu, pv,
            jax.random.uniform(k_jit_u, (tile,)),
            jax.random.uniform(k_jit_v, (tile,)),
            image_res,
        )
        pos = jnp.broadcast_to(cam.position, (tile, 3))
        u = jax.random.uniform(k_wl, (tile,))
        wavelengths, responses, lambda_pdf = sp.spectrum_sample_hero(
            u, luts.cie_cdf, luts.cie_response, cfg.hero_lambdas
        )
        st = pt.init_state(pos, dirs, wavelengths, lambda_pdf, rng_keys=k_tr)
        st = pt.run_bounces(st, scene, atlas, luts, cfg, 0, stages[1])
        st = pt.shade_primary_miss(st, scene, atlas, luts, cfg)
        return responses, st

    stage1_jit = jax.jit(stage1_tile)
    mid_tile = n_tiles // 2 + nby // 2

    def run_stage1():
        return stage1_jit(key, mid_tile)

    # --- build a genuine compacted tail-stage workload -------------------
    # run stage 1 over enough tiles to fill one compact tile with alive lanes
    def build_tail_state():
        sts = []
        resps = []
        for i in range(n_tiles // 8, n_tiles, max(1, n_tiles // 64)):
            resp, st = stage1_jit(jax.random.fold_in(key, i), i)
            sts.append(st)
            resps.append(resp)
            n_alive = sum(int(s.alive.sum()) for s in sts)
            if n_alive >= cfg.compact_tile:
                break
        st = jax.tree_util.tree_map(
            lambda *a: jnp.concatenate(a, axis=0), *sts
        )
        (st, _), _ = _compact_by_alive((st, jnp.zeros_like(st.alive)), st.alive,
                                       st.work_class)
        st = jax.tree_util.tree_map(lambda a: a[: cfg.compact_tile], st)
        print(f"tail tile: {int(st.alive.sum())}/{cfg.compact_tile} alive, "
              f"classes {[int((st.work_class[st.alive] == c).sum()) for c in range(3)]}")
        return st

    tail_jit = jax.jit(
        lambda k, st: pt.run_bounces(
            st, scene, atlas, luts, cfg,
            jnp.asarray(stages[1], jnp.int32),
            jnp.asarray(stages[1] + cfg.compact_every, jnp.int32),
        )
    )

    os.makedirs(args.outdir, exist_ok=True)

    def trace_call(tag, fn):
        fn()  # compile+warm
        jax.block_until_ready(fn())
        tdir = os.path.join(args.outdir, tag)
        t0 = time.time()
        with jax.profiler.trace(tdir):
            for _ in range(args.reps):
                out = fn()
            jax.block_until_ready(out)
        wall = time.time() - t0
        report(tag, tdir, args.reps, wall)

    if args.which == "march":
        # ONE intersect_land call on the mid-frame tile's camera rays —
        # the per-op breakdown is attributable purely to the march body
        # (its while iterations dominate the event list).
        k_jit_u, k_jit_v = jax.random.split(key)
        bx = mid_tile // nby
        by = mid_tile % nby
        lane = jnp.arange(tile)
        pu = (bx * bw + lane // bh).astype(jnp.float32)
        pv = (by * bh + lane % bh).astype(jnp.float32)
        dirs = cast_dirs(
            cam, pu, pv,
            jax.random.uniform(k_jit_u, (tile,)),
            jax.random.uniform(k_jit_v, (tile,)),
            image_res,
        )
        pos = jnp.broadcast_to(cam.position, (tile, 3))
        active = jnp.ones((tile,), bool)
        march_jit = jax.jit(
            lambda p, d: pt.intersect_land(
                atlas.topography, p, d, scene.land_height_scale, active, cfg
            )
        )
        trace_call("march", lambda: march_jit(pos, dirs))
        return

    if args.which in ("stage1", "both"):
        trace_call("stage1", run_stage1)
    if args.which in ("tail", "both"):
        st_tail = build_tail_state()
        st_tail = jax.block_until_ready(st_tail)
        trace_call("tail", lambda: tail_jit(key, st_tail))


if __name__ == "__main__":
    main()
