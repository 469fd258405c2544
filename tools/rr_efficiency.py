#!/usr/bin/env python
"""Monte-Carlo efficiency A/B for estimator knobs (e.g. deep-cloud RR).

Efficiency = 1 / (time_per_spp x per-pixel variance): an unbiased knob
that kills deep lanes trades variance for time; it ships only if the
product improves. Variance is estimated across independent seed batches
of the per-batch mean frame, summarized by the median over pixels (robust
to sun-glint fireflies), weighted by mean luminance.

Usage: python tools/rr_efficiency.py --scene sunset --keeps 1.0,0.6,0.4
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {
    "apollo": "config - Apollo 11.txt",
    "florida": "config - florida.txt",
    "sunset": "config - sunset hurricane.txt",
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sunset", choices=list(SCENES))
    ap.add_argument("--keeps", default="1.0,0.6,0.4")
    ap.add_argument("--spp", type=int, default=8, help="spp per seed batch")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--texture-res", type=int, default=1024)
    args = ap.parse_args()

    from digital_earth.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import dataclasses

    import numpy as np

    from digital_earth.app.config_io import apply_config, load_config
    from digital_earth.assets.textures import load_texture_atlas
    from digital_earth.render.params import TraceConfig
    from digital_earth.render.renderer import Renderer

    atlas = load_texture_atlas(
        procedural_resolution=(args.texture_res, 2 * args.texture_res)
    )
    config = load_config(os.path.join(ROOT, "scenes", SCENES[args.scene]))

    for keep in [float(x) for x in args.keeps.split(",")]:
        cfg = dataclasses.replace(TraceConfig(), cloud_rr_keep=keep)
        frames = []
        dt = 0.0
        for seed in range(args.seeds):
            r = Renderer(
                image_res=(args.width, args.height), atlas=atlas,
                tile_pixels=2048, seed=seed, cfg=cfg,
            )
            apply_config(r, config)
            r.accumulate()  # warm
            r.color_buffer.block_until_ready()
            r.reset_framebuffer()
            t0 = time.time()
            for _ in range(args.spp):
                r.accumulate()
            r.color_buffer.block_until_ready()
            dt += time.time() - t0
            frames.append(np.asarray(r.color_buffer) / args.spp)
        F = np.stack(frames)  # (seeds, W, H, 3)
        var = F.var(axis=0, ddof=1).mean(-1)  # (W, H)
        lum = F.mean(axis=(0, 3))
        # luminance-relative variance over lit pixels, median for robustness
        lit = lum > np.percentile(lum, 50)
        rel_var = float(np.median(var[lit] / np.maximum(lum[lit] ** 2, 1e-12)))
        t_spp = dt / (args.seeds * args.spp)
        print(
            f"keep={keep:4.2f}: {t_spp*1e3:7.1f} ms/spp, rel pixel var "
            f"{rel_var:.4e}, efficiency {1.0/(t_spp*rel_var):12.1f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
