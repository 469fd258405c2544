#!/usr/bin/env python
"""Measured image-level fidelity: accelerated vs reference-faithful naive
tracking, with statistical power.

Protocol: render the same scene twice per estimator with independent seeds
(A1, A2 accelerated; B1, B2 naive — identical LUTs/textures/scene, L=1 so
the naive tracker's single-wavelength limitation binds both sides). Report:

- per-channel relative error of the image mean:  |mean(A) - mean(B)| / mean(B)
- its Monte-Carlo noise floor: the standard error of the A-B mean difference,
  estimated from the two independent half-runs of each estimator
  (SE = 0.5 * sqrt(d_A^2 + d_B^2) with d = |half1 - half2| of the channel
  mean — the half-difference of two iid halves estimates sqrt(2)*SE(half),
  so the SE of the 2-half average is half of it);
- the per-pixel mean |A-B| vs the per-pixel noise floor |A1-A2|, which bounds
  spatially-localized bias the channel means could hide.

The BASELINE gate is <1% per channel at converged spp; detecting that at the
*image-mean* level needs SE(mean)/mean << 1%, reached at a few hundred spp
because the mean averages over all pixels as well as samples.

Usage: python tools/parity_run.py --scene apollo --spp 512 [--hero 4]
       (--hero N compares hero-packet N vs L=1, both accelerated)
"""

import argparse
import json
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


def render_mean(scene, cfg, atlas, seed, spp, image_res, tile):
    import numpy as np

    from digital_earth.app.config_io import apply_config, load_config
    from digital_earth.render.renderer import Renderer

    r = Renderer(image_res=image_res, atlas=atlas, tile_pixels=tile, seed=seed,
                 cfg=cfg)
    apply_config(r, load_config(os.path.join(ROOT, "scenes", SCENES[scene])))
    t0 = time.time()
    for _ in range(spp):
        r.accumulate()
    buf = np.asarray(r.color_buffer) / spp
    return buf, time.time() - t0


def channel_stats(A1, A2, B1, B2):
    import numpy as np

    A = 0.5 * (A1 + A2)
    B = 0.5 * (B1 + B2)
    out = {}
    mean_rel = []
    noise_rel = []
    for c, name in enumerate("rgb"):
        ma, mb = A[..., c].mean(), B[..., c].mean()
        d_a = abs(A1[..., c].mean() - A2[..., c].mean())
        d_b = abs(B1[..., c].mean() - B2[..., c].mean())
        se = 0.5 * np.sqrt(d_a**2 + d_b**2)
        mean_rel.append(abs(ma - mb) / mb)
        noise_rel.append(se / mb)
        out[name] = {
            "mean_rel_err_pct": 100.0 * abs(ma - mb) / mb,
            "noise_floor_pct": 100.0 * se / mb,
        }
    # per-pixel: mean absolute difference relative to the mean luminance,
    # vs the same statistic between the two halves of A (pure noise)
    lum = B.mean()
    pix_ab = np.abs(A - B).mean() / lum
    pix_noise = np.abs(A1 - A2).mean() / lum / np.sqrt(2.0)
    out["per_pixel"] = {
        "mean_abs_rel_pct": 100.0 * pix_ab,
        "noise_floor_pct": 100.0 * pix_noise,
    }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="apollo", choices=list(SCENES))
    ap.add_argument("--spp", type=int, default=512,
                    help="total spp per estimator (split over 2 seeds)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--texture-res", type=int, default=1024)
    ap.add_argument("--hero", type=int, default=0,
                    help="if > 0: compare hero-packet L=N vs L=1 "
                    "(both accelerated) instead of accelerated-vs-naive")
    ap.add_argument("--march-steps", type=int, default=250)
    args = ap.parse_args()

    from digital_earth.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from digital_earth.assets.textures import load_texture_atlas
    from digital_earth.render.params import TraceConfig

    atlas = load_texture_atlas(
        procedural_resolution=(args.texture_res, 2 * args.texture_res)
    )
    image_res = (args.width, args.height)
    half = args.spp // 2

    if args.hero:
        cfg_a = TraceConfig(hero_lambdas=args.hero)
        cfg_b = TraceConfig(hero_lambdas=1)
        label = f"hero L={args.hero} vs L=1"
    else:
        cfg_a = TraceConfig(hero_lambdas=1)
        cfg_b = TraceConfig(hero_lambdas=1, naive_tracking=True)
        label = "accelerated vs naive (reference-faithful)"

    A1, t1 = render_mean(args.scene, cfg_a, atlas, 0, half, image_res, args.tile)
    A2, t2 = render_mean(args.scene, cfg_a, atlas, 1, half, image_res, args.tile)
    print(f"A ({label.split(' vs ')[0]}): 2 x {half} spp, "
          f"{t1:.0f}+{t2:.0f} s", flush=True)
    B1, t3 = render_mean(args.scene, cfg_b, atlas, 2, half, image_res, args.tile)
    B2, t4 = render_mean(args.scene, cfg_b, atlas, 3, half, image_res, args.tile)
    print(f"B ({label.split(' vs ')[1]}): 2 x {half} spp, "
          f"{t3:.0f}+{t4:.0f} s", flush=True)

    stats = channel_stats(A1, A2, B1, B2)
    result = {
        "comparison": label,
        "scene": args.scene,
        "resolution": [args.width, args.height],
        "spp_per_estimator": 2 * half,
        "texture_res": [2 * args.texture_res, args.texture_res],
        **stats,
    }
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
