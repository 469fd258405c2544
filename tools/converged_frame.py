#!/usr/bin/env python
"""The BASELINE north-star artifact: a CONVERGED Apollo-11 frame, timed.

BASELINE.json metric line 1 is "wall-clock to a 1024-spp converged frame
(Apollo 11 scene)". The production estimator traces hero-wavelength packets
(4 wavelengths per path, measured at ~3.5x lower spectral variance per
path than the reference's single-wavelength estimator), so the
1024-single-wavelength-spp quality point is ~300 packet-spp; ``--spp``
defaults there. Renders end to end on the GPU, saves the frame plus a JSON
sidecar with the measured wall-clock, and prints both.

Usage (tier-2-scale textures, the reference's default experience):
  python tools/converged_frame.py --tier2 --out docs/gallery/apollo_1080p_converged.png
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=300,
                    help="packet-spp (300 ~ 1024 single-wavelength spp at "
                         "the hero packet's ~3.5x variance gain)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tier2", action="store_true",
                    help="device-upsampled tier-2-scale textures "
                         "(21600x10800, the reference default); otherwise "
                         "the 2048x1024 lowres set")
    ap.add_argument("--scene", default="Apollo 11")
    ap.add_argument("--out", default="docs/gallery/apollo_1080p_converged.png")
    args = ap.parse_args()

    from digital_earth.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from digital_earth.app.config_io import load_config
    from digital_earth.app.viewer import render_offline
    from digital_earth.assets.textures import (
        load_texture_atlas, upsampled_procedural_atlas,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = load_config(os.path.join(root, "scenes", f"config - {args.scene}.txt"))

    t_atlas = time.time()
    if args.tier2:
        atlas = upsampled_procedural_atlas((10800, 21600))
    else:
        atlas = load_texture_atlas(procedural_resolution=(1024, 2048))
    atlas.packed.block_until_ready()
    t_atlas = time.time() - t_atlas

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.time()
    r = render_offline(
        scene, spp=args.spp, image_res=(args.width, args.height),
        out_path=args.out, progress_every=25, atlas=atlas,
    )
    wall = time.time() - t0
    result = {
        "scene": args.scene,
        "resolution": [args.width, args.height],
        "packet_spp": args.spp,
        "hero_lambdas": int(r.cfg.hero_lambdas),
        "equiv_single_lambda_spp": (
            round(args.spp * 3.5) if r.cfg.hero_lambdas == 4 else args.spp
        ),
        "tier2_textures": bool(args.tier2),
        "atlas_build_s": round(t_atlas, 1),
        "render_wall_s": round(wall, 1),
        "s_per_packet_spp": round(wall / args.spp, 3),
        "paths_per_sec": round(args.spp * args.width * args.height / wall),
    }
    sidecar = os.path.splitext(args.out)[0] + ".json"
    with open(sidecar, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
