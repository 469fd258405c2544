#!/usr/bin/env python
"""Stage ablation bench: time one 1080p Apollo spp under variant TraceConfigs
to decompose where the frame time goes. Run on the GPU; compare variants
only within one process on one card."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


SCENES = {
    "apollo": "config - Apollo 11.txt",
    "florida": "config - florida.txt",
    "sunset": "config - sunset hurricane.txt",
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tile", type=int, default=1600)
    ap.add_argument("--texture-res", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--scene", default="apollo", choices=sorted(SCENES))
    ap.add_argument(
        "--variants",
        default="full,no_clouds,no_land,atmos_only,L1,k8",
        help="comma-separated variant names",
    )
    args = ap.parse_args()

    from digital_earth.app.config_io import apply_config, load_config
    from digital_earth.assets.textures import (
        load_texture_atlas, upsampled_procedural_atlas,
    )
    from digital_earth.render.params import TraceConfig
    from digital_earth.render.renderer import Renderer
    from digital_earth.utils.cache import enable_compilation_cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene_file = os.path.join(root, "scenes", SCENES[args.scene])

    enable_compilation_cache()

    if args.texture_res >= 4050 and args.texture_res % 1350 == 0:
        # tier-scale: device-side NN upsample of the cached 2700-res base
        # (native numpy synthesis at this scale costs ~50 min host-side)
        atlas = upsampled_procedural_atlas(
            (args.texture_res, 2 * args.texture_res)
        )
    else:
        atlas = load_texture_atlas(
            procedural_resolution=(args.texture_res, 2 * args.texture_res)
        )

    variants = {
        "full": {},
        "no_clouds": {"enable_clouds": False},
        "no_land": {"enable_land": False},
        "atmos_only": {"enable_clouds": False, "enable_land": False},
        "L1": {"hero_lambdas": 1},
        "k8": {"tracking_k": 8},
        "k2": {"tracking_k": 2},
        "bounce1": {"max_bounces": 1},
        "bounce2": {"max_bounces": 2},
        "bounce4": {"max_bounces": 4},
        "bounce8": {"max_bounces": 8},
        "bounce12": {"max_bounces": 12},
        "march125": {"land_march_steps": 125},
        "analytic_off": {"analytic_transmittance": False},
        "eager_march": {"lazy_march": False},
        "flight_off": {"analytic_flight": False},
        "newton6": {"flight_newton_iters": 6},
        "newton8": {"flight_newton_iters": 8},
        "newton10": {"flight_newton_iters": 10},
        "ce3": {"compact_every": 3},
        "ce4": {"compact_every": 4},
        "ce6": {"compact_every": 6},
        "ct16k": {"compact_tile": 16384},
        "ct64k": {"compact_tile": 65536},
        "crr6": {"cloud_rr_keep": 0.6},
        "ce8": {"compact_every": 8},
        "ce12": {"compact_every": 12},
        "ce24": {"compact_every": 24},
        "ce6_ct64k": {"compact_every": 6, "compact_tile": 65536},
        "ce6_crr6": {"compact_every": 6, "cloud_rr_keep": 0.6},
        # NEE share of the frame (cfg.nee_off is a biased DIAGNOSTIC: it
        # compiles out sun-cone sampling + both NEE transmittance tracks)
        "nee_off": {"nee_off": True},
        # deep-cloud path roulette (keep prob on the multi-scatter tail)
        "crr50": {"cloud_rr_keep": 0.5},
        "crr25": {"cloud_rr_keep": 0.25},
        # march-floor fidelity/perf frontier (docs/PARITY.md round 3):
        # 0.02 is the measured-unbiased default; what does it cost?
        "floor25": {"march_floor_frac": 0.25},
        "floor10": {"march_floor_frac": 0.10},
        "floor05": {"march_floor_frac": 0.05},
        "floor02": {"march_floor_frac": 0.02},
        # stage-1 tile size (pixel-block lanes) — sweep in ONE process:
        # comparisons across processes or cards are noisier than the
        # effects under test
        "tile1920": {"tile_pixels": 2048},
        "tile3840": {"tile_pixels": 4096},
        "tile7200": {"tile_pixels": 8192},
        "tile16200": {"tile_pixels": 16384},
        "tile28800": {"tile_pixels": 32768},
        "tile64800": {"tile_pixels": 65536},
        # tail compact-tile granularity at fixed 1920-lane stage-1 tiles
        # (the divisor-aware ctile makes these independent axes at 1080p;
        # achieved ctile in parens): finer tail tiles skip dead tiles
        # sooner via the per-tile cond, coarser amortize op overhead
        "t1920_ct2k": {"tile_pixels": 2048, "compact_tile": 2048},
        "t1920_ct6k": {"tile_pixels": 2048, "compact_tile": 8192},
        "t1920_ct12k": {"tile_pixels": 2048, "compact_tile": 16384},
        "t1920_ct25k": {"tile_pixels": 2048, "compact_tile": 32768},
        "t1920_ct1280": {"tile_pixels": 2048, "compact_tile": 1280},
        "t1920_ct640": {"tile_pixels": 2048, "compact_tile": 640},
        "t1280_ct1280": {"tile_pixels": 1280, "compact_tile": 1280},
        "t1920_ct1920_ce3": {"tile_pixels": 2048, "compact_tile": 2048,
                             "compact_every": 3},
        "t1920_ct1920_ce4": {"tile_pixels": 2048, "compact_tile": 2048,
                             "compact_every": 4},
        "t1920_ct1920_wb5": {"tile_pixels": 2048, "compact_tile": 2048,
                             "work_bins": 5},
        "t1920_ct1280_wb5": {"tile_pixels": 2048, "compact_tile": 1280,
                             "work_bins": 5},
        "t1920_ce4_wb5": {"tile_pixels": 2048, "compact_tile": 2048,
                          "compact_every": 4, "work_bins": 5},
        "t1920_ce2": {"tile_pixels": 2048, "compact_tile": 2048,
                      "compact_every": 2},
        # straggler narrowing of the march/tracker while loops
        # (params.loop_narrow): anchor = the default (narrow 256 after 2)
        "narrow_off": {"tile_pixels": 2048, "loop_narrow": 0},
        "narrow128": {"tile_pixels": 2048, "loop_narrow": 128},
        "narrow512": {"tile_pixels": 2048, "loop_narrow": 512},
        "narrow_na1": {"tile_pixels": 2048, "loop_narrow_after": 1},
        "narrow_na4": {"tile_pixels": 2048, "loop_narrow_after": 4},
        # probes per loop iteration at the default tile width, where the
        # per-iteration cost may be fixed-overhead-bound
        "mk8": {"tile_pixels": 2048, "march_k": 8},
        "mk16": {"tile_pixels": 2048, "march_k": 16},
        "tk8": {"tile_pixels": 2048, "tracking_k": 8},
        "tk16": {"tile_pixels": 2048, "tracking_k": 16},
        "mk8_tk8": {"tile_pixels": 2048, "march_k": 8, "tracking_k": 8},
        "mk16_tk16": {"tile_pixels": 2048, "march_k": 16, "tracking_k": 16},
        "mk32_tk32": {"tile_pixels": 2048, "march_k": 32, "tracking_k": 32},
        # scalar ray geometry (hoisted ray quadratic) in march + trackers
        "scalar_off": {"tile_pixels": 2048, "scalar_ray_geom": False},
        "scalar_on": {"tile_pixels": 2048, "scalar_ray_geom": True},
        # march floor 0.005: the floor-linear tunneling bias measured at
        # -0.55% +- 0.55 apollo B (inside the gate; docs/PARITY.md round 4)
        "floor_p005": {"tile_pixels": 2048, "march_floor_frac": 0.005},
        "floor_p01": {"tile_pixels": 2048, "march_floor_frac": 0.01},
        # split floor: 0.02 on the bounce-0 march (bias-exonerated), 0.005
        # on secondary marches (the bias carrier)
        "floor_sec005": {"tile_pixels": 2048,
                         "march_floor_frac_secondary": 0.005},
        "floor_sec01": {"tile_pixels": 2048,
                        "march_floor_frac_secondary": 0.01},
        # loose primary floor + tight secondary floor: bounce-0 is
        # bias-exonerated and cost-heavy, secondaries carry the bias
        "floor_pri05_sec005": {"tile_pixels": 2048, "march_floor_frac": 0.05,
                               "march_floor_frac_secondary": 0.005},
        "floor_pri05_sec01": {"tile_pixels": 2048, "march_floor_frac": 0.05,
                              "march_floor_frac_secondary": 0.01},
        # counter-hash in-loop RNG (params.fast_loop_rng)
        "fastrng": {"tile_pixels": 2048, "fast_loop_rng": True},
        "fastrng_f01": {"tile_pixels": 2048, "fast_loop_rng": True,
                        "march_floor_frac": 0.01},
        # frame-wide class-binned bounce-0 scheduling (params.binned_stage1)
        # at several compact-tile widths (loops are width-flat to ~16K)
        "binned": {"tile_pixels": 2048, "binned_stage1": True},
        "binned_ct4k": {"tile_pixels": 2048, "binned_stage1": True,
                        "compact_tile": 4096},
        "binned_ct8k": {"tile_pixels": 2048, "binned_stage1": True,
                        "compact_tile": 8192},
        "binned_ct16k": {"tile_pixels": 2048, "binned_stage1": True,
                         "compact_tile": 16384},
        "binned_ct16k_wb5": {"tile_pixels": 2048, "binned_stage1": True,
                             "compact_tile": 16384, "work_bins": 5},
        "binned_ct16k_ce3": {"tile_pixels": 2048, "binned_stage1": True,
                             "compact_tile": 16384, "compact_every": 3},
        # certified floor hops (params.march_certified_floor): fidelity fix
        # for the apollo-B floor tunneling — what does it cost vs the
        # blanket secondary floor (+20.4%)?
        "cert_floor": {"tile_pixels": 2048, "march_certified_floor": True},
        "cert_floor25": {"tile_pixels": 2048, "march_certified_floor": True,
                         "march_floor_frac": 0.25},
        "cert_floor10": {"tile_pixels": 2048, "march_certified_floor": True,
                         "march_floor_frac": 0.10},
        # subsystem batching (tools/loop_cost.py measures whether the march
        # loop's per-CALL cost is flat in width): if so, one giant tile pays
        # the global worst-lane trip count ONCE instead of per tile. The
        # binned_ct2k..16k variants above never tested the batching regime —
        # they kept ~the same tile count as the block path.
        "binned_ct64k": {"tile_pixels": 2048, "binned_stage1": True,
                         "compact_tile": 65536},
        "binned_ct256k": {"tile_pixels": 2048, "binned_stage1": True,
                          "compact_tile": 262144},
        "binned_ctfull": {"tile_pixels": 2048, "binned_stage1": True,
                          "compact_tile": 1 << 22},
        "binned_ctfull_wb5": {"tile_pixels": 2048, "binned_stage1": True,
                              "compact_tile": 1 << 22, "work_bins": 5},
        # giant TAIL tiles under the block stage-1 (batching the tail only)
        "t1920_ctfull": {"tile_pixels": 2048, "compact_tile": 1 << 22},
        "t1920_ct256k": {"tile_pixels": 2048, "compact_tile": 262144},
        # certified floor with ~zero uncertified floor: the march-level leak
        # hunt (docs/PARITY.md round 5) shows the bias carrier is
        # wrong-crossing distance distortion that ANY uncertified floor
        # >~0.001 texel reintroduces; these price the faithful configs
        "cert_u0": {"tile_pixels": 2048, "march_certified_floor": True,
                    "march_uncert_floor_frac": 1e-6},
        "cert_u001": {"tile_pixels": 2048, "march_certified_floor": True,
                      "march_uncert_floor_frac": 0.001},
        "cert25_u0": {"tile_pixels": 2048, "march_certified_floor": True,
                      "march_floor_frac": 0.25,
                      "march_uncert_floor_frac": 1e-6},
        # reference phantom-hit emulation (params.march_ref_phantom, default
        # ON): what does the gather-free h=0 crawl cost end to end?
        "phantom_off": {"tile_pixels": 2048, "march_ref_phantom": False},
        "cert_floor_ph_off": {"tile_pixels": 2048,
                              "march_certified_floor": True,
                              "march_ref_phantom": False},
    }

    for name in args.variants.split(","):
        over = dict(variants[name])
        tile = over.pop("tile_pixels", args.tile)
        cfg = TraceConfig(**over)
        r = Renderer(
            image_res=(args.width, args.height), atlas=atlas,
            tile_pixels=tile, cfg=cfg,
        )
        apply_config(r, load_config(scene_file))
        r.accumulate()
        r.color_buffer.block_until_ready()
        t0 = time.time()
        for _ in range(args.spp):
            r.accumulate()
        r.color_buffer.block_until_ready()
        dt = (time.time() - t0) / args.spp
        print(f"{name:14s} {dt:8.3f} s/spp", flush=True)


if __name__ == "__main__":
    main()
