#!/usr/bin/env python
"""Randomized-QMC multiplier: error vs budget with the R3 stratified
primary dimensions (TraceConfig.stratify_spp) on vs off.

Same protocol as tools/adaptive_bench.py: a high-spp ground truth
(independent seed), then two equal-budget arms; the effective-sample
multiplier at budget B is relMSE_iid(B) / relMSE_rqmc(B) (pixel MSE ~ 1/n
for the iid arm; rQMC integrates the smooth primary dimensions faster).

Usage: python tools/rqmc_bench.py --scene apollo --rounds 64
       [--truth-spp 1024] [--res 160x90] [--cpu]
"""

import argparse
import dataclasses
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


def rel_mse(img, truth):
    import numpy as np

    lt = truth.sum(-1)
    li = img.sum(-1)
    err = (li - lt) ** 2 / (lt + 1e-2) ** 2
    cut = np.percentile(err, 99.9)
    return float(err[err <= cut].mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="apollo", choices=sorted(SCENES))
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--truth-spp", type=int, default=1024)
    ap.add_argument("--res", default="160x90")
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--texture-res", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from digital_earth.app.config_io import apply_config, load_config
    from digital_earth.assets.textures import load_texture_atlas
    from digital_earth.render.params import TraceConfig
    from digital_earth.render.renderer import Renderer
    from digital_earth.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    w, h = (int(x) for x in args.res.split("x"))
    atlas = load_texture_atlas(
        procedural_resolution=(args.texture_res, 2 * args.texture_res)
    )
    scene_file = os.path.join(ROOT, "scenes", SCENES[args.scene])

    def mk(seed, stratify):
        cfg = dataclasses.replace(TraceConfig(), stratify_spp=stratify)
        r = Renderer(image_res=(w, h), atlas=atlas, tile_pixels=args.tile,
                     seed=seed, cfg=cfg)
        apply_config(r, load_config(scene_file))
        return r

    truth_r = mk(seed=1234, stratify=True)
    t0 = time.time()
    for _ in range(args.truth_spp):
        truth_r.accumulate()
    truth = np.asarray(truth_r.fetch_image())
    sys.stderr.write(f"truth: {args.truth_spp} spp in {time.time()-t0:.0f}s\n")

    ladder = sorted({args.rounds // 4, args.rounds // 2, args.rounds} - {0})
    out = {}
    for name, stratify in (("iid", False), ("rqmc", True)):
        errs = {}
        # average over a few independent randomizations/seeds so the
        # multiplier is not one draw's luck
        for rep in range(3):
            r = mk(seed=7 + 100 * rep, stratify=stratify)
            for _ in range(args.rounds):
                r.accumulate()
                if r.current_spp in ladder:
                    errs.setdefault(r.current_spp, []).append(
                        rel_mse(np.asarray(r.fetch_image()), truth)
                    )
        out[name] = {k: float(np.mean(v)) for k, v in sorted(errs.items())}

    mult = {
        str(spp): round(out["iid"][spp] / max(out["rqmc"][spp], 1e-30), 3)
        for spp in out["iid"]
    }
    print(json.dumps({
        "scene": args.scene,
        "resolution": [w, h],
        "relmse_iid": {str(k): round(v, 6) for k, v in out["iid"].items()},
        "relmse_rqmc": {str(k): round(v, 6) for k, v in out["rqmc"].items()},
        "effective_sample_multiplier_by_spp": mult,
    }))


if __name__ == "__main__":
    sys.exit(main())
