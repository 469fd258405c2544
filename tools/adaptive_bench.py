#!/usr/bin/env python
"""Adaptive-sampling efficiency: error vs sample budget, adaptive against
uniform, on one scene.

Protocol: render a high-spp uniform ground truth (independent seed), then
run a uniform arm and an adaptive arm from the same seed and record
relative MSE of the displayed luminance against the truth at a ladder of
equal TOTAL-sample budgets. Since pixel MSE ~ 1/n, the effective-sample
multiplier of adaptive at budget B is ~ relMSE_uniform(B)/relMSE_adaptive(B);
the summary line reports that at the final budget.

relMSE uses a small luminance epsilon and discards the top 0.1% pixel
errors (fireflies dominate otherwise — same winsorizing rationale as
tools/parity_ab.py).

Usage: python tools/adaptive_bench.py --scene apollo --rounds 64
       [--frac 0.25] [--truth-spp 512] [--res 64x36] [--cpu]
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
    ap.add_argument("--rounds", type=int, default=64,
                    help="uniform-arm spp; the adaptive arm gets the same "
                    "TOTAL sample budget")
    ap.add_argument("--frac", type=float, default=0.25)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--truth-spp", type=int, default=512)
    ap.add_argument("--res", default="64x36")
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--texture-res", type=int, default=256)
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
    cfg = TraceConfig()
    scene_file = os.path.join(ROOT, "scenes", SCENES[args.scene])

    def mk(seed):
        r = Renderer(image_res=(w, h), atlas=atlas, tile_pixels=args.tile,
                     seed=seed, cfg=cfg)
        apply_config(r, load_config(scene_file))
        return r

    # ground truth (independent seed)
    truth_r = mk(seed=1234)
    t0 = time.time()
    for _ in range(args.truth_spp):
        truth_r.accumulate()
    truth = np.asarray(truth_r.fetch_image())
    sys.stderr.write(f"truth: {args.truth_spp} spp in {time.time()-t0:.0f}s\n")

    budget_total = args.rounds * w * h
    ladder = sorted({args.rounds // 4, args.rounds // 2, args.rounds} - {0})

    def timed(fn):
        """Accumulate-call wall time only (fetch/MSE excluded)."""
        t0 = time.time()
        fn()
        return time.time() - t0

    # uniform arm
    uni = mk(seed=7)
    uni_err = {}
    uni.accumulate()  # warm the executable outside the timed region
    uni.reset_framebuffer()
    uni_time = 0.0
    for i in range(args.rounds):
        uni_time += timed(uni.accumulate)
        if uni.current_spp in ladder:
            uni_err[uni.total_samples] = rel_mse(
                np.asarray(uni.fetch_image()), truth
            )

    # adaptive arm: same total budget
    ada = mk(seed=7)
    ada_err = {}
    checkpoints = {c * w * h for c in ladder}
    hit = set()
    for _ in range(args.warmup + 1):  # warm both executables untimed
        ada.accumulate_adaptive(frac=args.frac, min_warmup=args.warmup)
    ada.reset_framebuffer()
    ada_time = 0.0
    while ada.total_samples < budget_total:
        ada_time += timed(
            lambda: ada.accumulate_adaptive(
                frac=args.frac, min_warmup=args.warmup
            )
        )
        for c in sorted(checkpoints - hit):
            if ada.total_samples >= c:
                ada_err[c] = rel_mse(np.asarray(ada.fetch_image()), truth)
                hit.add(c)
    final = budget_total
    if final not in ada_err:
        ada_err[final] = rel_mse(np.asarray(ada.fetch_image()), truth)

    mult = uni_err[final] / max(ada_err[final], 1e-30)
    print(json.dumps({
        "scene": args.scene,
        "resolution": [w, h],
        "budget_spp_equiv": args.rounds,
        "frac": args.frac,
        "warmup": args.warmup,
        "relmse_uniform": {str(k // (w * h)): round(v, 6)
                           for k, v in sorted(uni_err.items())},
        "relmse_adaptive": {str(k // (w * h)): round(v, 6)
                            for k, v in sorted(ada_err.items())},
        "effective_sample_multiplier": round(mult, 3),
        "uniform_accumulate_s": round(uni_time, 2),
        "adaptive_accumulate_s": round(ada_time, 2),
        "time_multiplier": round(
            mult * uni_time / max(ada_time, 1e-9), 3
        ),
        "adaptive_rounds_run": ada._adaptive_rounds,
    }))


if __name__ == "__main__":
    sys.exit(main())
