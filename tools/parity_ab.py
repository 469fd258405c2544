#!/usr/bin/env python
"""Image-level fidelity A/B: accelerated trackers vs the reference-faithful
naive trackers (render/tracking_naive.py), with statistical power.

The BASELINE gate is "per-channel error <1% at 1024 spp vs the Taichi
reference". Taichi is not installable here and the reference's NASA textures
are not in its repo, so the measurable proxy is accelerated vs
``naive_tracking=True`` on identical scenes/LUTs/textures: the naive trackers
reproduce the reference's estimators step for step (global sea-level
majorants, one-step Woodcock/ratio loops, plain sphere march), so any bias the
accelerated path (analytic flights, local majorants, band skips, march
skips/stall cuts) introduces shows up as a difference of converged means.

Statistical design (an earlier A/B at 160 spp had a 2.40 diff on a 2.20
noise floor — zero power):

- Both arms run ``--batches`` independent-seed renders of ``--spp`` samples
  each; the batch-to-batch scatter of per-batch means gives an *empirical*
  standard error for every statistic we report — no variance model needed.
- Headline: per-channel relative error of the frame mean,
  err_c = (mean_acc - mean_naive)/mean_naive, with its propagated SE.
  Frame means pool W*H*spp*batches samples, so the floor shrinks ~1/sqrt of
  the full sample budget — sub-0.1%% floors are cheap at 320x180.
- Spatial check (frame means can hide sign-canceling local bias): the frame
  is cut into ``--block`` x ``--block`` pixel blocks; per block the relative
  difference and its SE are computed, and we report the distribution of
  z = diff/SE over blocks. If the accelerated path were locally biased
  anywhere, |z| inflates beyond the standard normal (median |z| ~ 0.67,
  p95 ~ 1.96 under H0: no bias).

Both arms use hero_lambdas=1 (the naive trackers are single-wavelength), so
this isolates the trackers — the hero-packet estimator is validated
separately (tests/test_spectral.py MIS identities + 3-scene goldens).

Progress is checkpointed per batch to --state; rerunning resumes, so a
long run can be interrupted at any point and still report.

Usage:
  python tools/parity_ab.py --scene apollo --spp 256 --batches 8
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="apollo", choices=list(SCENES))
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--texture-res", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=256, help="spp per seed batch")
    ap.add_argument("--batches", type=int, default=8, help="seed batches/arm")
    ap.add_argument("--block", type=int, default=20, help="block size (px)")
    ap.add_argument(
        "--clip-pct", type=float, default=99.9,
        help="winsorize batch-pixel values at this pooled percentile of "
        "|value| (same threshold for BOTH arms, so the clipped-mean "
        "difference is zero-mean under H0). Sun-glint/spectral-edge "
        "fireflies otherwise dominate the frame mean's variance and "
        "destroy the test's power; the raw numbers stay reported.",
    )
    ap.add_argument("--state", default=None, help="checkpoint npz path")
    ap.add_argument("--json-out", default=None)
    ap.add_argument(
        "--paired", action="store_true",
        help="common random numbers: batch b uses the SAME frame seed in "
        "both arms, so primary geometry, wavelength draws and shared-site "
        "randomness are identical and their (dominant, firefly-heavy) "
        "variance cancels in the per-batch DIFFERENCE. Unbiased for the "
        "mean difference regardless of correlation; floors are computed "
        "from the per-batch paired differences (B-1 dof). State files get "
        "a _p tag so paired and unpaired batches never mix.",
    )
    ap.add_argument(
        "--accel", default="",
        help="TraceConfig overrides for the ACCEL arm, e.g. "
        "'naive_march=True,lazy_march=False' — bisects which accelerated "
        "subsystem carries a bias by naive-ifying them one at a time",
    )
    ap.add_argument(
        "--base", default="naive_tracking=True",
        help="TraceConfig overrides for the BASELINE arm (default: the "
        "reference-faithful naive trackers). Override for accel-vs-accel "
        "A/Bs, e.g. --base 'lazy_march=False'",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (small local runs)")
    args = ap.parse_args()

    def slug(s):
        return "_" + s.replace("=", "").replace(",", "_") if s else ""

    base = args.state or os.path.join(
        ROOT, f"parity_state_{args.scene}_{args.spp}spp"
    )
    base = base[:-4] if base.endswith(".npz") else base
    if args.paired:
        base += "_p"
    # baseline-arm state is shared across --accel bisections
    ntag = (
        slug(args.base) if args.base != "naive_tracking=True" else "_naive"
    )
    state_paths = {"accel": f"{base}{slug(args.accel)}_accel.npz",
                   "naive": f"{base}{ntag}.npz"}

    from digital_earth.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from digital_earth.app.config_io import apply_config, load_config
    from digital_earth.assets.textures import load_texture_atlas
    from digital_earth.render.params import TraceConfig
    from digital_earth.render.renderer import Renderer

    atlas = load_texture_atlas(
        procedural_resolution=(args.texture_res, 2 * args.texture_res)
    )
    config = load_config(os.path.join(ROOT, "scenes", SCENES[args.scene]))
    accel_over = (
        eval(f"dict({args.accel})") if args.accel else {}
    )  # noqa: S307 — operator-supplied bisection overrides
    base_over = eval(f"dict({args.base})") if args.base else {}  # noqa: S307
    cfgs = {
        "accel": dataclasses.replace(
            TraceConfig(), hero_lambdas=1, **accel_over
        ),
        "naive": dataclasses.replace(
            TraceConfig(), hero_lambdas=1, **base_over
        ),
    }

    # resumable per-arm per-batch frame store: {batch} -> (W, H, 3) mean
    stores = {}
    for arm, cfg in cfgs.items():
        state_path = state_paths[arm]
        store = {}
        if os.path.exists(state_path):
            with np.load(state_path) as z:
                store = {k: z[k] for k in z.files}
            print(f"resumed {len(store)} {arm} batches", flush=True)
        for b in range(args.batches):
            key = f"b{b}"
            if key in store:
                continue
            t0 = time.time()
            r = Renderer(
                image_res=(args.width, args.height), atlas=atlas,
                tile_pixels=2048,
                seed=1000 * (b + 1) + (0 if args.paired else (arm == "naive")),
                cfg=cfg,
            )
            apply_config(r, config)
            for _ in range(args.spp):
                r.accumulate()
            r.color_buffer.block_until_ready()
            store[key] = np.asarray(r.color_buffer) / args.spp
            tmp = state_path + ".tmp.npz"  # savez appends .npz otherwise
            np.savez_compressed(tmp, **store)
            os.replace(tmp, state_path)
            print(
                f"{arm}_{b}: {args.spp} spp in {time.time()-t0:.1f}s "
                f"({args.width*args.height*args.spp/(time.time()-t0):.0f} "
                "paths/s)",
                flush=True,
            )
        stores[arm] = store

    A = np.stack([stores["accel"][f"b{b}"] for b in range(args.batches)])
    N = np.stack([stores["naive"][f"b{b}"] for b in range(args.batches)])
    B = args.batches

    # headline: per-channel relative error of the frame mean + SE.
    # |mu_n| in denominators: single-wavelength XYZ->RGB samples are signed
    # (a saturated-λ firefly can push a barely-sampled channel negative), so
    # the convergence-relative scale is the magnitude.
    def frame_stats(Ax, Nx, paired=None):
        paired = args.paired if paired is None else paired
        am = Ax.mean(axis=(1, 2))  # (B, 3) per-batch frame means
        nm = Nx.mean(axis=(1, 2))
        mu_a, mu_n = am.mean(0), nm.mean(0)
        if paired and am.shape[0] == nm.shape[0]:
            # common random numbers: the shared (firefly-dominated) variance
            # cancels in the per-batch difference; SE over B paired diffs
            d = am - nm
            se = np.sqrt(d.var(0, ddof=1) / d.shape[0])
        else:
            se = np.sqrt(
                am.var(0, ddof=1) / am.shape[0]
                + nm.var(0, ddof=1) / nm.shape[0]
            )
        return (mu_a - mu_n) / np.abs(mu_n), se / np.abs(mu_n)

    rel_err_raw, rel_floor_raw = frame_stats(A, N)
    if args.clip_pct < 100.0:
        thr = np.percentile(
            np.abs(np.concatenate([A, N])), args.clip_pct, axis=(0, 1, 2)
        )  # (3,) pooled per-channel winsorization threshold
        Ac = np.clip(A, -thr, thr)
        Nc = np.clip(N, -thr, thr)
    else:
        Ac, Nc = A, N
    rel_err, rel_floor = frame_stats(Ac, Nc)
    # instrument calibration: a split-half NULL of the baseline arm (even
    # vs odd batches) measures the practical resolution — heavy-tailed
    # single-wavelength samples make the empirical SE an underestimate, so
    # a "signal" is only actionable when it clears the null's scale too
    # (the split halves are different seeds even under --paired: unpaired SE)
    null_err, null_floor = frame_stats(Nc[0::2], Nc[1::2], paired=False)
    # luminance channel: the CIE sampling pdf tracks the luminosity curve,
    # so Y-weighted values have far lighter spectral-edge tails than X/Z —
    # the highest-power single statistic
    w_lum = np.array([0.2126729, 0.7151522, 0.0721750])
    lum_err, lum_floor = frame_stats(
        (Ac * w_lum).sum(-1, keepdims=True),
        (Nc * w_lum).sum(-1, keepdims=True),
    )

    # spatial z-scores over blocks; relative diffs are luminance-relative
    # (per-channel block means can sit near zero)
    bs = args.block
    W, H = args.width, args.height
    bw, bh = W // bs, H // bs
    blk = lambda F: F[:, : bw * bs, : bh * bs].reshape(
        B, bw, bs, bh, bs, 3
    ).mean(axis=(2, 4))  # (B, bw, bh, 3)
    Ab, Nb = blk(A), blk(N)
    d = Ab.mean(0) - Nb.mean(0)
    if args.paired:
        se_b = np.sqrt((Ab - Nb).var(0, ddof=1) / B)
    else:
        se_b = np.sqrt(Ab.var(0, ddof=1) / B + Nb.var(0, ddof=1) / B)
    lum = np.abs(Nb.mean(0)).mean(-1, keepdims=True)
    lit = np.broadcast_to(lum > np.percentile(lum, 25), d.shape)
    z = d[lit] / np.maximum(se_b[lit], 1e-12)
    rel_blk = np.abs(d[lit]) / np.broadcast_to(
        np.maximum(lum, 1e-12), d.shape
    )[lit]

    result = {
        "scene": args.scene,
        "paired": bool(args.paired),
        "accel_overrides": args.accel,
        "resolution": [W, H],
        "spp_per_batch": args.spp,
        "batches": B,
        "total_spp_per_arm": args.spp * B,
        "rel_err_pct": [round(100 * float(x), 4) for x in rel_err],
        "noise_floor_pct": [round(100 * float(x), 4) for x in rel_floor],
        "clip_pct": args.clip_pct,
        "lum_rel_err_pct": round(100 * float(lum_err[0]), 4),
        "lum_noise_floor_pct": round(100 * float(lum_floor[0]), 4),
        "null_split_half_err_pct": [
            round(100 * float(x), 4) for x in null_err
        ],
        "null_split_half_floor_pct": [
            round(100 * float(x), 4) for x in null_floor
        ],
        "rel_err_raw_pct": [round(100 * float(x), 4) for x in rel_err_raw],
        "noise_floor_raw_pct": [
            round(100 * float(x), 4) for x in rel_floor_raw
        ],
        "block_abs_z_median": round(float(np.median(np.abs(z))), 3),
        "block_abs_z_p95": round(float(np.percentile(np.abs(z), 95)), 3),
        "block_abs_z_expected_h0": [0.674, 1.96],
        "block_rel_diff_median_pct": round(100 * float(np.median(rel_blk)), 4),
        "block_rel_diff_p95_pct": round(
            100 * float(np.percentile(rel_blk, 95)), 4
        ),
    }
    print(json.dumps(result, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
