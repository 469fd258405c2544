#!/usr/bin/env python
"""Measure the viewer's worst-case input-to-preview latency.

With a full-frame path spp in flight, camera input would wait a whole spp
before the first preview frame; the viewer stripes each spp into
interruptible pixel chunks (Renderer.accumulate_interruptible). This harness
measures the real number: start the viewer, wait for path-traced frames to
be in flight, inject camera input at a random phase, and time until /state
reports a preview-sourced frame newer than the input.

Usage: python tools/viewer_latency.py [--width 1920 --height 1080]
       [--texture-res 1024] [--trials 5] [--port 8790] [--cpu]
"""

import argparse
import json
import os
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--texture-res", type=int, default=1024)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--port", type=int, default=8790)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from digital_earth.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from digital_earth.app.viewer import EarthViewer
    from digital_earth.assets.textures import load_texture_atlas

    viewer = EarthViewer(
        image_res=(args.width, args.height), port=args.port,
        atlas=load_texture_atlas(
            procedural_resolution=(args.texture_res, 2 * args.texture_res)
        ),
        config_path="/tmp/viewer_latency_config.txt",
        screenshot_dir="/tmp/viewer_latency_shots",
    )
    port = viewer.serve_background(port=args.port)
    base = f"http://localhost:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.read()

    def state():
        return json.loads(get("/state"))

    # warm up: wait until the path tracer is producing frames
    t0 = time.time()
    while True:
        s = state()
        if s["frame_source"] == "path" and s["spp"] >= 2:
            break
        if time.time() - t0 > 1800:
            raise SystemExit("path tracing never warmed up")
        time.sleep(1.0)
    print(f"warm: spp={s['spp']} {s['paths_per_sec']:.0f} paths/s", flush=True)

    lat = []
    for i in range(args.trials):
        # random phase inside the spp: wait a bit between trials
        time.sleep(3.0 + 1.7 * i)
        frame0 = state()["frame_id"]
        t_in = time.time()
        get("/input?keys=w")
        while True:
            s = state()
            if s["frame_source"] == "preview" and s["frame_id"] > frame0:
                break
            time.sleep(0.05)
        dt = time.time() - t_in
        lat.append(dt)
        print(f"trial {i}: input->preview {dt:.2f} s", flush=True)
        # let it settle back to path frames
        t0 = time.time()
        while state()["frame_source"] != "path" and time.time() - t0 < 600:
            time.sleep(0.5)

    print(json.dumps({
        "metric": "input_to_preview_s",
        "trials": [round(x, 2) for x in lat],
        "worst": round(max(lat), 2),
        "median": round(sorted(lat)[len(lat) // 2], 2),
        "resolution": [args.width, args.height],
        "spp_chunks": viewer.spp_chunks,
    }))
    viewer.stop()


if __name__ == "__main__":
    main()
