#!/usr/bin/env python
"""Smoke test of the main path on the GPU, at the size users run.

    python chip_smoke.py          # phases a-d, on one GPU
    python chip_smoke.py --four   # phases a and e, on four GPUs

a. Device: JAX's devices must be GPUs (no CPU fallback). Prints the device
   kind and count, and nvidia-smi's card name and power limit.
b. Offline render, the default experience: ``Renderer`` at 1920x1080 with
   the tier-2 21600x10800 procedural atlas and the shipped ``TraceConfig()``,
   posed by "scenes/config - Apollo 11.txt" through ``render_offline``;
   1 warm-up spp, 2 timed spp, then the film chain.
c. Viewer: ``EarthViewer`` headless on a localhost port, reusing phase b's
   renderer. Times /state during a path-traced spp, and camera input to the
   first preview frame; fetches /frame.png and waits for the path tracer to
   resume.
d. GPU against CPU: the same 1080p Apollo pixel blocks (on the planet's limb
   and disc) through ``renderer._trace_tile_range`` on both backends of this
   process, and the four golden scenes on the GPU against tests/golden.
e. ``--four`` only: ``MultiChipRenderer`` over a px 2 x spp 2 mesh of four
   GPUs (``python main.py --multichip``'s renderer) against the one-GPU
   ``Renderer`` at the same seed; scaling, largest difference, bit identity.

Each phase prints its lines with the wall time since the start. A failing
check raises, and the script exits non-zero; only a run in which every phase
passed prints the last line, ``{"ok": true, "device": {...}}``.

Tolerances (phases d and e). XLA's GPU and CPU backends round transcendental
functions differently in the last bits, and Russian roulette, the trackers'
free-flight draws and the march's crossing tests flip on such a bit, so some
paths decorrelate while the rest agree to float32 rounding (on the H100
about a quarter of the compared pixels moved by more than 1e-4 relative).
Both sides estimate the same image without bias, so the per-pixel
difference d = got - want has mean zero. Per channel, the frames disagree
only when the difference of their means is both
- large: more than MEAN_RTOL = 1% of the mean, and
- significant: more than Z_MAX = 5 standard errors of the mean of d (its
  sample standard deviation over sqrt(pixels)).
A wrong estimator (a TF32 optical depth, a bad gather) shifts every pixel
the same way and fails both; the decorrelation noise of a 576-pixel golden
frame (a few per cent of its mean) fails only the first. Reported, not
gated: the share of pixels whose three channels agree to CLOSE_RTOL = 1e-4
relative, the share off by more than 1% (decorrelated paths), the largest
absolute difference, and bit identity.
The viewer's /state must answer within STATE_LATENCY_MAX_S = 1 s while a
1080p spp runs: the render loop waits for the device with
``block_until_ready``, and a longer answer would mean that wait starves the
HTTP threads.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
APOLLO = os.path.join(ROOT, "scenes", "config - Apollo 11.txt")
RES = (1920, 1080)
TIER2 = (10800, 21600)  # the reference's 21600x10800 texture tier
LOWRES = (1024, 2048)   # the CPU arm of phase d stays cheap with it

MEAN_RTOL = 0.01
Z_MAX = 5.0
CLOSE_RTOL = 1e-4
STATE_LATENCY_MAX_S = 1.0

T0 = time.time()


def log(phase: str, msg: str) -> None:
    print(f"[{phase} {time.time() - T0:7.1f} s] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def frame_agreement(got, want) -> dict:
    """Compare two (..., 3) linear RGB frames by the tolerances above."""
    got = np.asarray(got, np.float64).reshape(-1, 3)
    want = np.asarray(want, np.float64).reshape(-1, 3)
    d = got - want
    mean_d = np.abs(d.mean(axis=0))
    mean_rel = mean_d / np.maximum(np.abs(want.mean(axis=0)), 1e-30)
    se = d.std(axis=0, ddof=1) / np.sqrt(len(d))
    z = np.where(mean_d > 0, mean_d / np.maximum(se, 1e-300), 0.0)
    scale = np.maximum(np.abs(got), np.abs(want))
    return {
        "agrees": bool(np.all((mean_rel <= MEAN_RTOL) | (z <= Z_MAX))),
        "mean_rel": float(mean_rel.max()),
        "z": float(z.max()),
        "close_share": float((np.abs(d) <= CLOSE_RTOL * scale)
                             .all(axis=1).mean()),
        "decorrelated_share": float((np.abs(d) > 0.01 * scale)
                                    .any(axis=1).mean()),
        "max_abs": float(np.abs(d).max()),
        "max_value": float(np.abs(want).max()),
        "bit_identical": bool(np.array_equal(got, want)),
    }


def fmt(a: dict) -> str:
    return (
        f"agrees={a['agrees']}: mean_rel={a['mean_rel']:.3e} "
        f"(limit {MEAN_RTOL:g}) z={a['z']:.2f} (limit {Z_MAX:g}); "
        f"within 1e-4: {a['close_share']:.4f}, off >1%: "
        f"{a['decorrelated_share']:.4f}; max_abs={a['max_abs']:.3e} "
        f"(max value {a['max_value']:.3e}); "
        f"bit_identical={a['bit_identical']}"
    )


def load_tier2_atlas(phase: str):
    import jax

    from digital_earth.assets.textures import load_texture_atlas

    t = time.time()
    atlas = load_texture_atlas(procedural_resolution=TIER2)
    jax.block_until_ready(atlas)
    n_bytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(atlas))
    log(phase, f"tier-2 atlas {TIER2[1]}x{TIER2[0]}: {n_bytes} bytes, "
             f"built in {time.time() - t:.2f} s")
    return atlas


# --- a. device -------------------------------------------------------------
def phase_device(need: int):
    from digital_earth.utils.device import (
        card_name_and_power_limit, require_gpu,
    )

    devices = require_gpu()
    check(len(devices) >= need,
          f"need {need} GPUs, JAX found {len(devices)}")
    card = card_name_and_power_limit()
    log("a", f"JAX devices: {len(devices)} x {devices[0].device_kind} "
             f"({devices[0].platform})")
    print(card, flush=True)  # nvidia-smi name, power limit (one per card)
    return devices


# --- b. offline render -----------------------------------------------------
def phase_offline(device):
    from digital_earth.app.config_io import load_config
    from digital_earth.app.viewer import render_offline
    from digital_earth.render.params import TraceConfig
    from digital_earth.render.renderer import Renderer

    atlas = load_tier2_atlas("b")
    r = Renderer(image_res=RES, atlas=atlas, cfg=TraceConfig())
    scene = load_config(APOLLO)
    t = time.time()
    render_offline(scene, spp=1, image_res=RES, renderer=r, out_path=None)
    r.color_buffer.block_until_ready()
    warm_s = time.time() - t
    t = time.time()
    render_offline(scene, spp=2, image_res=RES, renderer=r, out_path=None)
    r.color_buffer.block_until_ready()
    s_per_spp = (time.time() - t) / 2
    buf = np.asarray(r.color_buffer)
    img = r.fetch_image_np()
    peak = device.memory_stats()["peak_bytes_in_use"]
    log("b", f"{RES[0]}x{RES[1]} Apollo, TraceConfig(): warm-up "
             f"(trace+compile+1 spp) {warm_s:.2f} s, {s_per_spp:.3f} s/spp, "
             f"{RES[0] * RES[1] / s_per_spp:.0f} paths/s, "
             f"peak device memory {peak} bytes")
    check(np.isfinite(buf).all(), "non-finite radiance in the frame")
    check(img.shape == (RES[1], RES[0], 3), f"image shape {img.shape}")
    lit = float((img.max(axis=-1) > 8).mean())
    mean = img.reshape(-1, 3).mean(axis=0)
    log("b", f"frame: lit share {lit:.3f}, mean sRGB {np.round(mean, 2)}")
    # the Apollo pose shows the whole disc against black space
    check(0.05 < lit < 0.95, f"implausible lit share {lit}")
    check(5.0 < mean.min() and mean.max() < 150.0,
          f"implausible frame mean {mean}")
    return r


# --- c. viewer --------------------------------------------------------------
def phase_viewer(r):
    from digital_earth.app.viewer import EarthViewer
    from digital_earth.utils.png import decode_png

    with tempfile.TemporaryDirectory() as tmp:
        config_path = os.path.join(tmp, "config.txt")
        shutil.copy(APOLLO, config_path)  # the viewer starts at this pose
        v = EarthViewer(renderer=r, config_path=config_path,
                        screenshot_dir=os.path.join(tmp, "shots"))
        port = v.serve_background(port=0)

        def get(path):
            url = f"http://127.0.0.1:{port}{path}"
            with urllib.request.urlopen(url, timeout=60) as resp:
                return resp.read()

        def state():
            return json.loads(get("/state"))

        def wait(pred, timeout, what):
            deadline = time.time() + timeout
            while time.time() < deadline:
                s = state()
                if pred(s):
                    return s
                time.sleep(0.02)
            raise RuntimeError(f"viewer: no {what} within {timeout} s")

        try:
            t = time.time()
            s = wait(lambda s: s["frame_source"] == "path" and s["spp"] >= 1,
                     900, "first path-traced spp")
            log("c", f"viewer up: first preview + first path spp after "
                     f"{time.time() - t:.2f} s (compiles both)")
            # /state latency while the next spp runs
            lat, spp0 = [], s["spp"]
            deadline = time.time() + 300
            while s["spp"] <= spp0 and time.time() < deadline:
                t = time.time()
                s = state()
                lat.append(time.time() - t)
                time.sleep(0.05)
            check(s["spp"] > spp0, "viewer: no further spp within 300 s")
            lat = np.array(lat)
            log("c", f"/state during a {RES[0]}x{RES[1]} spp: "
                     f"{lat.size} requests, median "
                     f"{np.median(lat) * 1e3:.2f} ms, max "
                     f"{lat.max() * 1e3:.2f} ms "
                     f"(gate {STATE_LATENCY_MAX_S * 1e3:.0f} ms)")
            check(lat.max() < STATE_LATENCY_MAX_S,
                  "viewer: /state starved during a spp")
            frame0 = state()["frame_id"]
            t = time.time()
            get("/input?keys=w")
            wait(lambda s: s["frame_source"] == "preview"
                 and s["frame_id"] > frame0, 120, "preview after input")
            log("c", f"input to first preview: {time.time() - t:.3f} s")
            img = decode_png(get("/frame.png"))
            check(img.shape == (RES[1], RES[0], 3),
                  f"/frame.png shape {img.shape}")
            check(img.max() > 0, "/frame.png is black")
            t = time.time()
            wait(lambda s: s["frame_source"] == "path" and s["spp"] >= 1,
                 300, "path-traced spp after the move")
            log("c", f"/frame.png {img.shape[1]}x{img.shape[0]}; path "
                     f"tracer resumed {time.time() - t:.2f} s later")
        finally:
            stopped = v.stop(timeout=300)
        check(stopped, "viewer: render loop did not stop")


# --- d. GPU against CPU -----------------------------------------------------
def planet_mask(r):
    """(W, H) bool: the pixel-centre camera ray of renderer ``r`` hits the
    planet's surface sphere."""
    import jax.numpy as jnp

    from digital_earth import constants as C
    from digital_earth.render.camera import cast_dirs

    w, h = r.image_res
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="ij")
    d = np.asarray(cast_dirs(r._camera_params(), jnp.asarray(u),
                             jnp.asarray(v), 0.5, 0.5, r.image_res),
                   np.float64)
    o = np.asarray(r.camera_pos, np.float64)
    b = d @ o
    return (b < 0) & (b * b - (o @ o - C.PLANET_R**2) > 0)


def pick_tiles(hits, block, n_limb=4, n_disc=2):
    """Pixel-block ids on the planet's limb (part planet, part sky) and on
    its disc (all planet), from a (W, H) planet-hit mask."""
    w, h = hits.shape
    bw, bh = block
    frac = hits.reshape(w // bw, bw, h // bh, bh).mean(axis=(1, 3)).ravel()
    limb = np.flatnonzero((frac > 0.25) & (frac < 0.75))
    disc = np.flatnonzero(frac == 1.0)
    check(limb.size >= n_limb and disc.size >= n_disc,
          f"found {limb.size} limb and {disc.size} disc blocks")

    def spread(ids, k):
        return ids[np.linspace(0, ids.size - 1, k).round().astype(int)]

    return np.concatenate([spread(limb, n_limb), spread(disc, n_disc)])


def _gen_golden():
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import gen_golden

    return gen_golden


def golden_agreement(scene, mode):
    """Render one golden case on JAX's default device; compare with the
    committed CPU tensors."""
    gg = _gen_golden()
    with np.load(os.path.join(gg.GOLDEN_DIR, f"{scene}_{mode}.npz")) as g:
        r = gg.render_case(scene, mode, int(g["spp"]))
        return frame_agreement(np.asarray(r.color_buffer), g["color_buffer"])


def phase_parity(gpu):
    import jax
    import jax.numpy as jnp

    from digital_earth.app.config_io import apply_config, load_config
    from digital_earth.assets.textures import load_texture_atlas
    from digital_earth.render.renderer import Renderer, _trace_tile_range

    cpu = jax.devices("cpu")[0]
    r = Renderer(image_res=RES,
                 atlas=load_texture_atlas(procedural_resolution=LOWRES))
    apply_config(r, load_config(APOLLO))
    tiles = pick_tiles(planet_mask(r), r.block)
    block, cfg, n = r.block, r.cfg, len(tiles)

    def trace(base_key, spp, cam, scene, atlas, luts, tile_ids):
        return _trace_tile_range(base_key, spp, cam, scene, atlas, luts,
                                 RES, block, cfg, 0, n, tile_ids=tile_ids)

    step = jax.jit(trace)
    args = (r._base_key, r._camera_params(), r._scene_params(), r.atlas,
            r.luts, jnp.asarray(tiles, jnp.int32))
    out = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        key, cam, scene, atlas, luts, ids = jax.device_put(args, dev)
        t = time.time()
        out[name] = sum(
            np.asarray(step(key, jax.device_put(jnp.int32(s), dev), cam,
                            scene, atlas, luts, ids))
            for s in range(2)
        )
        log("d", f"{name}: {n} blocks of {block[0]}x{block[1]} x 2 spp "
                 f"(compile + run) {time.time() - t:.2f} s")
    a = frame_agreement(out["gpu"], out["cpu"])
    log("d", f"{RES[0]}x{RES[1]} Apollo blocks {tiles.tolist()} (limb, "
             f"disc), GPU vs CPU: {fmt(a)}")
    check(np.isfinite(out["gpu"]).all(), "non-finite GPU radiance")
    check(a["agrees"], "GPU and CPU frame means disagree")
    for scene_name, mode, _ in _gen_golden().CASES:
        t = time.time()
        a = golden_agreement(scene_name, mode)
        log("d", f"golden {scene_name}/{mode} on the GPU vs CPU tensors "
                 f"({time.time() - t:.2f} s): {fmt(a)}")
        check(a["agrees"], f"golden {scene_name}/{mode} disagrees")


# --- e. four GPUs -----------------------------------------------------------
def phase_four(devices):
    import jax

    from digital_earth.app.config_io import apply_config, load_config
    from digital_earth.parallel.mesh import MultiChipRenderer, make_render_mesh
    from digital_earth.render.renderer import Renderer

    atlas = load_tier2_atlas("e")
    scene = load_config(APOLLO)
    mesh = make_render_mesh(devices[:4])
    mr = MultiChipRenderer(mesh, RES, atlas, None)
    apply_config(mr, scene)
    t = time.time()
    mr.accumulate()
    mr.color_buffer.block_until_ready()
    log("e", f"mesh {dict(mesh.shape)}: warm-up (trace+compile+"
             f"{mr.spp_per_step} spp) {time.time() - t:.2f} s")
    multi = mr.fetch_buffer()
    sr = Renderer(image_res=RES, atlas=atlas)
    apply_config(sr, scene)
    t = time.time()
    sr.accumulate()
    sr.color_buffer.block_until_ready()
    log("e", f"one GPU: warm-up (trace+compile+1 spp) "
             f"{time.time() - t:.2f} s")
    t = time.time()
    for _ in range(mr.spp_per_step - 1):
        sr.accumulate()
    sr.color_buffer.block_until_ready()
    single_s = (time.time() - t) / (mr.spp_per_step - 1)
    a = frame_agreement(multi, np.asarray(sr.color_buffer))
    log("e", f"four GPUs vs one GPU at {mr.spp_per_step} spp: {fmt(a)}")
    check(np.isfinite(multi).all(), "non-finite multi-GPU radiance")
    check(a["agrees"], "multi-GPU and one-GPU frames disagree")
    steps = 2
    t = time.time()
    for _ in range(steps):
        mr.accumulate()
    jax.block_until_ready(mr.color_buffer)
    multi_s = (time.time() - t) / (steps * mr.spp_per_step)
    log("e", f"{RES[0]}x{RES[1]} Apollo: one GPU {single_s:.3f} s/spp, "
             f"four GPUs {multi_s:.3f} s/spp "
             f"({RES[0] * RES[1] / multi_s:.0f} paths/s), "
             f"scaling {single_s / multi_s:.2f}x of 4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase (e)")
    args = ap.parse_args(argv)

    from digital_earth.utils.cache import enable_compilation_cache
    from digital_earth.utils.device import device_record

    enable_compilation_cache()
    devices = phase_device(need=4 if args.four else 1)
    if args.four:
        phase_four(devices)
    else:
        phase_viewer(phase_offline(devices[0]))
        phase_parity(devices[0])
    print(json.dumps({"ok": True, "device": device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
