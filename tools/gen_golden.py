#!/usr/bin/env python
"""Regenerate the golden render tensors under tests/golden/.

Goldens are tiny fixed-seed CPU renders (SURVEY.md §4: golden-image
integration tests) of all three shipped scenes — Apollo 11 (full Earth,
short paths), florida (near-surface, texture-heavy), sunset hurricane
(grazing sun, long cloud multi-scatter) — the BASELINE.md eval configs.
Regenerate only when an *intentional* change to the estimator/scene defaults
changes the image; CI compares bit-near-exactly on the CPU backend, and
chip_smoke.py (and the ``gpu``-marked test) compares a GPU render with them
by the tolerances stated there.

Importing this module touches no JAX backend; ``main()`` renders on the CPU.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")

SCENES = {
    "apollo": "config - Apollo 11.txt",
    "florida": "config - florida.txt",
    "sunset": "config - sunset hurricane.txt",
}

# (scene, renderer mode, spp) golden set: every scene covers the path
# tracer; the preview raymarcher is scene-independent enough that one
# scene suffices.
CASES = [
    ("apollo", "path", 2),
    ("apollo", "preview", 1),
    ("florida", "path", 2),
    ("sunset", "path", 2),
]


def build_renderer(scene="apollo", mode="path"):
    from digital_earth.app.config_io import apply_config, load_config
    from digital_earth.assets.procgen import generate_earth_textures
    from digital_earth.assets.textures import build_atlas
    from digital_earth.render.params import TraceConfig
    from digital_earth.render.renderer import Renderer

    atlas = build_atlas(generate_earth_textures((64, 128), seed=3))
    cfg = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)
    r = Renderer(
        image_res=(32, 18), atlas=atlas, tile_pixels=576, seed=0, cfg=cfg, mode=mode
    )
    scene_cfg = load_config(os.path.join(ROOT, "scenes", SCENES[scene]))
    apply_config(r, scene_cfg)
    return r


def render_case(scene, mode, spp):
    """The golden render of one case on JAX's default device."""
    r = build_renderer(scene, mode)
    for _ in range(spp):
        r.accumulate()
    return r


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for scene, mode, spp in CASES:
        r = render_case(scene, mode, spp)
        buf = np.asarray(r.color_buffer)
        img = np.asarray(r.fetch_image())
        name = f"{scene}_{mode}"
        np.savez_compressed(
            os.path.join(GOLDEN_DIR, f"{name}.npz"),
            color_buffer=buf,
            image=img,
            spp=spp,
        )
        print(f"wrote {name}.npz buf-mean={buf.mean():.6e} img-mean={img.mean():.4f}")


if __name__ == "__main__":
    main()
