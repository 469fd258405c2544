"""Every float32 einsum/matmul of the render and film paths asks for
HIGHEST precision, so a GPU cannot run it in TF32."""

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core

from digital_earth.assets.luts import load_crf_pack, load_spectral_luts
from digital_earth.assets.procgen import generate_earth_textures
from digital_earth.assets.textures import build_atlas
from digital_earth.render import film
from digital_earth.render.camera import make_camera_params
from digital_earth.render.params import TraceConfig, make_scene_params
from digital_earth.render.renderer import _pick_block_dims, _trace_tile_range

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """precision params of every dot_general, through every sub-jaxpr."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _assert_all_highest(closed):
    precs = _dot_precisions(closed.jaxpr)
    assert precs, "no dot_general traced"
    assert all(p == (HIGHEST, HIGHEST) for p in precs), precs
    return len(precs)


@pytest.mark.parametrize("cfg", [
    TraceConfig(max_bounces=2, land_march_steps=16, max_tracking_steps=64),
    TraceConfig(max_bounces=2, land_march_steps=16, max_tracking_steps=64,
                analytic_transmittance=False, analytic_flight=True),
], ids=["default", "tracked-nee"])
def test_path_tracer_dots_are_highest(cfg):
    atlas = build_atlas(generate_earth_textures((32, 64), seed=3))
    luts = load_spectral_luts()
    cam = make_camera_params(
        position=(35963490.0, 12765367.0, -42445899.0),
        look_at=(23201393.0, 8394073.0, -26074562.0), fov=0.127,
    )
    res = (16, 8)
    block = _pick_block_dims(*res, 64)
    n_tiles = (res[0] // block[0]) * (res[1] // block[1])

    def fn(key, cam, scene, atlas, luts):
        return _trace_tile_range(key, 0, cam, scene, atlas, luts, res, block,
                                 cfg, 0, n_tiles)

    closed = jax.make_jaxpr(fn)(jax.random.PRNGKey(0), cam,
                                make_scene_params(), atlas, luts)
    # the radiance->XYZ einsum, XYZ->RGB and the tracker einsums
    assert _assert_all_highest(closed) >= 3


@pytest.mark.parametrize("drt", ["opendrt", "agx"])
def test_film_chain_dots_are_highest(drt):
    crf = load_crf_pack()
    buf = jnp.ones((4, 2, 3), jnp.float32)
    closed = jax.make_jaxpr(
        lambda b: film.postprocess(b, 1.0, 2.0, 1.0, crf.curves, 0, (4, 2),
                                   drt)
    )(buf)
    _assert_all_highest(closed)
