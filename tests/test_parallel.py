import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth.assets.luts import load_spectral_luts
from digital_earth.assets.textures import procedural_texture_atlas
from digital_earth.parallel.mesh import MultiChipRenderer, make_render_mesh
from digital_earth.render.camera import make_camera_params
from digital_earth.render.params import TraceConfig, make_scene_params

pytestmark = pytest.mark.skipif(
    jax.device_count() < 2, reason="needs the 8-device CPU test mesh"
)


@pytest.fixture(scope="module")
def scene_setup():
    atlas = procedural_texture_atlas((128, 256), seed=3)
    luts = load_spectral_luts()
    cam = make_camera_params(
        position=(35963490.0, 12765367.0, -42445899.0),
        look_at=(23201393.0, 8394073.0, -26074562.0),
        fov=0.127,
    )
    scene = make_scene_params()
    cfg = TraceConfig(max_bounces=4, land_march_steps=64, max_tracking_steps=512)
    return atlas, luts, cam, scene, cfg


class TestMesh:
    def test_mesh_shape(self):
        mesh = make_render_mesh()
        assert mesh.shape["px"] * mesh.shape["spp"] == jax.device_count()

    def test_multichip_step_runs_and_accumulates(self, scene_setup):
        atlas, luts, cam, scene, cfg = scene_setup
        mesh = make_render_mesh()
        r = MultiChipRenderer(mesh, (32, 16), atlas, luts, cfg=cfg)
        r.accumulate(cam, scene)
        assert r.current_spp == mesh.shape["spp"]
        buf = r.fetch_buffer()
        assert buf.shape == (32, 16, 3)
        assert np.isfinite(buf).all()
        assert (buf != 0).any()
        before = buf.copy()
        r.accumulate(cam, scene)
        after = r.fetch_buffer()
        # second spp batch adds energy somewhere
        assert (after != before).any()

    @pytest.mark.slow

    def test_spp_axis_devices_differ(self, scene_setup):
        """The per-device fold must decorrelate spp batches: a 1-device-mesh
        render differs from another spp index's render."""
        atlas, luts, cam, scene, cfg = scene_setup
        devs = jax.devices()
        m1 = make_render_mesh(devices=devs[:2], spp_axis=2)
        r = MultiChipRenderer(m1, (16, 8), atlas, luts, cfg=cfg)
        r.accumulate(cam, scene)
        two_spp = r.fetch_buffer()
        m2 = make_render_mesh(devices=devs[:1], spp_axis=1)
        r2 = MultiChipRenderer(m2, (16, 8), atlas, luts, cfg=cfg)
        r2.accumulate(cam, scene)
        one_spp = r2.fetch_buffer()
        assert (np.abs(two_spp - one_spp) > 1e-12).any()

    @pytest.mark.slow

    def test_px_sharding_matches_replicated(self, scene_setup):
        """Sharding over 'px' must not change the result: randomness is keyed
        by the *global* tile index, so the (px=8, spp=1) render is
        bit-identical to the 1-device render with the same seed."""
        atlas, luts, cam, scene, cfg = scene_setup
        devs = jax.devices()
        m8 = make_render_mesh(devices=devs, spp_axis=1)
        m1 = make_render_mesh(devices=devs[:1], spp_axis=1)
        r8 = MultiChipRenderer(m8, (32, 8), atlas, luts, cfg=cfg, tile_pixels=32)
        r1 = MultiChipRenderer(m1, (32, 8), atlas, luts, cfg=cfg, tile_pixels=32)
        r8.accumulate(cam, scene)
        r1.accumulate(cam, scene)
        a, b = r8.fetch_buffer(), r1.fetch_buffer()
        assert np.isfinite(a).all() and (a != 0).any()
        np.testing.assert_array_equal(a, b)

    @pytest.mark.slow

    def test_multichip_matches_single_chip_renderer(self, scene_setup):
        """The multi-chip gate: the multi-chip renderer runs THE
        single-chip staged pipeline (renderer._trace_tile_range) per device
        with per-lane pixel-keyed RNG, so an (px=8, spp=1) frame must be
        bit-identical to the single-chip Renderer's frame for the same
        seed/scene — not merely mesh-shape-invariant against itself."""
        from digital_earth.render.renderer import Renderer

        atlas, luts, cam, scene, cfg = scene_setup
        m8 = make_render_mesh(devices=jax.devices(), spp_axis=1)
        rm = MultiChipRenderer(
            m8, (32, 8), atlas, luts, cfg=cfg, tile_pixels=32, seed=5
        )
        rs = Renderer(
            image_res=(32, 8), atlas=atlas, luts=luts, cfg=cfg,
            tile_pixels=32, seed=5,
        )
        assert tuple(rm.block) == tuple(rs.block)
        # drive the single-chip renderer to the fixture's camera/scene
        rs.set_camera_pos(35963490.0, 12765367.0, -42445899.0)
        rs.set_look_at(23201393.0, 8394073.0, -26074562.0)
        rs.set_fov(0.127)
        for _ in range(2):
            rm.accumulate(cam, scene)
            rs.accumulate()
        a = rm.fetch_buffer()
        b = np.asarray(rs.color_buffer)
        assert np.isfinite(a).all() and (a != 0).any()
        np.testing.assert_array_equal(a, b)

    @pytest.mark.slow

    def test_multichip_full_renderer_api(self, scene_setup):
        """MultiChipRenderer IS a Renderer: set_* + accumulate() without
        explicit params + fetch_image + checkpoint roundtrip, so the viewer
        and offline paths run multi-chip unchanged."""
        atlas, luts, cam, scene, cfg = scene_setup
        m8 = make_render_mesh(devices=jax.devices(), spp_axis=1)
        r = MultiChipRenderer(
            m8, (32, 8), atlas, luts, cfg=cfg, tile_pixels=32, seed=5
        )
        r.set_camera_pos(35963490.0, 12765367.0, -42445899.0)
        r.set_look_at(23201393.0, 8394073.0, -26074562.0)
        r.set_fov(0.127)
        r.accumulate()
        assert r.current_spp == 1
        img = np.asarray(r.fetch_image())
        assert img.shape == (32, 8, 3)
        assert np.isfinite(img).all() and (img > 0).any()
        # matches the single-chip Renderer's post-processed image too
        from digital_earth.render.renderer import Renderer

        rs = Renderer(
            image_res=(32, 8), atlas=atlas, luts=luts, cfg=cfg,
            tile_pixels=32, seed=5,
        )
        rs.set_camera_pos(35963490.0, 12765367.0, -42445899.0)
        rs.set_look_at(23201393.0, 8394073.0, -26074562.0)
        rs.set_fov(0.127)
        rs.accumulate()
        np.testing.assert_array_equal(img, np.asarray(rs.fetch_image()))

    @pytest.mark.slow

    def test_multichip_checkpoint_roundtrip(self, scene_setup, tmp_path):
        atlas, luts, cam, scene, cfg = scene_setup
        m = make_render_mesh(devices=jax.devices()[:2], spp_axis=1)
        r = MultiChipRenderer(m, (16, 8), atlas, luts, cfg=cfg, seed=3)
        r.accumulate(cam, scene)
        before = r.fetch_buffer()
        p = str(tmp_path / "ckpt.npz")
        r.save_checkpoint(p)
        r2 = MultiChipRenderer(m, (16, 8), atlas, luts, cfg=cfg, seed=3)
        r2.load_checkpoint(p)
        assert r2.current_spp == r.current_spp
        np.testing.assert_allclose(r2.fetch_buffer(), before, atol=1e-7)
        # resumed accumulation continues the same stream
        r.accumulate(cam, scene)
        r2.accumulate(cam, scene)
        np.testing.assert_allclose(
            r2.fetch_buffer(), r.fetch_buffer(), atol=1e-6
        )

    @pytest.mark.slow

    def test_spp_axis_matches_sequential_steps(self, scene_setup):
        """A (px=4, spp=2) step is keyed by global spp indices, so one step
        equals two sequential (px=8, spp=1) steps up to summation order."""
        atlas, luts, cam, scene, cfg = scene_setup
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 devices")
        m42 = make_render_mesh(devices=devs, spp_axis=2)
        m81 = make_render_mesh(devices=devs, spp_axis=1)
        r42 = MultiChipRenderer(m42, (32, 8), atlas, luts, cfg=cfg, tile_pixels=32)
        r81 = MultiChipRenderer(m81, (32, 8), atlas, luts, cfg=cfg, tile_pixels=32)
        r42.accumulate(cam, scene)  # adds spp 0 and 1 in one step
        r81.accumulate(cam, scene)  # spp 0
        r81.accumulate(cam, scene)  # spp 1
        assert r42.current_spp == r81.current_spp == 2
        a, b = r42.fetch_buffer(), r81.fetch_buffer()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)

    @pytest.mark.slow

    def test_multichip_interruptible_matches_accumulate(self, scene_setup):
        """Chunked multi-chip accumulation is bit-identical to the unchunked
        step, and the interrupt callback aborts without corrupting state."""
        atlas, luts, cam, scene, cfg = scene_setup
        m = make_render_mesh(devices=jax.devices()[:4], spp_axis=1)
        ra = MultiChipRenderer(m, (32, 8), atlas, luts, cfg=cfg,
                               tile_pixels=32, seed=5)
        rb = MultiChipRenderer(m, (32, 8), atlas, luts, cfg=cfg,
                               tile_pixels=32, seed=5)
        ra.set_camera_pos(35963490.0, 12765367.0, -42445899.0)
        ra.set_look_at(23201393.0, 8394073.0, -26074562.0)
        rb.set_camera_pos(35963490.0, 12765367.0, -42445899.0)
        rb.set_look_at(23201393.0, 8394073.0, -26074562.0)
        ra.accumulate()
        polls = []
        done = rb.accumulate_interruptible(
            n_chunks=2, interrupt=lambda: polls.append(1) and False
        )
        assert done and polls
        np.testing.assert_array_equal(ra.fetch_buffer(), rb.fetch_buffer())
        assert ra.current_spp == rb.current_spp == ra.spp_per_step
        # an aborting interrupt discards the partial spp
        aborted = rb.accumulate_interruptible(n_chunks=2, interrupt=lambda: True)
        assert not aborted
        np.testing.assert_array_equal(ra.fetch_buffer(), rb.fetch_buffer())

    @pytest.mark.slow

    def test_multichip_adaptive(self, scene_setup):
        """Sharded adaptive passes: warmup covers every pixel uniformly;
        adaptive rounds add samples only to the selected tiles; estimates
        stay per-pixel means (fetch_image divides by the counts)."""
        atlas, luts, cam, scene, cfg = scene_setup
        m = make_render_mesh(devices=jax.devices()[:4], spp_axis=1)
        r = MultiChipRenderer(m, (32, 8), atlas, luts, cfg=cfg,
                              tile_pixels=32, seed=5)
        r.set_camera_pos(35963490.0, 12765367.0, -42445899.0)
        r.set_look_at(23201393.0, 8394073.0, -26074562.0)
        r.accumulate_adaptive(frac=0.5, min_warmup=2)
        r.accumulate_adaptive(frac=0.5, min_warmup=2)
        counts = np.asarray(r._assemble(r.count_buffer))
        np.testing.assert_array_equal(counts, 2.0)  # uniform warmup
        assert r.current_spp == 2
        r.accumulate_adaptive(frac=0.5, min_warmup=2)
        counts = np.asarray(r._assemble(r.count_buffer))
        assert counts.min() == 2.0 and counts.max() == 3.0
        # every device refined exactly half its tiles
        assert (counts == 3.0).mean() == pytest.approx(0.5)
        img = np.asarray(r.fetch_image())
        assert np.isfinite(img).all() and (img > 0).any()
        # uniform accumulate() with live bookkeeping routes adaptively
        r.accumulate()
        counts = np.asarray(r._assemble(r.count_buffer))
        assert counts.min() == 3.0 and counts.max() == 4.0

    @pytest.mark.slow

    def test_multichip_adaptive_checkpoint(self, scene_setup, tmp_path):
        atlas, luts, cam, scene, cfg = scene_setup
        m = make_render_mesh(devices=jax.devices()[:2], spp_axis=1)
        r = MultiChipRenderer(m, (16, 8), atlas, luts, cfg=cfg, seed=3)
        r.set_camera_pos(35963490.0, 12765367.0, -42445899.0)
        r.set_look_at(23201393.0, 8394073.0, -26074562.0)
        for _ in range(3):
            r.accumulate_adaptive(frac=0.5)
        p = str(tmp_path / "ckpt.npz")
        r.save_checkpoint(p)
        r2 = MultiChipRenderer(m, (16, 8), atlas, luts, cfg=cfg, seed=3)
        r2.set_camera_pos(35963490.0, 12765367.0, -42445899.0)
        r2.set_look_at(23201393.0, 8394073.0, -26074562.0)
        r2.load_checkpoint(p)  # render state only; scene state is config.txt
        np.testing.assert_allclose(
            np.asarray(r2._assemble(r2.count_buffer)),
            np.asarray(r._assemble(r.count_buffer)),
        )
        r.accumulate_adaptive(frac=0.5)
        r2.accumulate_adaptive(frac=0.5)
        np.testing.assert_allclose(
            r2.fetch_buffer(), r.fetch_buffer(), atol=1e-6
        )
