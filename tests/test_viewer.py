"""Hermetic tests of the web viewer's HTTP layer: a stub renderer stands in
for the accelerator, and requests go through a real in-process HTTP server."""

import json
import sys
import time
import urllib.request

import numpy as np
import pytest

from digital_earth.app.config_io import SceneConfig
from digital_earth.app.viewer import EarthViewer, render_offline, upscale_bilinear
from digital_earth.utils.png import decode_png


class StubRenderer:
    """Implements the Renderer surface the viewer touches, CPU-only."""

    def __init__(self, image_res=(16, 9)):
        self.image_res = image_res
        self.current_spp = 0
        self.color_buffer = np.zeros((*image_res, 3), dtype=np.float32)
        self.crf_names = ["Neutral", "Kodachrome"]
        self.camera_pos = np.zeros(3)
        self.look_at = np.zeros(3)
        self.up = np.array([0.0, 1.0, 0.0])
        self.fov = 0.2
        self.aspect_scale = 1.0
        self.exposure = 2.5
        self.gamma = 1.0
        self.selected_crf = 0
        self.sun_angle = 1.0
        self.sun_path_rot = -0.7
        self.land_height_scale = 7800.0
        self.resets = 0

    def set_camera_pos(self, x, y, z):
        self.camera_pos = np.array([x, y, z])

    def set_look_at(self, x, y, z):
        self.look_at = np.array([x, y, z])

    def set_up(self, x, y, z):
        self.up = np.array([x, y, z])

    def set_fov(self, v):
        self.fov = float(v)

    def set_aspect_scale(self, v):
        self.aspect_scale = float(v)

    def set_exposure(self, v):
        self.exposure = float(v)

    def set_gamma(self, v):
        self.gamma = float(v)

    def set_crf(self, v):
        self.selected_crf = int(v)

    def set_sun_angle(self, v):
        self.sun_angle = float(v)

    def set_sun_path_rot(self, v):
        self.sun_path_rot = float(v)

    def reset_framebuffer(self):
        self.current_spp = 0
        self.resets += 1

    def accumulate(self):
        self.current_spp += 1
        time.sleep(0.001)

    def fetch_image_np(self):
        return np.zeros((self.image_res[1], self.image_res[0], 3), dtype=np.uint8)


@pytest.fixture()
def viewer(tmp_path):
    v = EarthViewer(
        renderer=StubRenderer(),
        config_path=str(tmp_path / "config.txt"),
        screenshot_dir=str(tmp_path / "shots"),
        port=0,
    )
    v._test_port = v.serve_background(port=0)  # the real handler
    yield v
    assert v.stop(timeout=5)


def _get(v, path):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{v._test_port}{path}", timeout=5
    )


class TestViewerHTTP:
    def test_state_reports_accumulation(self, viewer):
        time.sleep(0.2)
        state = json.loads(_get(viewer, "/state").read())
        assert state["spp"] > 0
        assert state["crf_name"] == "Neutral"

    def test_slider_set_resets_framebuffer(self, viewer):
        time.sleep(0.05)
        r0 = viewer.renderer.resets
        _get(viewer, "/set?sun_angle=120")
        assert viewer.renderer.resets > r0
        assert viewer.renderer.sun_angle == pytest.approx(np.radians(120.0))

    def test_exposure_does_not_reset(self, viewer):
        time.sleep(0.05)
        r0 = viewer.renderer.resets
        _get(viewer, "/set?exposure=4.5")
        assert viewer.renderer.exposure == 4.5
        assert viewer.renderer.resets == r0

    def test_movement_keys_reset_and_move(self, viewer):
        p0 = viewer.camera.position.copy()
        _get(viewer, "/input?keys=w")
        time.sleep(0.3)
        _get(viewer, "/input?keys=")
        assert not np.array_equal(viewer.camera.position, p0)

    def test_save_load_roundtrip(self, viewer):
        _get(viewer, "/set?sun_angle=77")
        _get(viewer, "/save")
        _get(viewer, "/set?sun_angle=10")
        _get(viewer, "/load")
        assert viewer.renderer.sun_angle == pytest.approx(np.radians(77.0), rel=1e-5)

    def test_bad_value_returns_400(self, viewer):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer, "/set?exposure=banana")
        assert e.value.code == 400

    def test_unknown_path_404(self, viewer):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer, "/nonexistent")
        assert e.value.code == 404


class TestProgressiveEscalation:
    """Interactive-by-default: moving/scene changes render the preview
    raymarcher at reduced res; idle frames escalate to the path tracer
    (viewer._render_loop + _frame_png)."""

    @pytest.fixture()
    def esc_viewer(self, tmp_path):
        v = EarthViewer(
            renderer=StubRenderer(image_res=(32, 18)),
            config_path=str(tmp_path / "config.txt"),
            screenshot_dir=str(tmp_path / "shots"),
            port=0,
        )
        v.preview_renderer = StubRenderer(image_res=(8, 5))
        v._test_port = v.serve_background(port=0)
        yield v
        assert v.stop(timeout=5)

    def test_idle_frames_are_path_traced(self, esc_viewer):
        time.sleep(0.3)
        assert esc_viewer._frame_source == "path"
        assert esc_viewer.renderer.current_spp > 0

    def test_scene_change_yields_preview_then_escalates(self, esc_viewer):
        time.sleep(0.2)
        p0 = esc_viewer.preview_renderer.resets
        _get(esc_viewer, "/set?sun_angle=12")
        # a preview frame lands quickly for the changed scene
        deadline = time.time() + 2.0
        while time.time() < deadline and esc_viewer.preview_renderer.resets == p0:
            time.sleep(0.01)
        assert esc_viewer.preview_renderer.resets > p0
        # preview scene scalars mirrored from the main renderer
        assert esc_viewer.preview_renderer.sun_angle == pytest.approx(
            esc_viewer.renderer.sun_angle
        )
        # and with no further input, frames escalate back to the path tracer
        time.sleep(0.4)
        assert esc_viewer._frame_source == "path"

    def test_key_impulse_ends_motion(self, esc_viewer):
        """One /input?keys=w is an impulse (the web client re-sends held
        keys every 200 ms): motion must stop and frames escalate back to the
        path tracer without a keyup message. Regression: un-cleared
        _pending_keys kept every frame dirty, previewing forever."""
        time.sleep(0.3)
        _get(esc_viewer, "/input?keys=w")
        deadline = time.time() + 3.0
        while time.time() < deadline and esc_viewer._frame_source != "preview":
            time.sleep(0.01)
        # and with no further impulses, path frames resume
        deadline = time.time() + 3.0
        while time.time() < deadline and esc_viewer._frame_source != "path":
            time.sleep(0.02)
        assert esc_viewer._frame_source == "path"
        assert not esc_viewer._pending_keys

    def test_preview_frame_png_upscales_to_full_res(self, esc_viewer):
        esc_viewer._frame_source = "preview"
        png = esc_viewer._frame_png()
        assert decode_png(png).shape == (18, 32, 3)


class AdaptiveStubRenderer(StubRenderer):
    """Stub with the adaptive accumulate surface."""

    def __init__(self, image_res=(16, 9)):
        super().__init__(image_res)
        self.total_samples = 0
        self.count_buffer = None
        self.adaptive_calls = 0

    def accumulate_adaptive(self, frac=0.25, min_warmup=2):
        import numpy as _np

        if self.count_buffer is None:
            self.count_buffer = _np.zeros(self.image_res, dtype=_np.float32)
        self.adaptive_calls += 1
        n_px = self.image_res[0] * self.image_res[1]
        self.total_samples += int(n_px * min(frac, 1.0))
        self.current_spp += 1
        time.sleep(0.001)

    @property
    def mean_spp(self):
        return self.total_samples / (self.image_res[0] * self.image_res[1])


class TestAdaptiveViewer:
    @pytest.fixture()
    def ada_viewer(self, tmp_path):
        v = EarthViewer(
            renderer=AdaptiveStubRenderer(),
            config_path=str(tmp_path / "config.txt"),
            screenshot_dir=str(tmp_path / "shots"),
            port=0,
            adaptive_frac=0.25,
        )
        v._test_port = v.serve_background(port=0)
        yield v
        assert v.stop(timeout=5)

    def test_idle_loop_uses_adaptive_passes(self, ada_viewer):
        time.sleep(0.3)
        assert ada_viewer.renderer.adaptive_calls > 0
        # striping is disabled under adaptive (counts aren't tracked there)
        assert ada_viewer.spp_chunks == 1

    def test_state_reports_mean_spp(self, ada_viewer):
        time.sleep(0.3)
        with _get(ada_viewer, "/state") as r:
            s = json.loads(r.read())
        assert s["spp"] == pytest.approx(
            ada_viewer.renderer.mean_spp, abs=0.5
        )
        assert s["paths_per_sec"] > 0


class TestNoImagingLibrary:
    """The main path writes PNGs with the standard library alone: offline
    renders and /frame.png must work where PIL is not installed."""

    @pytest.fixture()
    def no_pil(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "PIL", None)
        monkeypatch.setitem(sys.modules, "PIL.Image", None)
        with pytest.raises(ImportError):
            import PIL  # noqa: F401

    def test_render_offline_writes_png(self, no_pil, tmp_path):
        out = tmp_path / "frame.png"
        cfg = SceneConfig(
            camera_pos=(0.0, 0.0, 3e7), look_at=(0.0, 0.0, 0.0),
            up=(0.0, 1.0, 0.0), fov=0.2, aspect_scale=1.0, exposure=2.5,
            crf_index=0, gamma=1.0, sun_angle=1.0, sun_path_rot=-0.7,
        )
        r = render_offline(cfg, spp=2, renderer=StubRenderer((16, 9)),
                           out_path=str(out))
        assert r.current_spp == 2
        assert decode_png(out.read_bytes()).shape == (9, 16, 3)

    def test_frame_png_endpoint(self, no_pil, viewer):
        with _get(viewer, "/frame.png") as resp:
            assert resp.headers["Content-Type"] == "image/png"
            img = decode_png(resp.read())
        assert img.shape == (9, 16, 3)

    def test_screenshot(self, no_pil, viewer):
        with _get(viewer, "/screenshot") as resp:
            path = resp.read().decode()
        with open(path, "rb") as f:
            assert decode_png(f.read()).shape == (9, 16, 3)


class TestUpscale:
    def test_integer_factor_keeps_flat_regions(self):
        img = np.zeros((4, 6, 3), np.uint8)
        img[:, 3:] = 200
        out = upscale_bilinear(img, 24, 16)
        assert out.shape == (16, 24, 3)
        assert (out[:, :10] == 0).all() and (out[:, 14:] == 200).all()
        # the edge between the two halves is interpolated, monotonically
        row = out[0, :, 0].astype(int)
        assert (np.diff(row) >= 0).all() and 0 < row[12] < 200

    def test_same_size_is_identity(self):
        img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
        np.testing.assert_array_equal(upscale_bilinear(img, 7, 5), img)
