import os

import numpy as np
import pytest

from digital_earth import constants as C
from digital_earth.app.camera_controller import CameraController
from digital_earth.app.config_io import (
    SceneConfig,
    load_config,
    save_config,
)

APOLLO = """35963490.23139822 12765367.037276791 -42445899.29884433
23201393.603171505 8394073.279136525 -26074562.13501193
0.26080361881808384 0.6750209397555819 -0.6901653449014103
0.12692034034212948
0.996999979019165
2.431999921798706
12
1.0010000467300415
5.0813688841507325
-1.7096024133386984"""


class TestConfigIO:
    def test_reads_reference_format(self, tmp_path):
        p = tmp_path / "config.txt"
        p.write_text(APOLLO)
        cfg = load_config(str(p))
        assert cfg.camera_pos[0] == pytest.approx(35963490.23139822)
        assert cfg.up[2] == pytest.approx(-0.6901653449014103)
        assert cfg.fov == pytest.approx(0.12692034034212948)
        assert cfg.crf_index == 12
        assert cfg.sun_path_rot == pytest.approx(-1.7096024133386984)

    def test_round_trip(self, tmp_path):
        p = tmp_path / "config.txt"
        cfg = SceneConfig(
            camera_pos=(1.5, -2.5, 3e7),
            look_at=(0.0, 1.0, 2.0),
            up=(0.0, 1.0, 0.0),
            fov=0.2,
            aspect_scale=1.1,
            exposure=3.3,
            crf_index=4,
            gamma=1.8,
            sun_angle=2.0,
            sun_path_rot=-0.5,
        )
        save_config(str(p), cfg)
        loaded = load_config(str(p))
        assert loaded == cfg
        # 10-line format
        assert len(p.read_text().split("\n")) == 10


class TestCameraController:
    def test_wasd_moves_along_target(self):
        cam = CameraController(position=(0.0, 0.0, C.PLANET_R * 3), look_at=(0, 0, 0))
        p0 = cam.position.copy()
        moved = cam.update_keys({"w"}, elapsed_time=0.1)
        assert moved
        assert cam.position[2] < p0[2]  # moved toward the planet

    def test_speed_scales_with_altitude(self):
        far = CameraController(position=(0.0, 0.0, C.PLANET_R * 3), look_at=(0, 0, 0))
        near = CameraController(
            position=(0.0, 0.0, C.PLANET_R + 10000.0), look_at=(0, 0, 0)
        )
        far.update_keys({"w"}, 0.1)
        near.update_keys({"w"}, 0.1)
        d_far = C.PLANET_R * 3 - far.position[2]
        d_near = C.PLANET_R + 10000.0 - near.position[2]
        assert d_far > d_near * 10

    def test_cannot_enter_planet(self):
        cam = CameraController(
            position=(0.0, 0.0, C.PLANET_R + 1000.0), look_at=(0, 0, 0)
        )
        for _ in range(200):
            cam.update_keys({"w", "shift"}, 1.0)
        assert np.sqrt(np.sum(cam.position**2)) >= C.PLANET_R

    def test_q_aligns_up_to_vertical(self):
        cam = CameraController(position=(0.0, 0.0, C.PLANET_R * 2), look_at=(0, 0, 0))
        cam.update_keys({"q"}, 0.1)
        np.testing.assert_allclose(cam.up, [0.0, 0.0, 1.0], atol=1e-12)
        cam.update_keys({"e"}, 0.1)
        np.testing.assert_allclose(cam.up, [0.0, 1.0, 0.0], atol=1e-12)

    def test_rotate_preserves_position_and_distance(self):
        cam = CameraController(position=(0.0, 0.0, 3e7), look_at=(0, 0, 0))
        p0 = cam.position.copy()
        d0 = np.linalg.norm(cam.look_at - cam.position)
        assert cam.rotate(0.05, 0.02)
        np.testing.assert_array_equal(cam.position, p0)
        assert np.linalg.norm(cam.look_at - cam.position) == pytest.approx(d0)

    def test_shift_triples_speed(self):
        a = CameraController(position=(0.0, 0.0, C.PLANET_R * 3), look_at=(0, 0, 0))
        b = CameraController(position=(0.0, 0.0, C.PLANET_R * 3), look_at=(0, 0, 0))
        a.update_keys({"w"}, 0.1)
        b.update_keys({"w", "shift"}, 0.1)
        da = C.PLANET_R * 3 - a.position[2]
        db = C.PLANET_R * 3 - b.position[2]
        assert db == pytest.approx(3 * da, rel=1e-9)
