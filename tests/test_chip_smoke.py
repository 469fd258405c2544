"""chip_smoke.py's logic, on the CPU: it must refuse to run without a GPU,
and its comparison and block selection must say what they claim."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_main_without_gpu_fails_and_prints_no_result(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_alone_without_the_repo_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_frame_agreement_identical():
    a = np.random.default_rng(0).random((8, 6, 3)).astype(np.float32)
    r = chip_smoke.frame_agreement(a, a.copy())
    assert r["agrees"] and r["mean_rel"] == 0.0 and r["z"] == 0.0
    assert r["max_abs"] == 0.0 and r["decorrelated_share"] == 0.0
    assert r["close_share"] == 1.0 and r["bit_identical"]


def test_frame_agreement_few_decorrelated_pixels():
    rng = np.random.default_rng(1)
    want = rng.random((100, 100, 3))
    got = want * (1 + 1e-6)  # float32-rounding-sized differences
    got[:3, 0] = rng.random((3, 3))  # three decorrelated paths
    r = chip_smoke.frame_agreement(got, want)
    assert r["agrees"] and not r["bit_identical"]
    assert r["close_share"] == pytest.approx(1 - 3 / 10_000)
    assert r["decorrelated_share"] == pytest.approx(3 / 10_000)
    assert r["mean_rel"] < chip_smoke.MEAN_RTOL
    assert r["max_abs"] == pytest.approx(np.abs(got - want).max())


def test_frame_agreement_accepts_decorrelation_noise():
    """Independent noise on a small frame moves the mean by more than 1%,
    but by few standard errors: not a disagreement."""
    rng = np.random.default_rng(2)
    want = rng.exponential(1.0, (32, 18, 3))
    got = want.copy()
    got[:, :6] = rng.exponential(1.0, (32, 6, 3))  # a third decorrelates
    r = chip_smoke.frame_agreement(got, want)
    assert r["z"] < chip_smoke.Z_MAX and r["agrees"]


@pytest.mark.parametrize("gain", [1.02, 0.97])
def test_frame_agreement_catches_a_coherent_bias(gain):
    rng = np.random.default_rng(3)
    want = rng.exponential(1.0, (32, 18, 3))
    r = chip_smoke.frame_agreement(want * gain, want)  # a biased estimator
    assert r["mean_rel"] > chip_smoke.MEAN_RTOL and r["z"] > chip_smoke.Z_MAX
    assert not r["agrees"] and r["close_share"] == 0.0


def test_pick_tiles_finds_limb_and_disc():
    # a lit disc centred in a 64x32 frame of 8x8 blocks
    w, h, block = 64, 32, (8, 8)
    x, y = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5, indexing="ij")
    disc = ((x - 32) ** 2 + (y - 16) ** 2) < 14**2
    tiles = chip_smoke.pick_tiles(disc, block, n_limb=3, n_disc=2)
    nby = h // block[1]
    frac = [
        disc[(t // nby) * 8:(t // nby + 1) * 8,
             (t % nby) * 8:(t % nby + 1) * 8].mean()
        for t in tiles
    ]
    assert all(0.25 < f < 0.75 for f in frac[:3])
    assert all(f == 1.0 for f in frac[3:])


def test_pick_tiles_refuses_a_frame_without_a_limb():
    with pytest.raises(RuntimeError, match="limb"):
        chip_smoke.pick_tiles(np.ones((16, 16), bool), (8, 8))
