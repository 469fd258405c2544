"""Golden-image regression: fixed-seed tiny renders on the CPU backend must
reproduce the committed tensors (SURVEY.md §4) for all three shipped scenes
(the BASELINE.md eval configs). Regenerate intentionally with
tools/gen_golden.py when the estimator changes.

On a GPU the same renders are held to chip_smoke.py's tolerances (frame
means that differ by more than 1% and by more than 5 standard errors
fail): last-bit differences between the backends' math libraries
decorrelate some paths, so bit equality is not expected."""

import os
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

CASES = [("apollo", "path"), ("apollo", "preview"), ("florida", "path"),
         ("sunset", "path")]


@pytest.fixture()
def gpu_device():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/")


@pytest.mark.gpu
@pytest.mark.parametrize("scene,mode", CASES)
def test_golden_on_gpu(gpu_device, scene, mode):
    import chip_smoke

    with jax.default_device(gpu_device):
        a = chip_smoke.golden_agreement(scene, mode)
    assert a["agrees"], a


@pytest.mark.parametrize("scene,mode", CASES)
def test_golden(scene, mode):
    path = os.path.join(GOLDEN_DIR, f"{scene}_{mode}.npz")
    if not os.path.exists(path):
        pytest.skip("golden not generated")
    from gen_golden import build_renderer

    golden = np.load(path)
    r = build_renderer(scene, mode)
    for _ in range(int(golden["spp"])):
        r.accumulate()
    buf = np.asarray(r.color_buffer)
    np.testing.assert_allclose(buf, golden["color_buffer"], rtol=1e-5, atol=1e-7)
    img = np.asarray(r.fetch_image())
    np.testing.assert_allclose(img, golden["image"], rtol=1e-5, atol=1e-5)
