import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth.assets.luts import load_crf_pack
from digital_earth.render import film


@pytest.fixture(scope="module")
def crf():
    return load_crf_pack()


class TestOpenDRT:
    def test_black_maps_to_black(self):
        out = film.opendrt_transform(jnp.zeros((4, 3)))
        np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-6)

    def test_output_in_display_range(self):
        x = jnp.exp(jnp.linspace(-8, 8, 64))[:, None] * jnp.ones(3)
        out = np.asarray(film.opendrt_transform(x))
        assert out.min() >= -1e-5
        assert out.max() <= 1.0 + 1e-5

    def test_achromatic_monotone(self):
        x = jnp.linspace(0.0, 50.0, 200)[:, None] * jnp.ones(3)
        y = np.asarray(film.opendrt_transform(x))[:, 1]
        assert np.all(np.diff(y) >= -1e-6)

    def test_middle_grey_lands_near_rec709_grey(self):
        # the tonescale constraint maps scene 0.18 to ~0.11696 display linear
        out = film.opendrt_transform(jnp.full((1, 3), 0.18))
        assert float(out[0, 1]) == pytest.approx(0.11696, rel=0.05)

    def test_highlights_compress_toward_peak(self):
        out_hi = film.opendrt_transform(jnp.full((1, 3), 1000.0))
        assert float(out_hi[0, 1]) == pytest.approx(1.0, abs=0.05)

    def test_preserves_batch_shape(self):
        x = jnp.ones((5, 7, 3)) * 0.5
        assert film.opendrt_transform(x).shape == (5, 7, 3)


class TestAgX:
    def test_range_and_monotone(self):
        x = jnp.exp(jnp.linspace(-12, 8, 128))[:, None] * jnp.ones(3)
        y = np.asarray(film.agx_transform(x))
        assert y.min() >= 0.0 and y.max() <= 1.0
        assert np.all(np.diff(y[:, 1]) >= -1e-6)

    def test_extremes(self):
        lo = film.agx_transform(jnp.full((1, 3), 1e-8))
        hi = film.agx_transform(jnp.full((1, 3), 1e4))
        assert float(lo[0, 1]) < 0.02
        assert float(hi[0, 1]) > 0.95


class TestCameraResponse:
    def test_neutral_is_identity(self, crf):
        t = jnp.linspace(0.0, 1.0, 64)[:, None] * jnp.ones(3)
        out = np.asarray(film.camera_response(crf.curves, jnp.int32(0), t))
        np.testing.assert_allclose(out, np.asarray(t), atol=2e-3)

    def test_film_stocks_differ_from_neutral(self, crf):
        t = jnp.full((8, 3), 0.4)
        neutral = np.asarray(film.camera_response(crf.curves, jnp.int32(0), t))
        stock = np.asarray(film.camera_response(crf.curves, jnp.int32(4), t))
        assert np.abs(neutral - stock).max() > 0.01

    def test_clamps_out_of_range(self, crf):
        t = jnp.array([[-0.5, 1.5, 0.5]])
        out = np.asarray(film.camera_response(crf.curves, jnp.int32(0), t))
        assert out.min() >= 0.0 and out.max() <= 1.0


class TestPostprocess:
    @pytest.mark.slow
    def test_full_chain_shapes_and_range(self, crf):
        buf = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (32, 16, 3))) * 0.01
        img = film.postprocess(
            buf, jnp.float32(4.0), jnp.float32(2.5), jnp.float32(1.0),
            crf.curves, jnp.int32(0), (32, 16), "opendrt",
        )
        assert img.shape == (32, 16, 3)
        img = np.asarray(img)
        assert img.min() >= 0.0 and img.max() <= 1.0

    def test_vignette_darkens_corners(self, crf):
        buf = jnp.full((64, 32, 3), 0.02)
        img = np.asarray(
            film.postprocess(
                buf, jnp.float32(1.0), jnp.float32(2.5), jnp.float32(1.0),
                crf.curves, jnp.int32(0), (64, 32), "opendrt",
            )
        )
        center = img[32, 16].mean()
        corner = img[0, 0].mean()
        assert corner < center

    @pytest.mark.slow

    def test_agx_selectable(self, crf):
        buf = jnp.full((8, 8, 3), 0.02)
        a = film.postprocess(
            buf, jnp.float32(1.0), jnp.float32(2.5), jnp.float32(1.0),
            crf.curves, jnp.int32(0), (8, 8), "opendrt",
        )
        b = film.postprocess(
            buf, jnp.float32(1.0), jnp.float32(2.5), jnp.float32(1.0),
            crf.curves, jnp.int32(0), (8, 8), "agx",
        )
        assert (np.asarray(a) != np.asarray(b)).any()


class TestGamutsAndEotfs:
    """The working-space matrices and HDR EOTFs the reference carries as
    dead branches (reference lib/OpenDRT.py:56-78,134-189), derived here
    from published chromaticities + CAT02 rather than embedded constants."""

    def test_gamut_matrices_match_published_values(self):
        # Rec2020 (BT.2020 spec) and ACES AP0 (TB-2014-004) spot checks
        rec2020 = film.gamut_to_xyz("rec2020")
        np.testing.assert_allclose(
            rec2020,
            [
                [0.636958122253, 0.144616916776, 0.168880969286],
                [0.262700229883, 0.677998125553, 0.059301715344],
                [0.000000000000, 0.028072696179, 1.060985088348],
            ],
            atol=5e-5,
        )
        ap0 = film.gamut_to_xyz("ap0")
        np.testing.assert_allclose(
            ap0,
            [
                [0.93863094875, -0.00574192055, 0.017566898852],
                [0.338093594922, 0.727213902811, -0.065307497733],
                [0.000723121511, 0.000818441849, 1.0875161874],
            ],
            atol=5e-4,  # CAT02 D60->D65 adaptation rounding
        )

    def test_all_gamuts_map_white_to_white(self):
        white = jnp.ones((1, 3))
        for name in film._GAMUT_CHROMATICITIES:
            xyz = white @ jnp.asarray(film.gamut_to_xyz(name)).T
            rgb = xyz @ jnp.asarray(film.xyz_to_display("rec709")).T
            np.testing.assert_allclose(np.asarray(rgb), 1.0, atol=2e-3)

    def test_xyz_to_display_inverts_gamut(self):
        for name in ("rec709", "p3d65", "rec2020"):
            m = film.gamut_to_xyz(name) @ film.xyz_to_display(name)
            np.testing.assert_allclose(m, np.eye(3), atol=1e-5)

    def test_pq_roundtrip(self):
        v = jnp.asarray([[0.05, 0.3, 0.9]])
        rt = film.eotf_pq(film.eotf_pq(v, inverse=True), inverse=False)
        np.testing.assert_allclose(np.asarray(rt), np.asarray(v), atol=1e-4)

    def test_hlg_roundtrip(self):
        v = jnp.asarray([[0.05, 0.3, 0.9]])
        rt = film.eotf_hlg(film.eotf_hlg(v, inverse=True), inverse=False)
        np.testing.assert_allclose(np.asarray(rt), np.asarray(v), atol=1e-5)

    def test_opendrt_configs_run_and_stay_bounded(self):
        x = jnp.asarray(np.random.RandomState(0).rand(16, 3) * 8.0)
        for eotf, lp in (("lin", 100.0), ("srgb", 100.0), ("pq", 1000.0), ("hlg", 1000.0)):
            y = np.asarray(film.opendrt_transform(x, eotf=eotf, lp=lp))
            assert np.isfinite(y).all()
            assert y.max() <= 1.0 + 1e-5
        for g in ("ap0", "arriwg3", "davinciwg"):
            y = np.asarray(film.opendrt_transform(x, in_gamut=g, display_gamut="rec2020"))
            assert np.isfinite(y).all()

    def test_default_config_unchanged(self):
        """The generalization must not move the compiled Rec709/lin path."""
        x = jnp.asarray([[0.01, 0.18, 2.5]])
        explicit = film.opendrt_transform(
            x, in_gamut="rec709", display_gamut="rec709", eotf="lin", lp=100.0
        )
        default = film.opendrt_transform(x)
        np.testing.assert_array_equal(np.asarray(explicit), np.asarray(default))
