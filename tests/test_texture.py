import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth.assets.procgen import generate_earth_textures
from digital_earth.assets.textures import build_atlas, procedural_texture_atlas
from digital_earth.ops import texture as tx


def _tex(arr):
    return tx.Tex2D.from_array(np.asarray(arr))


class TestTex2DLayout:
    def test_roundtrip_single_channel(self):
        img = np.arange(32, dtype=np.float32).reshape(4, 8)
        tex = _tex(img)
        ys, xs = np.meshgrid(np.arange(4), np.arange(8), indexing="ij")
        vals = tx._fetch_texel(tex, jnp.asarray(ys.ravel()), jnp.asarray(xs.ravel()))
        np.testing.assert_allclose(np.asarray(vals)[:, 0], img.ravel())

    def test_roundtrip_multichannel_uint8(self):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (6, 10, 3), dtype=np.uint8)
        tex = _tex(img)
        ys, xs = np.meshgrid(np.arange(6), np.arange(10), indexing="ij")
        vals = tx._fetch_texel(tex, jnp.asarray(ys.ravel()), jnp.asarray(xs.ravel()))
        np.testing.assert_allclose(
            np.asarray(vals), img.reshape(-1, 3) / 255.0, atol=1e-6
        )

    def test_eight_channel_pack(self):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 255, (8, 16, 8), dtype=np.uint8)
        tex = _tex(img)
        assert tex.texels_per_row == 16
        vals = tx._fetch_texel(tex, jnp.asarray([3]), jnp.asarray([7]))
        np.testing.assert_allclose(np.asarray(vals)[0], img[3, 7] / 255.0, atol=1e-6)


class TestEquirectSampling:
    def test_constant_texture(self):
        tex = _tex(np.full((8, 16), 128, dtype=np.uint8))
        v = tx.sample_equirect(tex, jnp.array([0.1, 0.5, 0.93]), jnp.array([0.2, 0.5, 0.99]))
        np.testing.assert_allclose(np.asarray(v), 128 / 255, atol=1e-6)

    def test_texel_center_exact(self):
        tex = _tex(np.arange(32, dtype=np.float32).reshape(4, 8))
        u = jnp.array((3 + 0.5) / 8)
        v = jnp.array(1.0 - (1 + 0.5) / 4)
        for bilinear in (True, False):
            val = tx.sample_equirect(tex, u, v, bilinear=bilinear)
            assert float(val) == pytest.approx(float(np.arange(32).reshape(4, 8)[1, 3]))

    def test_u_wraps(self):
        tex = _tex(np.arange(16, dtype=np.float32).reshape(2, 8))
        a = tx.sample_equirect(tex, jnp.array(0.0), jnp.array(0.25))
        b = tx.sample_equirect(tex, jnp.array(1.0), jnp.array(0.25))
        assert float(a) == pytest.approx(float(b), abs=1e-5)

    def test_sample_sphere_texture_poles(self):
        img = np.zeros((8, 16), dtype=np.float32)
        img[0, :] = 1.0  # north row
        tex = _tex(img)
        north = tx.sample_sphere_texture(tex, jnp.array([[0.0, 1.0, 0.0]]))
        south = tx.sample_sphere_texture(tex, jnp.array([[0.0, -1.0, 0.0]]))
        assert float(north[0]) == pytest.approx(1.0)
        assert float(south[0]) == pytest.approx(0.0)

    def test_nearest_matches_bilinear_at_centers(self):
        rng = np.random.default_rng(2)
        img = rng.random((16, 32)).astype(np.float32)
        tex = _tex(img)
        u = (jnp.arange(32) + 0.5) / 32
        v = 1.0 - (jnp.arange(16)[:, None] + 0.5) / 16
        uu = jnp.broadcast_to(u, (16, 32))
        vv = jnp.broadcast_to(v, (16, 32))
        a = tx.sample_equirect(tex, uu, vv, bilinear=True)
        b = tx.sample_equirect(tex, uu, vv, bilinear=False)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
        np.testing.assert_allclose(np.asarray(a), img, atol=1e-5)


class TestProcgen:
    def test_generation_channels_and_determinism(self):
        t1 = generate_earth_textures((64, 128), seed=3)
        t2 = generate_earth_textures((64, 128), seed=3)
        for k in ("albedo", "topography", "ocean", "clouds", "bathymetry", "emissive", "stars"):
            assert k in t1
            np.testing.assert_array_equal(t1[k], t2[k])
        assert t1["albedo"].shape == (64, 128, 3)
        assert t1["albedo"].dtype == np.uint8

    def test_land_fraction_reasonable(self):
        t = generate_earth_textures((128, 256), seed=7)
        ocean_frac = (t["ocean"] > 127).mean()
        assert 0.5 < ocean_frac < 0.8

    def test_atlas_builds_and_packs(self):
        t = generate_earth_textures((32, 64), seed=1)
        atlas = build_atlas(t)
        assert atlas.material.channels == 8
        assert atlas.material.h == 32 and atlas.material.w == 64
        # topography and clouds carry [map, fine mip, coarse mip, 0] packs
        assert atlas.topography.channels == 4
        assert atlas.clouds.channels == 4
        assert atlas.stars.channels == 3
        # both mip channels are conservative upper bounds of the fine channel
        for tex, src in ((atlas.topography, t["topography"]), (atlas.clouds, t["clouds"])):
            ys, xs = np.meshgrid(np.arange(32), np.arange(64), indexing="ij")
            vals = tx._fetch_texel(
                tex, jnp.asarray(ys.ravel()), jnp.asarray(xs.ravel())
            )
            vals = np.asarray(vals)
            assert (vals[:, 1] >= vals[:, 0] - 1e-6).all()
            assert (vals[:, 2] >= vals[:, 0] - 1e-6).all()
            np.testing.assert_allclose(vals[:, 0], src.ravel() / 255.0, atol=1e-6)
        # packed channels must match the source maps at a texel
        mat = tx._fetch_texel(atlas.material, jnp.asarray([5]), jnp.asarray([9]))
        np.testing.assert_allclose(
            np.asarray(mat)[0, 0:3], t["albedo"][5, 9] / 255.0, atol=1e-6
        )
        assert float(mat[0, 3]) == pytest.approx(t["ocean"][5, 9] / 255.0, abs=1e-6)
        assert float(mat[0, 6]) == pytest.approx(t["topography"][5, 9] / 255.0, abs=1e-6)


class TestRealFileLoading:
    """The reference's default experience is real NASA equirect image files
    (reference lib/textures.py:10-46, README.md:28-29); these tests exercise
    the actual file path — _load_image and load_texture_atlas reading PNGs
    from a textures/ directory — which the procedural fallback otherwise
    hides."""

    def _write_tier0(self, tmp_path, h=16, w=32, skip=()):
        from PIL import Image

        from digital_earth.assets.textures import _TIER_FILES

        rng = np.random.default_rng(11)
        written = {}
        for name, fn in _TIER_FILES[0].items():
            if name in skip:
                continue
            if name in ("albedo", "stars"):
                arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            else:
                arr = rng.integers(0, 255, (h, w), dtype=np.uint8)
            Image.fromarray(arr).save(tmp_path / fn)
            # ground truth = the decoded file (stars_8K.jpg is JPEG: lossy,
            # so the random source pixels do not round-trip exactly)
            decoded = np.asarray(Image.open(tmp_path / fn))
            written[name] = decoded
        return written

    def test_load_image_channel_handling(self, tmp_path):
        from PIL import Image

        from digital_earth.assets.textures import _load_image

        rgb = np.random.default_rng(0).integers(0, 255, (8, 12, 3), dtype=np.uint8)
        gray = np.random.default_rng(1).integers(0, 255, (8, 12), dtype=np.uint8)
        rgba = np.dstack([rgb, np.full((8, 12), 255, np.uint8)])
        Image.fromarray(rgb).save(tmp_path / "rgb.png")
        Image.fromarray(gray).save(tmp_path / "gray.png")
        Image.fromarray(rgba).save(tmp_path / "rgba.png")
        # single-channel request: RGB file collapses to its first channel
        np.testing.assert_array_equal(
            _load_image(str(tmp_path / "rgb.png"), True), rgb[..., 0]
        )
        # multi-channel request: gray file broadcasts to 3 channels,
        # RGBA drops alpha
        np.testing.assert_array_equal(
            _load_image(str(tmp_path / "gray.png"), False),
            np.stack([gray] * 3, axis=-1),
        )
        np.testing.assert_array_equal(
            _load_image(str(tmp_path / "rgba.png"), False), rgb
        )

    def test_atlas_from_real_files(self, tmp_path):
        from digital_earth.assets.textures import load_texture_atlas

        written = self._write_tier0(tmp_path)
        atlas = load_texture_atlas(texture_dir=str(tmp_path), quality=0)
        # atlas texel contents must equal the files' pixels
        ys, xs = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
        ys, xs = jnp.asarray(ys.ravel()), jnp.asarray(xs.ravel())
        mat = np.asarray(tx._fetch_texel(atlas.material, ys, xs))
        np.testing.assert_allclose(
            mat[:, 0:3], written["albedo"].reshape(-1, 3) / 255.0, atol=1e-6
        )
        np.testing.assert_allclose(
            mat[:, 3], written["ocean"].ravel() / 255.0, atol=1e-6
        )
        np.testing.assert_allclose(
            mat[:, 4], written["bathymetry"].ravel() / 255.0, atol=1e-6
        )
        np.testing.assert_allclose(
            mat[:, 5], written["emissive"].ravel() / 255.0, atol=1e-6
        )
        topo = np.asarray(tx._fetch_texel(atlas.topography, ys, xs))
        np.testing.assert_allclose(
            topo[:, 0], written["topography"].ravel() / 255.0, atol=1e-6
        )
        clouds = np.asarray(tx._fetch_texel(atlas.clouds, ys, xs))
        np.testing.assert_allclose(
            clouds[:, 0], written["clouds"].ravel() / 255.0, atol=1e-6
        )
        stars = np.asarray(tx._fetch_texel(atlas.stars, ys, xs))
        np.testing.assert_allclose(
            stars[:, 0:3], written["stars"].reshape(-1, 3) / 255.0, atol=1e-6
        )

    def test_partial_download_fallback(self, tmp_path):
        """A missing file (partial NASA download) falls back procedurally
        for that texture only; present files still load from disk."""
        from digital_earth.assets.textures import load_texture_atlas

        written = self._write_tier0(tmp_path, skip=("clouds", "stars"))
        atlas = load_texture_atlas(
            texture_dir=str(tmp_path), quality=0,
            procedural_resolution=(16, 32),
        )
        ys, xs = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
        ys, xs = jnp.asarray(ys.ravel()), jnp.asarray(xs.ravel())
        mat = np.asarray(tx._fetch_texel(atlas.material, ys, xs))
        np.testing.assert_allclose(
            mat[:, 0:3], written["albedo"].reshape(-1, 3) / 255.0, atol=1e-6
        )
        # the missing clouds channel came from procgen, not the files
        from digital_earth.assets.procgen import cached_earth_textures

        proc = cached_earth_textures((16, 32), 7)
        clouds = np.asarray(tx._fetch_texel(atlas.clouds, ys, xs))
        np.testing.assert_allclose(
            clouds[:, 0], proc["clouds"].ravel() / 255.0, atol=1e-6
        )

    @pytest.mark.slow

    def test_render_with_file_atlas(self, tmp_path):
        """End-to-end: a file-loaded atlas renders through the path tracer."""
        from digital_earth.app.config_io import apply_config, load_config
        from digital_earth.assets.textures import load_texture_atlas
        from digital_earth.render.renderer import Renderer

        self._write_tier0(tmp_path, h=32, w=64)
        atlas = load_texture_atlas(texture_dir=str(tmp_path), quality=0)
        r = Renderer(image_res=(16, 9), atlas=atlas, tile_pixels=144)
        apply_config(
            r, load_config("scenes/config - Apollo 11.txt")
        )
        r.accumulate()
        buf = np.asarray(r.color_buffer)
        assert np.isfinite(buf).all()
        assert buf.max() > 0.0


class TestUpsampledAtlas:
    """Device-side NN-upsample + row-gather pack (Tex2D.from_upsampled) —
    the tier-2-scale bench path (bench.py, chip_smoke.py)."""

    @pytest.mark.parametrize(
        "shape,factor",
        [((6, 12, 8), 4), ((5, 10, 4), 3), ((7, 14, 3), 6), ((4, 8), 2),
         ((6, 12, 8), 1)],
    )
    def test_matches_host_pack(self, shape, factor):
        rng = np.random.default_rng(hash(shape + (factor,)) % 2**32)
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        ref = tx.Tex2D.from_array(
            np.repeat(np.repeat(img, factor, 0), factor, 1)
        )
        got = tx.Tex2D.from_upsampled(jnp.asarray(img), factor)
        assert (got.h, got.w, got.channels) == (ref.h, ref.w, ref.channels)
        assert got.rows.shape == ref.rows.shape
        np.testing.assert_array_equal(np.asarray(got.rows), np.asarray(ref.rows))

    def test_upsampled_procedural_atlas(self, tmp_path):
        """The packed planes cache per-plane .npy files incrementally and the
        upsampled atlas equals a host-built atlas of NN-upsampled planes."""
        import os

        from digital_earth.assets.textures import (
            build_atlas_arrays, cached_atlas_arrays, pack_atlas,
            upsampled_procedural_atlas,
        )
        from digital_earth.assets.procgen import cached_earth_textures

        base = (16, 32)
        packs = cached_atlas_arrays(base, seed=3, cache_dir=str(tmp_path))
        assert len([f for f in os.listdir(tmp_path) if f.endswith(".npy")]) == 4
        # cache round-trips
        packs2 = cached_atlas_arrays(base, seed=3, cache_dir=str(tmp_path))
        for k in packs:
            np.testing.assert_array_equal(packs[k], packs2[k])
        expect = build_atlas_arrays(
            cached_earth_textures(base, 3, cache_dir=str(tmp_path))
        )
        for k in packs:
            np.testing.assert_array_equal(packs[k], expect[k])

        atlas = upsampled_procedural_atlas(
            (48, 96), base, seed=3, cache_dir=str(tmp_path), jitter=0.0
        )
        host = pack_atlas(
            {k: np.repeat(np.repeat(v, 3, 0), 3, 1) for k, v in packs.items()},
            jitter=0.0,
        )
        for name in ("material", "topography", "clouds", "stars"):
            g, r = getattr(atlas, name), getattr(host, name)
            assert (g.h, g.w, g.channels) == (r.h, r.w, r.channels)
            np.testing.assert_array_equal(
                np.asarray(g.rows), np.asarray(r.rows)
            )

    def test_upsample_jitter_properties(self):
        """Terrain-honesty jitter: deterministic,
        channel-0-only, downward-only (mips stay conservative), zero stays
        zero (exact-ocean hits stay exact), and actually moves texels."""
        rng = np.random.default_rng(5)
        img = rng.integers(0, 255, (6, 12, 4), dtype=np.uint8)
        img[:2, :3, 0] = 0  # an "ocean" patch
        ref = tx.Tex2D.from_upsampled(jnp.asarray(img), 4)
        a = tx.Tex2D.from_upsampled(jnp.asarray(img), 4, jitter=0.06)
        b = tx.Tex2D.from_upsampled(jnp.asarray(img), 4, jitter=0.06)
        ra = np.asarray(ref.rows).astype(int)
        rj = np.asarray(a.rows).astype(int)
        np.testing.assert_array_equal(np.asarray(a.rows), np.asarray(b.rows))
        lane = np.arange(128)
        tpr = 128 // 4
        valid = lane < tpr * 4
        c0 = valid & (lane % 4 == 0)
        rest = valid & (lane % 4 != 0)
        assert (rj[:, c0] <= ra[:, c0]).all()
        assert (rj[:, c0] >= np.floor(ra[:, c0] * 0.94) - 1).all()
        np.testing.assert_array_equal(rj[:, rest], ra[:, rest])
        zero = ra[:, c0] == 0
        assert (rj[:, c0][zero] == 0).all()
        assert (rj[:, c0] != ra[:, c0]).mean() > 0.3

    def test_non_integer_factor_rejected(self):
        from digital_earth.assets.textures import (
            upsampled_procedural_atlas,
        )

        with pytest.raises(ValueError):
            upsampled_procedural_atlas((50, 100), (16, 32))
