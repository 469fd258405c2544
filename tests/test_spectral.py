import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_earth.assets.luts import load_spectral_luts
from digital_earth.ops import spectral as sp


@pytest.fixture(scope="module")
def luts():
    return load_spectral_luts()


class TestPlancks:
    def test_wien_peak(self):
        # Wien displacement for the reference's (nm-scaled, slightly
        # non-physical) constants: peak at hc/(4.965114 k T)
        wl = jnp.linspace(300.0, 1200.0, 1801)
        spd = np.asarray(sp.plancks(5778.0, wl))
        h, c, k = 6.62607015e-16, 2.9e17, 1.38e-5
        expected = h * c / (4.965114 * k * 5778.0)
        assert float(wl[spd.argmax()]) == pytest.approx(expected, rel=0.01)

    def test_hotter_is_brighter_everywhere(self):
        wl = jnp.linspace(390.0, 830.0, 45)
        a = np.asarray(sp.plancks(5778.0, wl))
        b = np.asarray(sp.plancks(2700.0, wl))
        assert np.all(a > b)


class TestSpectrumSample:
    def test_wavelength_range_and_pdf(self, luts):
        u = jax.random.uniform(jax.random.PRNGKey(0), (8192,))
        wl, resp, rcp_pdf = sp.spectrum_sample(u, luts.cie_cdf, luts.cie_response)
        wl = np.asarray(wl)
        assert wl.min() >= 390.0 and wl.max() <= 831.0
        assert np.all(np.isfinite(np.asarray(rcp_pdf)))
        assert np.all(np.asarray(rcp_pdf) >= 0)

    @pytest.mark.slow

    def test_importance_sampling_unbiased(self, luts):
        # MC estimate of integral of f(l)*response via the sampler should
        # match quadrature: estimator = mean(f(wl) * resp * rcp_pdf)
        u = jax.random.uniform(jax.random.PRNGKey(1), (200000,))
        wl, resp, rcp_pdf = sp.spectrum_sample(u, luts.cie_cdf, luts.cie_response)
        f = sp.plancks(5778.0, wl)
        est = np.asarray(jnp.mean(f[:, None] * resp * rcp_pdf[:, None], axis=0))
        # quadrature over the LUT domain: with pdf(wl) = mean_resp(wl)/S and
        # weight 1/sum_resp, the estimator converges to trapz(f*resp)/(3*S)
        wl_q = np.arange(390.0, 831.0)
        resp_q = np.asarray(luts.cie_response)
        f_q = np.asarray(sp.plancks(5778.0, jnp.asarray(wl_q)))
        s = np.trapezoid(resp_q[:, 1])
        quad = np.trapezoid(f_q[:, None] * resp_q, axis=0) / (3.0 * s)
        np.testing.assert_allclose(est, quad, rtol=0.02)

    def test_inverse_cdf_monotone(self, luts):
        u = jnp.linspace(0.001, 0.999, 512)
        wl, _, _ = sp.spectrum_sample(u, luts.cie_cdf, luts.cie_response)
        assert np.all(np.diff(np.asarray(wl)) >= 0)


class TestSrgbToSpectrum:
    def test_white_is_flat(self, luts):
        wl = jnp.linspace(402.0, 698.0, 100)
        white = jnp.ones((100, 3))
        p = np.asarray(sp.srgb_to_spectrum(luts.srgb2spec, white, wl))
        np.testing.assert_allclose(p, 1.0, atol=0.15)

    def test_out_of_band_is_zero(self, luts):
        rgb = jnp.ones(3)
        assert float(sp.srgb_to_spectrum(luts.srgb2spec, rgb, jnp.array(395.0))) == 0.0
        assert float(sp.srgb_to_spectrum(luts.srgb2spec, rgb, jnp.array(705.0))) == 0.0
        # reference quirk: w must be > 0, so 400-401nm is also zero
        assert float(sp.srgb_to_spectrum(luts.srgb2spec, rgb, jnp.array(400.5))) == 0.0

    def test_primaries_peak_in_their_band(self, luts):
        wl = jnp.arange(402.0, 699.0)
        red = np.asarray(
            sp.srgb_to_spectrum(luts.srgb2spec, jnp.array([1.0, 0.0, 0.0]), wl)
        )
        green = np.asarray(
            sp.srgb_to_spectrum(luts.srgb2spec, jnp.array([0.0, 1.0, 0.0]), wl)
        )
        blue = np.asarray(
            sp.srgb_to_spectrum(luts.srgb2spec, jnp.array([0.0, 0.0, 1.0]), wl)
        )
        assert wl[red.argmax()] > 580
        assert 500 < wl[green.argmax()] < 580
        assert wl[blue.argmax()] < 500


class TestSrgbTransfer:
    def test_round_trip(self):
        x = jnp.linspace(0.0, 1.0, 256)
        y = sp.srgb_transfer_inverse(sp.srgb_transfer(x))
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)

    def test_known_values(self):
        assert float(sp.srgb_transfer(jnp.array(0.0))) == 0.0
        assert float(sp.srgb_transfer(jnp.array(1.0))) == pytest.approx(1.0, abs=1e-6)
        assert float(sp.srgb_transfer(jnp.array(0.18))) == pytest.approx(0.4613, abs=1e-3)


class TestLum:
    def test_white_luminance(self):
        assert float(sp.lum(jnp.ones(3))) == pytest.approx(1.0, abs=1e-4)
