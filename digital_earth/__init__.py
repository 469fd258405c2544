"""digital_earth — a JAX/XLA spectral volumetric path tracer of the Earth.

A from-scratch rebuild of the capabilities of AntonioFerreras/Digital-Earth
(a Taichi/Vulkan megakernel renderer) as a JAX wavefront renderer:

- structure-of-arrays ray state advanced by masked ``lax.while_loop`` bounces
- equirect textures resident in device memory, sampled with bilinear gathers
- deterministic, counter-based ``jax.random`` keyed by (frame, spp, bounce)
- hero-wavelength spectral sampling against the CIE curves
- OpenDRT / AgX display transforms + measured camera-response film chain
- multi-device spp/tile sharding over a ``jax.sharding.Mesh``

See SURVEY.md at the repo root for the structural map of the reference and
file:line citations used throughout this package.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Convenience lazy exports: digital_earth.Renderer, .EarthViewer, ...
    (lazy so importing the package never touches jax before config)."""
    if name == "Renderer":
        from .render.renderer import Renderer

        return Renderer
    if name == "EarthViewer":
        from .app.viewer import EarthViewer

        return EarthViewer
    if name == "TraceConfig":
        from .render.params import TraceConfig

        return TraceConfig
    if name == "render_offline":
        from .app.viewer import render_offline

        return render_offline
    raise AttributeError(name)
