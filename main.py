"""Entry point: launch the interactive Earth viewer
(counterpart of the reference main.py:1-5).

``--multichip`` renders over every available chip via the ("px", "spp")
device mesh (parallel/mesh.py) — same image bit for bit, one accumulate
adds one spp per "spp"-axis device.

``--adaptive`` switches idle progression to adaptive tile sampling: each
pass refines only the noisiest quarter of pixel blocks, so visible noise
converges faster for the same chip time. Composes with ``--multichip``
(each "px" device refines its own noisiest tiles).
"""

import sys

from digital_earth.app.viewer import EarthViewer

if __name__ == "__main__":
    image_res = (1920, 1080)
    adaptive = 0.25 if "--adaptive" in sys.argv else 0.0
    if "--multichip" in sys.argv:
        from digital_earth.parallel.mesh import (
            MultiChipRenderer, make_render_mesh,
        )
        from digital_earth.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        renderer = MultiChipRenderer(
            make_render_mesh(), image_res, atlas=None, luts=None
        )
        EarthViewer(renderer=renderer, adaptive_frac=adaptive).start()
    else:
        EarthViewer(image_res=image_res, adaptive_frac=adaptive).start()
