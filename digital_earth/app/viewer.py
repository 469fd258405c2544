"""Interactive progressive viewer.

The reference opens a local Vulkan window (`ti.ui`, earth_viewer.py:166-319);
a render host is often headless, so the equivalent here is a small built-in
web viewer: a render loop accumulates progressively on-device, and a browser
page shows the frame, forwards WASD/QE/drag camera input, and exposes the
same GUI controls (sun angle/path, FOV, aspect scale, exposure, camera
response, gamma) plus config save/load ('i'/'o') and screenshots ('p').

Also provides ``render_offline`` for scripted, windowless rendering.
"""

from __future__ import annotations

import json
import os
import threading
import time
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .camera_controller import CameraController
from .config_io import SceneConfig, apply_config, load_config, save_config, snapshot_config
from ..utils.png import encode_png, write_png

HELP_MSG = """
====================================================
Camera:
* Drag on the image to rotate
* Press W/A/S/D/Q/E (+Shift, Space, Ctrl) to move
* I saves config.txt, O loads it, P takes a screenshot
====================================================
"""

_PAGE = """<!doctype html>
<html><head><title>Digital Earth</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:12px; }
#frame { image-rendering:auto; cursor:crosshair; max-width:100%; }
.row { margin:4px 0; } input[type=range] { width: 260px; vertical-align:middle; }
span.val { display:inline-block; width:70px; }
</style></head><body>
<div><img id="frame" src="/frame.png" draggable="false"></div>
<div id="status"></div>
<div class="row">Sun angle <input type="range" id="sun_angle" min="0" max="360" step="0.1"><span class="val"></span></div>
<div class="row">Sun path <input type="range" id="sun_path_rot" min="-105" max="105" step="0.1"><span class="val"></span></div>
<div class="row">FOV <input type="range" id="fov" min="1" max="90" step="0.1"><span class="val"></span></div>
<div class="row">Aspect <input type="range" id="aspect_scale" min="0.75" max="1.25" step="0.005"><span class="val"></span></div>
<div class="row">Exposure <input type="range" id="exposure" min="-1" max="10" step="0.05"><span class="val"></span></div>
<div class="row">CRF <input type="range" id="crf" min="0" max="15" step="1"><span class="val"></span></div>
<div class="row">Gamma <input type="range" id="gamma" min="0.45" max="2.2" step="0.01"><span class="val"></span></div>
<script>
const img = document.getElementById('frame');
let keys = new Set(); let drag = null;
function refresh() { img.src = '/frame.png?' + Date.now(); }
img.onload = () => setTimeout(refresh, 250);
img.onerror = () => setTimeout(refresh, 1000);
setInterval(async () => {
  if (keys.size) await fetch('/input?keys=' + [...keys].join(','));
  const s = await (await fetch('/state')).json();
  document.getElementById('status').textContent =
    `spp ${s.spp}  |  ${s.paths_per_sec.toExponential(2)} paths/s  |  ${s.crf_name}`;
}, 200);
window.addEventListener('keydown', e => { keys.add(e.key === ' ' ? 'space' : e.key.toLowerCase());
  if (e.key==='i') fetch('/save'); if (e.key==='o') fetch('/load'); if (e.key==='p') fetch('/screenshot'); });
window.addEventListener('keyup', e => keys.delete(e.key === ' ' ? 'space' : e.key.toLowerCase()));
img.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => { if (!drag) return;
  const dx = (drag[0]-e.clientX)/img.width, dy = (drag[1]-e.clientY)/img.height;
  drag = [e.clientX, e.clientY];
  if (dx||dy) fetch(`/input?dx=${dx}&dy=${dy}`); });
for (const id of ['sun_angle','sun_path_rot','fov','aspect_scale','exposure','crf','gamma']) {
  const el = document.getElementById(id);
  el.addEventListener('input', () => { el.nextElementSibling.textContent = el.value;
    fetch(`/set?${id}=${el.value}`); });
}
fetch('/state').then(r => r.json()).then(s => {
  for (const [k, v] of Object.entries(s.sliders)) {
    const el = document.getElementById(k);
    if (el) { el.value = v; el.nextElementSibling.textContent = (+v).toFixed(2); }
  }
});
</script></body></html>"""


def upscale_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """(ph, pw, C) uint8 -> (h, w, C) uint8, bilinear with half-pixel
    centres (the preview frame shown at the full frame's size)."""

    def taps(n_out, n_in):
        x = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5,
                    0.0, n_in - 1.0)
        i0 = np.floor(x).astype(np.int64)
        return i0, np.minimum(i0 + 1, n_in - 1), (x - i0).astype(np.float32)

    y0, y1, ty = taps(h, img.shape[0])
    x0, x1, tx = taps(w, img.shape[1])
    f = img.astype(np.float32)
    ty, tx = ty[:, None, None], tx[None, :, None]
    rows = f[y0] * (1.0 - ty) + f[y1] * ty
    out = rows[:, x0] * (1.0 - tx) + rows[:, x1] * tx
    return (out + 0.5).astype(np.uint8)


class EarthViewer:
    """Progressive interactive viewer (reference EarthViewer,
    earth_viewer.py:166-319)."""

    def __init__(
        self,
        renderer=None,
        image_res=(1920, 1080),
        config_path: str = "config.txt",
        screenshot_dir: str = "screenshot",
        port: int = 8000,
        adaptive_fps: float = 0.0,
        preview_scale: int = 4,
        spp_chunks: int = 0,
        adaptive_frac: float = 0.0,
        **renderer_kwargs,
    ):
        """``adaptive_fps`` > 0 enables the adaptive samples-per-frame
        controller targeting that rate (the reference ships this commented
        out, earth_viewer.py:253-257).

        ``preview_scale`` > 0 enables interactive-by-default progressive
        escalation: while the camera moves (and for the first frame after
        any scene change) the loop renders the deterministic single-scatter
        raymarcher at ``image_res / preview_scale`` instead of blocking the
        browser behind a multi-second path-traced spp; once input goes
        idle, frames escalate to the path tracer. 0 disables (reference
        behavior: every frame is path-traced).

        ``spp_chunks``: stripe each path-traced spp into this many pixel
        chunks and poll for camera input between them, so worst-case
        input-to-preview is one *chunk*, not one full-frame spp. 0 = auto
        (one chunk per ~250K pixels); 1 disables striping.

        ``adaptive_frac`` > 0 switches idle progression to adaptive tile
        sampling (Renderer.accumulate_adaptive): after a uniform warm-up,
        each pass refines only the noisiest ``adaptive_frac`` of pixel
        blocks — visible noise converges faster for the same chip time
        (tools/adaptive_bench.py measures the multiplier), and each pass
        dispatch is ~frac of a full spp, so input latency shrinks too.
        Mutually exclusive with spp striping (per-pixel counts are not
        tracked by the chunked path); striping is disabled when set."""
        from ..utils.cache import enable_compilation_cache

        enable_compilation_cache()
        if renderer is None:
            from ..render.renderer import Renderer

            renderer = Renderer(image_res=image_res, **renderer_kwargs)
        self.renderer = renderer
        self.preview_renderer = None
        # (stub renderers in tests lack atlas/luts — escalation is a real-
        # renderer feature only)
        if preview_scale and hasattr(renderer, "atlas"):
            from ..render.renderer import Renderer

            w, h = self.renderer.image_res
            pw, ph = max(w // preview_scale, 32), max(h // preview_scale, 18)
            self.preview_renderer = Renderer(
                image_res=(pw, ph), atlas=self.renderer.atlas,
                luts=self.renderer.luts, crf=self.renderer.crf,
                cfg=self.renderer.cfg, mode="preview",
            )
        self.camera = CameraController()
        self.config_path = config_path
        self.screenshot_dir = screenshot_dir
        self.port = port
        self.adaptive_fps = adaptive_fps
        self.adaptive_frac = adaptive_frac
        n_px = self.renderer.image_res[0] * self.renderer.image_res[1]
        self.spp_chunks = (
            1 if adaptive_frac > 0
            else spp_chunks if spp_chunks > 0
            else max(1, -(-n_px // 250_000))
        )
        self._lock = threading.Lock()
        # serializes accumulate() against frame fetches: the accumulation
        # buffer is donated to the jitted step, so reading it mid-step would
        # hit a deleted array
        self._render_lock = threading.Lock()
        self._pending_keys = set()
        self._pending_rot = [0.0, 0.0]
        self._paths_per_sec = 0.0
        self._running = False
        # progressive escalation state: "preview" until the path tracer has
        # its first spp for the current pose, then "path"
        self._frame_source = "preview" if preview_scale else "path"
        self._frame_time = 0.0
        self._scene_dirty = True
        # (frame, stamp) assigned as one tuple so readers on other threads
        # can never pair a new stamp with the previous frame
        self._frame_snap = (None, 0)
        self._png_cache = None
        self._png_stamp = -1
        self._server = None
        self._loop_thread = None
        self.camera.push_to(self.renderer)
        os.makedirs(screenshot_dir, exist_ok=True)
        if os.path.exists(config_path):
            self.load(config_path)

    # --- actions ----------------------------------------------------------
    def save(self, path=None):
        save_config(path or self.config_path, snapshot_config(self.renderer, self.camera))

    def load(self, path=None):
        cfg = load_config(path or self.config_path)
        self.camera.set_pose(cfg.camera_pos, cfg.look_at, cfg.up)
        apply_config(self.renderer, cfg)
        self.camera.push_to(self.renderer)

    def screenshot(self):
        ts = datetime.today().strftime("%Y-%m-%d-%H%M%S")
        fname = os.path.join(self.screenshot_dir, f"earth-{ts}.png")
        with self._render_lock:
            img = self.renderer.fetch_image_np()
        write_png(fname, img)
        print(f"Screenshot has been saved to {fname}")
        return fname

    def _sync_preview_state(self):
        """Mirror scene/postprocess scalars onto the preview renderer."""
        p, r = self.preview_renderer, self.renderer
        p.sun_angle = r.sun_angle
        p.sun_path_rot = r.sun_path_rot
        p.fov = r.fov
        p.aspect_scale = r.aspect_scale
        p.land_height_scale = r.land_height_scale
        p.exposure = r.exposure
        p.gamma = r.gamma
        p.selected_crf = r.selected_crf

    def _snapshot_frame(self):
        """Cache the current frame as a displayable array (called by the
        render loop while it already holds the render lock) so /frame.png
        never has to wait behind a multi-second accumulate at high res."""
        if self._frame_source == "preview" and self.preview_renderer:
            frame = upscale_bilinear(
                self.preview_renderer.fetch_image_np(),
                *self.renderer.image_res,
            )
        else:
            frame = self.renderer.fetch_image_np()
        self._frame_snap = (frame, self._frame_snap[1] + 1)

    def _frame_png(self) -> bytes:
        if self._frame_snap[0] is None:
            with self._render_lock:
                self._snapshot_frame()
        frame, stamp = self._frame_snap  # single atomic tuple read
        if self._png_cache is None or self._png_stamp != stamp:
            self._png_cache, self._png_stamp = encode_png(frame), stamp
        return self._png_cache

    def _state(self) -> dict:
        r = self.renderer
        spp = r.current_spp
        if self.adaptive_frac > 0 and getattr(r, "count_buffer", None) is not None:
            spp = round(r.mean_spp, 2)  # average samples/pixel under adaptive
        return {
            "spp": spp,
            "paths_per_sec": self._paths_per_sec,
            "frame_source": self._frame_source,
            "frame_id": self._frame_snap[1],  # +1 per displayed frame
            "frame_time": round(self._frame_time, 3),
            "crf_name": r.crf_names[r.selected_crf],
            "sliders": {
                "sun_angle": np.degrees(r.sun_angle),
                "sun_path_rot": np.degrees(r.sun_path_rot),
                "fov": np.degrees(r.fov) * 2,
                "aspect_scale": r.aspect_scale,
                "exposure": r.exposure,
                "crf": r.selected_crf,
                "gamma": r.gamma,
            },
        }

    def _apply_set(self, q: dict) -> bool:
        r = self.renderer
        reset = False
        if "sun_angle" in q:
            r.set_sun_angle(np.radians(float(q["sun_angle"][0]))); reset = True
        if "sun_path_rot" in q:
            r.set_sun_path_rot(np.radians(float(q["sun_path_rot"][0]))); reset = True
        if "fov" in q:
            r.set_fov(np.radians(float(q["fov"][0])) / 2); reset = True
        if "aspect_scale" in q:
            r.set_aspect_scale(float(q["aspect_scale"][0])); reset = True
        if "exposure" in q:
            r.set_exposure(float(q["exposure"][0]))
        if "crf" in q:
            # clamp: an out-of-range index would make every later /state
            # raise IndexError on the crf-name lookup
            r.set_crf(max(0, min(int(q["crf"][0]), len(r.crf_names) - 1)))
        if "gamma" in q:
            r.set_gamma(float(q["gamma"][0]))
        return reset

    # --- render loop -----------------------------------------------------
    @staticmethod
    def _sync(buf):
        """Wait for a device buffer. JAX releases the GIL while it waits,
        so the HTTP threads keep answering during a multi-second spp
        (chip_smoke.py times /state during a 1080p spp to check it)."""
        block = getattr(buf, "block_until_ready", None)
        if block is not None:
            block()

    def _render_loop(self):
        from ..utils.profiling import AdaptiveSpp

        controller = (
            AdaptiveSpp(target_fps=self.adaptive_fps) if self.adaptive_fps > 0 else None
        )
        spp_per_frame = 1
        elapsed = 0.05
        n_pixels = self.renderer.image_res[0] * self.renderer.image_res[1]
        while self._running:
            with self._lock:
                keys = set(self._pending_keys)
                # consume the impulse: the web client re-sends held keys
                # every 200 ms, so clearing here ends motion on release.
                # (Without this, one /input?keys=w moved the camera forever:
                # every frame stayed "dirty", the viewer previewed
                # indefinitely, and path frames never resumed — found by
                # tools/viewer_latency.py trials 1+ reading 0.00 s.)
                self._pending_keys = set()
                dx, dy = self._pending_rot
                self._pending_rot = [0.0, 0.0]
            moved = self.camera.update_keys(keys, elapsed)
            moved = self.camera.rotate(dx, dy) or moved
            t0 = time.time()
            with self._render_lock:
                if moved:
                    self.camera.push_to(self.renderer)
                    self.renderer.reset_framebuffer()
                dirty = moved or self._scene_dirty
                self._scene_dirty = False
                # interactive escalation: a moving camera / changed scene
                # gets a preview frame (sub-second) instead of queueing
                # behind a full path-traced spp; idle frames path-trace
                if dirty and self.preview_renderer is not None:
                    self.camera.push_to(self.preview_renderer)
                    self._sync_preview_state()
                    self.preview_renderer.reset_framebuffer()
                    self.preview_renderer.accumulate()
                    self._sync(self.preview_renderer.color_buffer)
                    self._frame_source = "preview"
                    self._snapshot_frame()
                    elapsed = max(time.time() - t0, 1e-4)
                    self._frame_time = elapsed
                    # report preview throughput too (the preview renderer's
                    # own pixel count), not the last idle-frame value
                    pw, ph = self.preview_renderer.image_res
                    self._paths_per_sec = pw * ph / elapsed
                    continue
                # striped spp: poll for input between pixel chunks; on
                # input, abandon the partial spp so the preview branch
                # answers within one chunk instead of one full frame
                def input_pending():
                    with self._lock:
                        return bool(self._pending_keys) or (
                            self._pending_rot[0] != 0.0
                            or self._pending_rot[1] != 0.0
                        ) or self._scene_dirty

                aborted = False
                samples0 = getattr(self.renderer, "total_samples", 0)
                for _ in range(spp_per_frame):
                    if self.adaptive_frac > 0 and hasattr(
                        self.renderer, "accumulate_adaptive"
                    ):
                        self.renderer.accumulate_adaptive(
                            frac=self.adaptive_frac
                        )
                        if input_pending():
                            break  # the pass landed; answer input now
                    elif self.spp_chunks > 1 and hasattr(
                        self.renderer, "accumulate_interruptible"
                    ):
                        done = self.renderer.accumulate_interruptible(
                            self.spp_chunks, interrupt=input_pending
                        )
                        if not done:
                            aborted = True
                            break
                    else:
                        self.renderer.accumulate()
                if aborted:
                    continue
                self._sync(self.renderer.color_buffer)
                self._frame_source = "path"
                self._snapshot_frame()
            elapsed = max(time.time() - t0, 1e-4)
            self._frame_time = elapsed
            samples1 = getattr(self.renderer, "total_samples", 0)
            n_traced = (
                samples1 - samples0
                if samples1 > samples0
                else n_pixels * spp_per_frame
            )
            self._paths_per_sec = n_traced / elapsed
            if controller is not None:
                spp_per_frame = controller.update(elapsed)

    def make_server(self, host: str = "0.0.0.0", port=None) -> ThreadingHTTPServer:
        """Build the HTTP server with the real request handler (also used by
        tests to exercise the actual routing)."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    self._route()
                except (ValueError, KeyError, IndexError) as e:
                    self.send_error(400, str(e))
                except BrokenPipeError:
                    pass

            def _route(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/":
                    body, ctype = _PAGE.encode(), "text/html"
                elif url.path == "/frame.png":
                    body, ctype = viewer._frame_png(), "image/png"
                elif url.path == "/state":
                    body, ctype = json.dumps(viewer._state()).encode(), "application/json"
                elif url.path == "/input":
                    with viewer._lock:
                        viewer._pending_keys = set(
                            q.get("keys", [""])[0].split(",")
                        ) - {""}
                        viewer._pending_rot[0] += float(q.get("dx", [0])[0])
                        viewer._pending_rot[1] += float(q.get("dy", [0])[0])
                    body, ctype = b"ok", "text/plain"
                elif url.path == "/set":
                    with viewer._render_lock:
                        if viewer._apply_set(q):
                            viewer.renderer.reset_framebuffer()
                            viewer._scene_dirty = True
                    body, ctype = b"ok", "text/plain"
                elif url.path == "/save":
                    viewer.save(); body, ctype = b"saved", "text/plain"
                elif url.path == "/load":
                    with viewer._render_lock:
                        viewer.load()
                        viewer._scene_dirty = True
                    body, ctype = b"loaded", "text/plain"
                elif url.path == "/screenshot":
                    body, ctype = viewer.screenshot().encode(), "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return ThreadingHTTPServer(
            (host, self.port if port is None else port), Handler
        )

    def serve_background(self, host: str = "127.0.0.1", port=None) -> int:
        """Run the render loop and the HTTP server on daemon threads and
        return the bound port (0 picks a free one); ``stop()`` ends both.
        The headless entry point for scripts and tests."""
        self._running = True
        self._loop_thread = threading.Thread(
            target=self._render_loop, daemon=True
        )
        self._loop_thread.start()
        self._server = self.make_server(host, port)
        threading.Thread(
            target=self._server.serve_forever, daemon=True
        ).start()
        return self._server.server_address[1]

    def stop(self, timeout: float = 60.0) -> bool:
        """Stop serving and wait up to ``timeout`` s for the render loop to
        finish its current frame; returns whether it did."""
        self._running = False
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._loop_thread is None:
            return True
        self._loop_thread.join(timeout)
        return not self._loop_thread.is_alive()

    def start(self):
        """Serve the viewer; blocks until interrupted
        (the reference's window loop, earth_viewer.py:183-319)."""
        print(HELP_MSG)
        port = self.serve_background(host="0.0.0.0", port=self.port)
        print(f"Earth Viewer serving at http://localhost:{port}")
        try:
            while self._loop_thread.is_alive():
                self._loop_thread.join(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop(timeout=5)


def render_offline(
    scene_config: SceneConfig,
    spp: int = 64,
    image_res=(1920, 1080),
    out_path: str = "render.png",
    renderer=None,
    progress_every: int = 0,
    **renderer_kwargs,
):
    """Windowless scripted render of a scene config; returns the Renderer."""
    if renderer is None:
        from ..render.renderer import Renderer

        renderer = Renderer(image_res=image_res, **renderer_kwargs)
    apply_config(renderer, scene_config)
    t0 = time.time()
    for i in range(spp):
        renderer.accumulate()
        if progress_every and (i + 1) % progress_every == 0:
            np.asarray(renderer.color_buffer)
            rate = (i + 1) * image_res[0] * image_res[1] / (time.time() - t0)
            print(f"spp {i+1}/{spp}  {rate:.3e} paths/s")
    if out_path:
        write_png(out_path, renderer.fetch_image_np())
    return renderer
