"""Frame timing and throughput metrics.

The reference's only instrumentation is a wall-clock frame timer feeding a
(disabled) adaptive-spp controller (reference earth_viewer.py:240,252-257);
here timing is a first-class utility: per-frame ms, paths/sec, EMA smoothing,
and an optional `jax.profiler` trace context for deep dives.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class FrameStats:
    frame_ms: float
    paths_per_sec: float
    spp: int


@dataclass
class FrameTimer:
    """Tracks per-frame wall clock and paths/sec with an EMA."""

    n_pixels: int
    ema_alpha: float = 0.1
    ema_ms: Optional[float] = None
    history: List[FrameStats] = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.time()

    def stop(self, spp_added: int = 1) -> FrameStats:
        dt = max(time.time() - self._t0, 1e-9)
        ms = dt * 1000.0
        self.ema_ms = ms if self.ema_ms is None else (
            self.ema_alpha * ms + (1 - self.ema_alpha) * self.ema_ms
        )
        stats = FrameStats(
            frame_ms=ms,
            paths_per_sec=self.n_pixels * spp_added / dt,
            spp=spp_added,
        )
        self.history.append(stats)
        return stats

    @property
    def mean_paths_per_sec(self) -> float:
        if not self.history:
            return 0.0
        return sum(s.paths_per_sec for s in self.history) / len(self.history)


class AdaptiveSpp:
    """Adaptive samples-per-frame controller targeting a frame rate — the
    reference ships this commented out (earth_viewer.py:253-257); here it is
    a working utility."""

    def __init__(self, target_fps: float = 30.0, max_spp: int = 64):
        self.target_fps = target_fps
        self.max_spp = max_spp
        self.spp = 1

    def update(self, elapsed_s: float) -> int:
        if elapsed_s * self.target_fps > 1.0:
            self.spp = max(int(self.spp / (elapsed_s * self.target_fps)) - 1, 1)
        else:
            self.spp = min(self.spp + 1, self.max_spp)
        return self.spp


@contextlib.contextmanager
def profiler_trace(log_dir: str = "/tmp/de_trace"):
    """Wrap a region in a jax.profiler trace (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
