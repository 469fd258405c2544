"""Debugging aids.

The reference's NaN hygiene is manual clamping (SURVEY.md §5: final-sample
clamp pathtracer.py:466-467, BRDF guards). Here the same clamps exist in the
tracer, plus JAX-native debugging switches.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Raise on any NaN produced inside jitted code (jax debug_nans)."""
    import jax

    old = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


@contextlib.contextmanager
def cpu_backend(devices: int = 8):
    """Force the CPU backend (with virtual devices) for debugging — the
    accelerator-free way to run any render path, including multi-device
    sharding."""
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={devices}"
        ).strip()
    import jax

    old = jax.config.read("jax_platforms") or ""
    jax.config.update("jax_platforms", "cpu")
    try:
        yield
    finally:
        jax.config.update("jax_platforms", old or None)
