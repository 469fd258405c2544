"""Test configuration: the JAX CPU backend with 8 virtual devices, so the
multi-device sharding logic is exercised without accelerators (SURVEY.md §4).

Tests run on the CPU unless ``JAX_PLATFORMS`` names another backend:
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` runs the tests
marked ``gpu`` on the card (they skip where JAX finds no GPU).
"""

import os

# Must be in the environment before the backend initializes.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

# Persistent compilation cache: compiles dominate the suite's wall time
# (e.g. each golden scene's first render). The cache is keyed on
# backend+HLO, so CPU test executables never collide with GPU render
# executables. JAX_COMPILATION_CACHE_DIR wins when set; otherwise a fixed
# path, so warm runs find what the first one compiled.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.expanduser(
        "~/.cache/digital_earth/jax_cache"
    ))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
