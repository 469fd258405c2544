"""Persistent XLA compilation cache.

The 1080p render step's first compile is the viewer's start-up cost; the
reference hides the same cost behind Taichi's ``offline_cache=True``
(reference earth_viewer.py:168). This is the JAX equivalent: executables are
serialized to a cache directory keyed by HLO + compile flags + backend, so
every process after the first pays only the deserialize cost.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set (JAX
reads the variable itself; no other directory is set in code), and otherwise
at the fixed ``<checkout>/.jax_cache``: a directory that moves between
processes is never hit again.

Call ``enable_compilation_cache()`` before the first jit dispatch. All entry
points (bench.py, main.py, the viewer, chip_smoke.py, tools/) do so; it is
opt-out via ``DE_NO_COMPILE_CACHE=1``.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``DEFAULT_CACHE_DIR``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; returns the directory
    used (None when disabled via DE_NO_COMPILE_CACHE)."""
    if os.environ.get("DE_NO_COMPILE_CACHE"):
        return None
    import jax

    cache_dir = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache everything that takes noticeable compile time, not only the
    # multi-minute frame executables
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


# ---------------------------------------------------------------------------
# AOT trace cache: jax.export artifacts keyed by code + call signature.
#
# The persistent compilation cache only skips XLA *compilation*; the 1080p
# render step still pays its Python *tracing* on every process start.
# jax.export serializes the traced StableHLO, so a warm process deserializes
# the module (< 1 s) and goes straight to the compile-cache hit. Cache keys
# hash the package source (any code change invalidates), the JAX version,
# backend, and the call's shape/dtype/static-argument signature.
# ---------------------------------------------------------------------------

_SRC_HASH = None
_EXPORT_REGISTERED = False


def _register_export_serialization():
    """Register the framework's pytree node types with jax.export so call
    signatures containing them can be serialized. Idempotent."""
    global _EXPORT_REGISTERED
    if _EXPORT_REGISTERED:
        return
    import json

    from jax import export as jexp

    from ..assets.luts import CRFPack, SpectralLUTs
    from ..assets.textures import TextureAtlas
    from ..ops.texture import Tex2D
    from ..render.camera import CameraParams
    from ..render.params import SceneParams

    for cls in (CameraParams, SceneParams, SpectralLUTs, CRFPack,
                TextureAtlas):
        jexp.register_namedtuple_serialization(
            cls, serialized_name=f"digital_earth.{cls.__name__}"
        )
    jexp.register_pytree_node_serialization(
        Tex2D,
        serialized_name="digital_earth.Tex2D",
        serialize_auxdata=lambda aux: json.dumps(list(aux)).encode(),
        deserialize_auxdata=lambda b: tuple(json.loads(bytes(b).decode())),
    )
    _EXPORT_REGISTERED = True


def _package_source_hash() -> str:
    """Hash of every .py file in the digital_earth package (sorted), so
    any code edit invalidates AOT artifacts traced from older code."""
    global _SRC_HASH
    if _SRC_HASH is None:
        import hashlib

        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        for root, _, files in sorted(os.walk(pkg_dir)):
            for fn in sorted(files):
                if fn.endswith(".py"):
                    p = os.path.join(root, fn)
                    h.update(p.encode())
                    with open(p, "rb") as f:
                        h.update(f.read())
        _SRC_HASH = h.hexdigest()[:16]
    return _SRC_HASH


def aot_cached(name: str, jit_fn, example_args, static_sig: str,
               cache_dir: str | None = None):
    """Return a callable equivalent to ``jit_fn`` bound to the shapes of
    ``example_args``, backed by a serialized jax.export artifact.

    On a cache hit the retrace is replaced by a sub-second deserialization; on a miss the function is exported once (one trace) and
    the artifact written for the next process. Returns ``jit_fn`` unchanged
    when caching is disabled (DE_NO_COMPILE_CACHE) or export fails (e.g. an
    unsupported backend) — correctness never depends on the cache.

    Note: the rehydrated call does not donate buffers (one extra framebuffer
    copy per step, microseconds at 1080p).
    """
    # Opt-in (DE_AOT_CACHE=1): the serialized-StableHLO round trip skips the
    # retrace, but the rehydrated module can lose layout/optimization
    # decisions through export, so the default path re-traces and relies on
    # the persistent compilation cache only until its steady-state cost is
    # measured against the tracing it saves.
    if not os.environ.get("DE_AOT_CACHE") or os.environ.get("DE_NO_COMPILE_CACHE"):
        return jit_fn
    import hashlib

    import jax

    _register_export_serialization()

    if cache_dir is None:
        cache_dir = compilation_cache_dir()
    aot_dir = os.path.join(cache_dir, "aot")
    os.makedirs(aot_dir, exist_ok=True)

    sig = hashlib.sha256()
    sig.update(_package_source_hash().encode())
    sig.update(jax.__version__.encode())
    sig.update(jax.default_backend().encode())
    sig.update(static_sig.encode())
    for leaf in jax.tree_util.tree_leaves(example_args):
        sig.update(str((getattr(leaf, "shape", ()),
                        str(getattr(leaf, "dtype", type(leaf))))).encode())
    path = os.path.join(aot_dir, f"{name}-{sig.hexdigest()[:24]}.jaxexport")

    try:
        if os.path.exists(path):
            with open(path, "rb") as f:
                exported = jax.export.deserialize(bytearray(f.read()))
        else:
            exported = jax.export.export(jit_fn)(*example_args)
            blob = exported.serialize()
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        return jax.jit(exported.call)
    except Exception:  # noqa: BLE001 — cache is best-effort by design
        return jit_fn
