"""Where the persistent compilation cache lives."""

import os
import subprocess
import sys
import tempfile

import jax
import pytest

from digital_earth.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KEYS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_compile_time_secs",
    "jax_persistent_cache_min_entry_size_bytes",
)


@pytest.fixture()
def restore_config(monkeypatch):
    monkeypatch.delenv("DE_NO_COMPILE_CACHE", raising=False)
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_default_is_fixed_path_in_checkout(restore_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    assert path == os.path.join(ROOT, ".jax_cache") == cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    # stable across processes: not a temp, pid or time-stamped directory
    assert not path.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in path
    assert cache.enable_compilation_cache() == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_var_is_honoured_and_not_overridden(restore_config, monkeypatch,
                                                tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.compilation_cache_dir() == str(tmp_path)
    assert cache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; the code sets no directory of its own
    assert jax.config.jax_compilation_cache_dir == before


def test_opt_out(restore_config, monkeypatch):
    monkeypatch.setenv("DE_NO_COMPILE_CACHE", "1")
    assert cache.enable_compilation_cache() is None


def test_entries_land_in_env_dir(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set writes its
    compiled executables there."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from digital_earth.utils.cache import enable_compilation_cache\n"
        "enable_compilation_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "print(jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(8)).sum())\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=str(tmp_path), timeout=300, capture_output=True)
    assert any(p.is_file() for p in tmp_path.rglob("*"))
