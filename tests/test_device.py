"""Device facts the entry points share: compile cache and device record
(``cartpole_tpu/utils/device.py``)."""

import jax
import pytest

from cartpole_tpu.utils import device


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set the helper uses it and sets
    nothing (JAX reads the variable itself)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch,
                                                      restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = device.enable_compile_cache()
    assert got == str(device.DEFAULT_CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == got
    # <checkout>/.jax_cache, next to the package and listed in .gitignore.
    root = device.DEFAULT_CACHE_DIR.parent
    assert device.DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert (root / "cartpole_tpu").is_dir()
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_device_record_names_the_cpu_mesh():
    rec = device.device_record()
    assert rec == {"platform": "cpu", "device_kind": "cpu",
                   "device_count": 8}
    assert device.device_record(jax.devices()[:1])["device_count"] == 1

