"""Device facts shared by the entry points.

- :func:`enable_compile_cache`: the one persistent-compilation-cache policy
  that ``bench.py``, the CLI, ``chip_smoke.py`` and the scripts use.
- :func:`device_record`: the ``platform`` / ``device_kind`` / device count
  that every result line names, so no number is read without its device.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Sequence

import jax

__all__ = [
    "DEFAULT_CACHE_DIR",
    "device_record",
    "enable_compile_cache",
]

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset: a fixed
#: path inside the checkout (listed in ``.gitignore``). The directory is part
#: of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing. Otherwise the cache goes to :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def device_record(devices: Optional[Sequence] = None) -> Dict[str, object]:
    """``{"platform", "device_kind", "device_count"}`` of ``devices``
    (default: all devices JAX sees), as JAX reports them."""
    devs = list(jax.devices() if devices is None else devices)
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
    }

