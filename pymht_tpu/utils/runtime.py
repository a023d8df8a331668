"""Process set-up shared by the entry points (scripts, benches, examples).

* ``enable_compile_cache`` places JAX's persistent compilation cache.
  With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and this
  sets nothing; otherwise the cache goes to ``<repo>/.jax_cache``.  The
  directory is part of the cache key, so it is fixed, never temporary.
* ``require_gpu`` returns the devices and raises unless JAX runs on a
  GPU: a measurement made on the CPU must not pass for a GPU one.

Library modules never call these on import.
"""
from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point the persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu(n: int = 1):
    """The JAX devices, if the default backend is a GPU with at least
    ``n`` devices; raises RuntimeError otherwise."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devices[0].platform!r} "
            f"({devices[0].device_kind})")
    if len(devices) < n:
        raise RuntimeError(f"need {n} GPUs, JAX sees {len(devices)}")
    return devices
