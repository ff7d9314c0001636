"""Device/backend selection and the persistent compilation cache.

The array path runs on JAX's default backend (the GPU in production, the
CPU in tests).  `--device_backend cpu|host` pins JAX to the CPU before any
backend initializes; `--device_backend gpu` refuses to run without a GPU.
There is no silent fallback: a device failure surfaces as an error.
"""

from __future__ import annotations

import os

# One fixed directory inside the checkout: the cache key includes the path,
# so a directory that moved between runs would never hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
BACKENDS = ("auto", "gpu", "cpu", "host")
HOST_BACKENDS = ("cpu", "host")

_CACHE_INITIALIZED = False


def compilation_cache_dir(environ=None) -> str:
    """The persistent cache directory: JAX_COMPILATION_CACHE_DIR when set
    (JAX reads it itself), else DEFAULT_CACHE_DIR."""
    environ = os.environ if environ is None else environ
    return environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def setup_jax_cache():
    """Enable the persistent XLA compilation cache (idempotent)."""
    global _CACHE_INITIALIZED
    if _CACHE_INITIALIZED:
        return
    import jax
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _CACHE_INITIALIZED = True


def resolve_platform(device_backend: str, default_platform: str) -> str:
    """The platform the pipeline runs on for a --device_backend choice,
    given JAX's default platform.  Raises when "gpu" is asked for and JAX
    found no GPU."""
    if device_backend not in BACKENDS:
        raise ValueError("unknown device backend {0!r} (choose from {1})".format(
            device_backend, ", ".join(BACKENDS)))
    if device_backend in HOST_BACKENDS:
        return "cpu"
    if device_backend == "gpu" and default_platform != "gpu":
        raise RuntimeError("--device_backend gpu: no GPU found (JAX's default "
                           "platform is {0!r})".format(default_platform))
    return default_platform


def pin_platform(device_backend: str):
    """Pin JAX to the CPU for the host backends and enable the compile
    cache.  Must run before the first JAX computation (and before
    jax.distributed.initialize, which must precede backend creation)."""
    import jax
    if device_backend in HOST_BACKENDS:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
    setup_jax_cache()
