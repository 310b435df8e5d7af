"""The accelerator check and the persistent compile cache.

The batched engines run on a GPU. The CPU runs them only when it is asked
for explicitly: ``JAX_PLATFORMS=cpu``, ``--device cpu``, or the tests.
``require_device()`` is the check the production surfaces (``aligntools
batch``, ``serve``, ``calibrate``, the pipeline) make first: with no GPU
and no explicit CPU request it raises instead of carrying on on the CPU.
``on_gpu()`` is the one routing predicate the engines read.
"""

from __future__ import annotations

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class NoDeviceError(RuntimeError):
    """No GPU is visible and the CPU was not asked for."""


def cpu_requested() -> bool:
    """True when the process was pinned to the CPU platform explicitly."""
    if "jax" in sys.modules:
        import jax

        want = jax.config.jax_platforms or ""
    else:
        want = os.environ.get("JAX_PLATFORMS", "")
    return want.split(",")[0] == "cpu"


def backend_name() -> str:
    """``jax.default_backend()``; answers ``"cpu"`` without importing jax
    when the environment already pins the CPU (the single-pair CLI's
    NumPy path never needs jax, whose import costs ~2 s)."""
    if "jax" not in sys.modules and cpu_requested():
        return "cpu"
    import jax

    return jax.default_backend()


def on_gpu() -> bool:
    return backend_name() == "gpu"


def require_device() -> str:
    """The backend name, or NoDeviceError when no GPU is visible and the
    CPU was not requested explicitly."""
    try:
        name = backend_name()
    except RuntimeError as err:  # JAX_PLATFORMS names a platform it lacks
        raise NoDeviceError(f"no usable accelerator: {err}") from err
    if name == "gpu" or (name == "cpu" and cpu_requested()):
        return name
    raise NoDeviceError(
        f"no GPU found (JAX backend is {name!r}); set JAX_PLATFORMS=cpu "
        f"or pass --device cpu to run on the CPU"
    )


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache"
    )


_cache_enabled = False


def enable_compile_cache() -> None:
    """Persistent XLA compilation cache in ``cache_dir()``.

    Each bucket shape of the chunked engine is its own executable, and a
    bucketed run touches dozens of them; the cache lets the next process
    load them instead of compiling again. Skipped on a CPU host with
    several (virtual) devices only: XLA's executable serialization has
    aborted there on shard_map programs, which the GPU does not do."""
    global _cache_enabled
    if _cache_enabled:
        return
    import jax

    if jax.default_backend() == "cpu" and jax.device_count() > 1:
        return
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _cache_enabled = True
