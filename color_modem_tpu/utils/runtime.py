"""Process set-up shared by the entry points (CLI, benchmark, chip smoke).

Library import sets nothing; an entry point calls these once at start-up.
"""

from __future__ import annotations

import os

#: Environment variable JAX itself reads for its persistent compile cache.
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

#: Fixed in-checkout cache directory (git-ignored).  The path is part of
#: the cache key, so it must not move between runs: no temp name, pid or
#: time in it.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR` inside the checkout.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu():
    """The first JAX device, which must be a GPU; raises otherwise.

    Measurements name the device they ran on and never fall back to the
    CPU: a CPU timing says nothing about the card.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); this measurement runs only on the card"
        )
    return dev
