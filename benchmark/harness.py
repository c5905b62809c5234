"""Process set-up and the path from a cell to the program's timed entry.

From the program the benchmark takes only the system under test: the plan
and the ``make_pipeline`` encode/decode jits for the configuration's
standard, decoder and frame shape, which the cell's loop
(``loops/<loop>.py``) drives.
"""

from __future__ import annotations

import os

from benchmark import spec


class Compiles:
    """Counts programs built (compiled, or loaded from the persistent cache)
    and the persistent cache's hits and writes."""

    def __init__(self):
        import jax

        self.backend = self.hits = self.misses = 0

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.hits += 1
            elif event == "/jax/compilation_cache/cache_misses":
                self.misses += 1

        def on_duration(event, _secs, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.backend += 1

        jax.monitoring.register_event_listener(on_event)
        jax.monitoring.register_event_duration_secs_listener(on_duration)


def configure_cache() -> str:
    """Persist every compile, however short, in a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR`` where it is set, else ``.jax_cache/`` in
    the checkout.  JAX by default persists only compiles of 1 s or more;
    the modem's take 0.3-1 s, so they would recompile in every run.
    """
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(spec.ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    # -1: no size threshold (0 would let JAX pick one for the filesystem)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d


def require_chips(n: int):
    """The first ``n`` devices, which must be GPUs; raises otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's devices are {devs[0].platform}; "
                           "this benchmark runs only on the card")
    if len(devs) < n:
        raise RuntimeError(f"the cell needs {n} GPUs, JAX sees {len(devs)}")
    return devs[:n]


def pipeline(config: dict):
    """The program's ``(encode, decode)`` jits for the configuration."""
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS

    plan = make_plan(ALL_STANDARDS[config["standard"]](), int(config["samples"]))
    encode, decode, _ = make_pipeline(plan, config["decoder"])
    return encode, decode


def build(cell: spec.Cell):
    """The cell's loop (``loops/<loop>.py``, named by its traffic mix)."""
    return spec.load_loop(cell.traffic["loop"])(cell.config, cell.traffic)
