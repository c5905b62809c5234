"""Tracing and timing helpers (SURVEY.md §5.1).

``trace(dir)`` wraps ``jax.profiler.trace`` (XLA/Perfetto traces viewable in
TensorBoard or ui.perfetto.dev).  ``time_calls`` gives the steady-state
seconds per call of a jitted callable on the card, and ``chip_peaks`` the
card's published peak rates for a roofline share.
"""

from __future__ import annotations

import contextlib
import time

import jax

from color_modem_tpu.utils.runtime import require_gpu

#: Published peaks per ``device_kind``, dense rates without sparsity, at the
#: card's full 700 W power limit (NVIDIA H100 Tensor Core GPU data sheet,
#: SXM5 part).  Used only for roofline *reports*; a device missing here is
#: an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "f32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
    },
}


def chip_peaks(kind: str | None = None) -> dict:
    """Peak rates of ``kind`` (default: the first JAX device's kind)."""
    kind = jax.devices()[0].device_kind if kind is None else kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add them to "
            "utils/profiling.PEAKS with their source"
        ) from None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: `with trace(dir): run()` -> Perfetto trace."""
    with jax.profiler.trace(log_dir):
        yield


def time_calls(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds per call of ``fn(*args)`` on the card.

    ``warmup`` calls (the first one compiles) are waited for and not
    timed; then ``iters`` calls are dispatched back to back and the window
    ends when the last result is ready (``block_until_ready`` — dispatch
    is asynchronous, so without it the clock would stop at the enqueue).
    """
    require_gpu()
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters
