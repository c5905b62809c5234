"""Published peaks per card, what this card reaches, and what nvidia-smi says.

Shares are stated against the published peak.  Beside it, a traced run
measures what a large float32 (``HIGHEST``) matmul and a large copy reach
on the card it ran on, because a card set below its 700 W limit cannot
hold its top clock under a matrix-heavy load.
"""

from __future__ import annotations

import subprocess
import time

#: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates without
#: sparsity, at the full 700 W power limit.  float32 outside the tensor
#: cores, which is where ``HIGHEST`` float32 matmuls run.  A card missing
#: here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}; add them with their source")
    return PEAKS[kind]


def roofline(flops: float, nbytes: float, seconds: float, kind: str):
    """(share of the roofline in %, 'compute' or 'bandwidth') for a stage
    that did ``flops`` and moved ``nbytes`` in ``seconds`` of device time."""
    p = peaks(kind)
    t_compute = flops / p["f32_flops"]
    t_memory = nbytes / p["hbm_bytes_per_s"]
    bound = "compute" if t_compute >= t_memory else "bandwidth"
    return 100.0 * max(t_compute, t_memory) / seconds, bound


def smi() -> str:
    """Name, power limit and clocks of every card, from a child off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi",
             "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"
    return out.replace("\n", " | ")


def probe(reps: int = 10) -> dict:
    """Achieved float32 HIGHEST matmul FLOP/s and copy bytes/s on device 0."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = 8192
    a = jnp.ones((n, n), jnp.float32)
    mm = jax.jit(lambda x: jnp.matmul(x, x, precision=lax.Precision.HIGHEST))
    c = jnp.ones((1 << 28,), jnp.float32)  # 1 GiB
    cp = jax.jit(lambda x: x + 1.0)
    out = {}
    for name, fn, arg, work in (
        ("matmul_f32_flops", mm, a, 2.0 * n ** 3),
        ("copy_bytes_per_s", cp, c, 2.0 * c.size * 4),
    ):
        fn(arg).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(arg)
        r.block_until_ready()
        out[name] = work * reps / (time.perf_counter() - t0)
        del r
    return out
