"""PSNR / SNR metrics (SURVEY.md K14, §5.5).

Used both host-side (golden comparisons in tests) and on-device (bench and
sharded runs, where the reduction ends in a ``psum``/gather).
"""

from __future__ import annotations

import numpy as np


def mse(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a, b, peak: float = 1.0) -> float:
    """Peak SNR in dB; +inf for identical inputs."""
    m = mse(a, b)
    if m == 0.0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def psnr_jnp(a, b, peak: float = 1.0):
    """On-device PSNR (traceable; caller wraps the mean in psum if sharded)."""
    import jax.numpy as jnp

    m = jnp.mean((a - b) ** 2)
    return 10.0 * jnp.log10(peak * peak / jnp.maximum(m, 1e-20))


def fingerprint_jnp(x):
    """On-device content fingerprint -> (2,) f32 (traceable).

    Two pseudo-random-weighted reductions: enough to detect a corrupted or
    mixed-up chunk in the resume manifest WITHOUT hauling the full output to
    the host (a sha256 of a 233 MB chunk would cost a full transfer of
    what the compute produced).  NOT cryptographic; deterministic per
    device platform, not across platforms.
    """
    import jax.numpy as jnp

    f = x.astype(jnp.float32).ravel()
    # Weight phase from an int32 iota reduced mod a prime period: a float32
    # arange collapses consecutive indices above 2^24 elements (~16.8M; a
    # 16-frame 576x720 PAL chunk is ~19.9M), giving identical weights to
    # adjacent tail elements.  i % P stays exact in int32 and < 2^24 after
    # the cast; the coarse i // P term keeps distant segments distinct.
    ii = jnp.arange(f.shape[0], dtype=jnp.int32)
    lo = (ii % 7919).astype(jnp.float32)
    hi = (ii // 7919).astype(jnp.float32)
    s1 = jnp.dot(f, jnp.cos(lo * 1.7e-3 + hi * 0.61))
    s2 = jnp.dot(f * f, jnp.cos(lo * 0.9e-3 + hi * 1.13 + 1.0))
    return jnp.stack([s1, s2])


def fingerprint_hex(fp) -> str:
    """Host-side: (2,) f32 fingerprint -> stable 16-char hex string."""
    import struct

    a, b = (float(v) for v in np.asarray(fp))
    return struct.pack("<ff", a, b).hex()
