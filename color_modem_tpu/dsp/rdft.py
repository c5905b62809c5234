"""Real DFT as matmuls — the spectral path for short non-pow2 lengths.

The short per-line transforms this framework needs (blanking intervals
~140, raster lines ~860, GCR periods ~1440) have non-smooth lengths; an
``(..., n) @ (n, n//2+1)`` cos/sin matmul is a few hundred KB of
config-time data and one dense product per transform.  Whether ``jnp.fft``
(cuFFT) is as fast at these lengths is an open ROADMAP question.  Large
power-of-two stream FFTs (the ghost equalizer's 4M-point apply) use
``jnp.fft``.

Conventions match ``np.fft.rfft``: ``re + 1j*im == rfft(x)``; synthesis
``irdft`` matches ``np.fft.irfft(..., n=n)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


@lru_cache(maxsize=32)
def dft_bases(n: int):
    """Host-built rDFT bases for length ``n``: ``(C, S, w)`` with
    ``C[m,k]=cos(2pi mk/n)``, ``S[m,k]=-sin(2pi mk/n)`` (so ``x@C, x@S``
    are the rfft's real/imag parts) and ``w`` the synthesis weights that
    double the two-sided interior bins."""
    nb = n // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(nb)) / n
    C = np.cos(ang)
    S = -np.sin(ang)
    w = np.full(nb, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    return (
        np.ascontiguousarray(C, dtype=np.float32),
        np.ascontiguousarray(S, dtype=np.float32),
        w.astype(np.float32),
    )


def rdft(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(..., n) real -> (re, im), each (..., n//2+1).

    Full float32 (``HIGHEST``): the GPU's default TF32 left the TBC output
    4e-3 off the CPU's, and 3-pass bf16 still left the GCR equalizer
    (whose ridge inverse amplifies the spectrum's error) 1.3e-3 off; at
    HIGHEST both read <= 1.5e-5 on an NVIDIA H100 (400 W limit,
    chip_smoke parity phase).  The matrices are small, so the cost is
    negligible.
    """
    C, S, _ = (jnp.asarray(a) for a in dft_bases(x.shape[-1]))
    xf = x.astype(jnp.float32)
    p = lax.Precision.HIGHEST
    return jnp.matmul(xf, C, precision=p), jnp.matmul(xf, S, precision=p)


def irdft(re: jax.Array, im: jax.Array, n: int) -> jax.Array:
    """Inverse of :func:`rdft`: (re, im) (..., n//2+1) -> (..., n) real."""
    C, S, w = (jnp.asarray(a) for a in dft_bases(n))
    p = lax.Precision.HIGHEST
    out = jnp.matmul(w * re, C.T, precision=p) + jnp.matmul(
        w * im, S.T, precision=p
    )
    return out * jnp.float32(1.0 / n)
