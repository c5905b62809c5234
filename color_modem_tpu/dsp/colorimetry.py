"""Colorimetry matrix application (SURVEY.md K11).

RGB <-> (Y, C1, C2) conversions are 3x3 matmuls applied with the channel axis
third-from-last: arrays are ``(..., 3, L, N)`` so the sample axis stays
the contiguous minor axis and the contraction is a tiny einsum over the
channel axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def apply_mat3(mat, x: jax.Array) -> jax.Array:
    """``y[..., d, l, n] = sum_c mat[d, c] * x[..., c, l, n]``."""
    m = jnp.asarray(mat, dtype=x.dtype)
    # HIGHEST: full float32.  A default-precision dot may run on a
    # reduced-precision matrix unit (TF32 on the GPU, ~1e-3 relative),
    # which would put that error into every pixel.
    return jnp.einsum("dc,...cln->...dln", m, x, precision=lax.Precision.HIGHEST)


def clamp01(x: jax.Array) -> jax.Array:
    return jnp.clip(x, 0.0, 1.0)
