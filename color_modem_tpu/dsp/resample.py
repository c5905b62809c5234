"""Horizontal resampling: image width <-> composite sample grid (K12, C7).

The reference's image layer "possibly handles horizontal resampling between
image width and composite sample rate" [SURVEY.md C7, MEM-L]; here it is a
first-class on-device op so a W-pixel image row can feed an N-sample line
(and back) without a host/PIL round trip.

Consistent with dsp/apply.py, resampling is a linear map, so it is a
host-designed ``(W, N)`` windowed-sinc matrix applied as one matmul.  Anti-aliasing for decimation is built into the same
matrix (sinc cutoff at the lower of the two rates), so down-then-up at any
ratio is band-limited-exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Design lives in the JAX-free dsp.design so the golden oracle (which may
# not import JAX) can share the exact same matrix; re-exported here because
# this is the module every resampling caller already imports it from.
from color_modem_tpu.dsp.design import resample_matrix  # noqa: F401


def resample_width(x: jax.Array, n_out: int, taps_per_output: int = 17) -> jax.Array:
    """Resample the last (sample) axis of ``x`` to ``n_out`` points.

    One matmul per call at full float32 (``HIGHEST``): the resample runs
    off the timed hot path (image loading, MAC, PALplus, standards
    conversion), so it takes the exact product rather than the card's
    default TF32 (~1e-3 relative).  Matches the float64 matrix product to
    1e-5 (tests/test_resample.py).
    """
    n_in = x.shape[-1]
    if n_in == n_out:
        return x
    mat = jnp.asarray(resample_matrix(n_in, n_out, taps_per_output))
    return jnp.matmul(
        x.astype(jnp.float32), mat, precision=lax.Precision.HIGHEST
    )
