"""NIIR / "SECAM IV" reference-line normalization (SURVEY.md A.5, K10).

Even absolute lines carry QAM chroma; odd lines carry an unmodulated
reference carrier (modem/qam.py injects it at encode).  The decoder measures
each line's complex demod output z = c1 + j*c2; for a chroma line this is the
(U, V) pair, for a reference line it is the channel's response to a known
(A_ref, 0) — so dividing the chroma measurement by the reference measurement
(times A_ref) cancels differential gain and phase.

Implemented with real-pair arithmetic (no complex dtype).  The neighbor shift is the usual 1-line stencil.
Exact upstream constants are unavailable (empty reference mount, SURVEY.md
§0); this follows the A.5 description.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.separate.stencil import prev_reflect
from color_modem_tpu.standards.base import QamParams


def is_chroma_line(gline: jax.Array) -> jax.Array:
    return (gline % 2) == 0


def normalize(plan: ModemPlan, c1: jax.Array, c2: jax.Array, gline: jax.Array):
    """(..., L, N) demodulated (c1, c2) -> gain/phase-normalized chroma."""
    p: QamParams = plan.cfg.chroma
    a_ref = jnp.float32(p.reference_amplitude)
    chroma = is_chroma_line(gline)[..., None]
    o1, o2 = prev_reflect(c1, 1), prev_reflect(c2, 1)
    # route this line's and the neighbor's measurements to (chroma, reference)
    zc1 = jnp.where(chroma, c1, o1)
    zc2 = jnp.where(chroma, c2, o2)
    zr1 = jnp.where(chroma, o1, c1)
    zr2 = jnp.where(chroma, o2, c2)
    # guard: a vanishing reference measurement falls back to the nominal
    # (A_ref, 0), i.e. no correction — matches golden._niir_normalize
    weak = (zr1 * zr1 + zr2 * zr2) < jnp.float32(1e-12)
    zr1 = jnp.where(weak, a_ref, zr1)
    zr2 = jnp.where(weak, 0.0, zr2)
    den = zr1 * zr1 + zr2 * zr2
    # corrected = zc * A_ref / zr  =  A_ref * zc * conj(zr) / |zr|^2
    u = a_ref * (zc1 * zr1 + zc2 * zr2) / den
    v = a_ref * (zc2 * zr1 - zc1 * zr2) / den
    return u, v
