"""Closed-form subcarrier NCO (SURVEY.md K1) — the central design decision.

The reference accumulates subcarrier phase sequentially while looping over
scanlines (SURVEY.md §3.1).  That serial dependency is what forces per-line
processing; removing it is what makes the whole pipeline vmappable and
shardable.  Here the phase is a **closed-form function of the absolute line
index**:

    phi[g, n] = phi0(g) + ramp[n]
    phi0(g)   = 2*pi * frac(cpl * g)          (line-start phase)
    ramp[n]   = 2*pi * frac(fsc/fs * n)       (within-line ramp)

``cpl = fsc/fh`` is stored as an exact rational ``cpl_num/cpl_den``
(standards/base.py), so ``frac(cpl*g)`` is computed with int32 modular
arithmetic — exact for any 32-bit line index, where float32 would lose the
phase after ~1e5 lines and the device path computes in float32.  The
within-line ramp is a host-precomputed float64->float32 constant.

Because phi0 depends only on the absolute index, line blocks are phase-
independent: a device that owns lines [k, k+B) needs no sequential state from
its neighbors — only the comb/delay-line stencil halos (SURVEY.md §5.7).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

TWO_PI = 2.0 * np.pi


def line_phase0(cpl_num: int, cpl_den: int, gline: jax.Array) -> jax.Array:
    """Line-start subcarrier phase, radians, for absolute line index array.

    Exact int32 modular arithmetic: with den <= ~46000 the intermediate
    product (num % den) * (gline % den) stays below 2^31.  All broadcast,
    no scan.
    """
    num_mod = int(cpl_num) % int(cpl_den)
    g_mod = jnp.mod(gline.astype(jnp.int32), np.int32(cpl_den))
    r = jnp.mod(np.int32(num_mod) * g_mod, np.int32(cpl_den))
    return (TWO_PI / cpl_den) * r.astype(jnp.float32)


def sample_phase_ramp(fsc: float, fs: float, n_samples: int) -> np.ndarray:
    """Within-line phase ramp 2*pi*frac(fsc/fs * n) — float64 host constant.

    The golden oracle consumes it as float64; the JAX pipeline casts to
    float32 on capture (the frac() keeps the cast loss at ~1e-7 rad).
    """
    n = np.arange(n_samples, dtype=np.float64)
    frac = np.mod(fsc / fs * n, 1.0)
    return TWO_PI * frac


def global_line_index(
    frame0: int | jax.Array, n_frames: int, n_lines: int, total_lines: int
) -> jax.Array:
    """Absolute line index g[b, l] = (frame0 + b) * total_lines + l.

    Image row l maps directly to line l of the frame (progressive
    simplification; the reference's `(frame, line)` arguments play the same
    role — SURVEY.md §1 L2).
    """
    b = jnp.arange(n_frames, dtype=jnp.int32) + jnp.asarray(frame0, jnp.int32)
    l = jnp.arange(n_lines, dtype=jnp.int32)
    return b[:, None] * np.int32(total_lines) + l[None, :]
