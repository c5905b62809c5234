"""Time-base error: per-line horizontal jitter and its correction (TBC).

Tape playback (and any free-running oscillator chain) shifts each line's
start by a slowly varying fraction of a microsecond — on screen: wobbling
verticals, the bent top-of-field "flag" — and, for QAM standards, hue noise
once the decoder's carrier no longer lines up.  Studios fight it with a
time-base corrector: measure each line's sync-edge arrival against where it
should be, then resample the line back.

Both halves live here, on the rastered signal (frame/raster.py), which is
what carries the sync edge a real TBC locks to:

* :func:`impair_timebase` — per-line fractional-sample shifts: a vertical
  wobble sine + exponential top flagging + optional random line jitter.
* :func:`measure_line_shift` — per-line delay estimate from the blanking
  interval: cross-spectrum against the exact nominal sync+burst template
  (synthesized by the raster layer for these very line indices), delay
  read off as the angle of the adjacent-bin phase product — no unwrap,
  unambiguous to half the blanking width, ~1e-3-sample accuracy (a
  half-amplitude edge slicer was tried first: the sinc ringing of the
  band-limited rectangular edge biases it ~0.1 sample, a 13 deg NTSC hue
  error).
* :func:`tbc_correct` — shift every line back by its measured error.

Shifts are applied as spectral phase ramps (circular; the wrapped samples
land in the far end of the blanking interval, away from sync, burst, and
active video for the few-sample shifts that are physical here).  The
spectra come from real-valued DFT matmuls (``dsp.rdft``), not ``jnp.fft``
— see that module for why (short non-pow2 lengths).  No complex dtype appears anywhere in this module.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp.rdft import irdft, rdft
from color_modem_tpu.frame.raster import RasterPlan, add_raster
from color_modem_tpu.modem.plan import ModemPlan


def fractional_shift(x: jax.Array, delta: jax.Array) -> jax.Array:
    """Shift each line right by ``delta`` samples (fractional, circular).

    ``x``: (..., L, N); ``delta``: (..., L).  Spectral phase ramp — exact
    for band-limited content, sinc-interpolating otherwise.
    """
    n = x.shape[-1]
    xr, xi = rdft(x)
    theta = (
        (2.0 * np.pi / n)
        * jnp.arange(n // 2 + 1, dtype=jnp.float32)
        * delta[..., None].astype(jnp.float32)
    )
    ct, st = jnp.cos(theta), jnp.sin(theta)
    # X' = X * (cos - i sin)(theta)
    return irdft(xr * ct + xi * st, xi * ct - xr * st, n).astype(x.dtype)


def timebase_profile(
    plan: ModemPlan,
    n_lines: int,
    *,
    wobble_us: float = 0.3,
    wobble_cycles: float = 2.5,
    flagging_us: float = 0.0,
    jitter_us: float = 0.0,
    key: jax.Array | None = None,
) -> jax.Array:
    """(L,) per-line shift in SAMPLES: wobble sine + top flagging + jitter.

    ``flagging_us`` bends the top of the field (the VHS head-switch flag:
    exponential decay over the first ~8% of lines).  ``jitter_us`` adds
    white per-line noise (needs ``key``).
    """
    l = jnp.arange(n_lines, dtype=jnp.float32)
    per_us = jnp.float32(plan.fs * 1e-6)
    delta = wobble_us * per_us * jnp.sin(
        2.0 * jnp.pi * wobble_cycles * l / jnp.float32(n_lines)
    )
    if flagging_us != 0.0:
        delta = delta + flagging_us * per_us * jnp.exp(
            -l / jnp.float32(max(1.0, 0.08 * n_lines))
        )
    if jitter_us != 0.0:
        if key is None:
            raise ValueError("jitter_us > 0 requires a PRNG key")
        delta = delta + jitter_us * per_us * jax.random.normal(
            key, (n_lines,), jnp.float32
        )
    return delta


def impair_timebase(
    plan: ModemPlan, rastered: jax.Array, **profile_kwargs
) -> tuple[jax.Array, jax.Array]:
    """Apply a time-base error to a (..., L, n_total) rastered block.

    Returns ``(shifted, delta)`` — the per-line true shifts in samples, so
    tests (and curious users) can compare against the TBC's estimate.
    """
    delta = timebase_profile(plan, rastered.shape[-2], **profile_kwargs)
    delta = jnp.broadcast_to(delta, rastered.shape[:-1])
    return fractional_shift(rastered, delta), delta


def measure_line_shift(
    plan: ModemPlan, rp: RasterPlan, rastered: jax.Array, gline: jax.Array,
    max_shift: int | None = None,
) -> jax.Array:
    """(..., L) per-line time-base error from the blanking interval.

    Cross-spectrum ``C_k = R_k T_k*`` between the received blanking and the
    nominal per-line template (zeros for active video, sync + this line's
    burst phase from the raster layer).  A pure delay makes
    ``angle(C_k) = -2 pi k d / nb``, so the energy-weighted adjacent-bin
    product ``sum_k C_k C_{k+1}*`` has angle ``2 pi d / nb`` — delay
    without phase unwrap, unambiguous for ``|d| < nb/2``.

    The first and last ``max_shift`` samples of the window are zeroed
    before the FFT: the circular line shift wraps ACTIVE video into those
    guard regions (bright broadband content that biased the raw estimate
    ~35%, measured), while the template is silent there by construction
    (front porch / post-burst dead zone) — so the guard removes the
    contamination at no information cost for shifts within ``max_shift``
    (default: :func:`correctable_reach`).
    """
    if max_shift is None:
        max_shift = correctable_reach(rp)
    if max_shift >= rp.sync_start:
        raise ValueError(
            f"max_shift {max_shift} exceeds the {rp.sync_start}-sample "
            "front porch (the guard would eat the sync edge)"
        )
    nb = rp.n_blank
    zeros = jnp.zeros(rastered.shape[:-1] + (rp.n_active,), jnp.float32)
    tmpl = add_raster(plan, rp, zeros, gline)[..., :nb]
    recv = rastered[..., :nb].astype(jnp.float32)
    guard = np.ones(nb, np.float32)
    guard[:max_shift] = 0.0
    guard[nb - max_shift:] = 0.0
    recv = recv * jnp.asarray(guard)
    tmpl = tmpl * jnp.asarray(guard)
    rr, ri = rdft(recv)
    tr, ti = rdft(tmpl)
    # cross-spectrum C = R T*
    cr = rr * tr + ri * ti
    ci = ri * tr - rr * ti
    # adjacent-bin product  P = sum_k C_k C_{k+1}*
    pr = jnp.sum(cr[..., :-1] * cr[..., 1:] + ci[..., :-1] * ci[..., 1:],
                 axis=-1)
    pi = jnp.sum(ci[..., :-1] * cr[..., 1:] - cr[..., :-1] * ci[..., 1:],
                 axis=-1)
    return jnp.float32(nb / (2.0 * np.pi)) * jnp.arctan2(pi, pr)


def tbc_correct(
    plan: ModemPlan, rp: RasterPlan, rastered: jax.Array, gline: jax.Array,
    max_shift: int | None = None,
) -> jax.Array:
    """Time-base-correct a rastered block: measure each line's sync/burst
    timing error and shift the line back.  Fully on-device and jittable.

    Shifts beyond ``max_shift`` (default :func:`correctable_reach`) are
    silently mis-estimated — callers knowing the expected error should
    refuse up front when it exceeds the reach (the CLI does)."""
    return fractional_shift(
        rastered, -measure_line_shift(plan, rp, rastered, gline, max_shift)
    )


def correctable_reach(rp: RasterPlan) -> int:
    """Largest shift this single-line estimator can honestly correct.

    Two geometric limits (measured: sizing the window beyond them makes
    the estimate WORSE, not better): an early line pushes the sync edge
    into the front guard (``sync_start - max_shift >= max_shift``, i.e.
    ``sync_start // 2``), and a late line pushes the burst (or sync) tail
    past the blanking window's end.  NTSC at 13.5 MHz: ~10 samples
    (~0.74 us).  Real TBCs reach further by tracking line-to-line with a
    PLL (state the single-line design deliberately avoids).
    """
    used_end = (
        rp.burst_start + rp.burst_len if rp.burst_len
        else rp.sync_start + rp.sync_len
    )
    return max(1, min(rp.sync_start // 2, rp.n_blank - used_end))
