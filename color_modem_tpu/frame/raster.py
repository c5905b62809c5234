"""Horizontal raster structure: sync pulses and color burst (SURVEY.md A.1).

The reference operates on active-line samples only and "likely omits or
simplifies" sync/burst [SURVEY.md A.1, MEM-L]; per the same note the rebuild
makes them **optional, default off, flag-gated**: ``make_pipeline(...,
raster=True)`` / CLI ``--raster``.

A rastered line is ``[blanking | active]`` where the blanking interval holds
the front porch, the sync pulse, and (QAM standards) the color burst:

    NTSC 525:  total 858 samples @ 13.5 MHz (fs/fh), blanking 138
    PAL/SECAM 625: total 864, blanking 144

Timings are the BT.470/BT.1700 analog values mapped to the sample grid.
The burst rides the same closed-form NCO phase law as the active chroma —
line-start-relative sample ``m`` has phase ``phi0(line) + k*(m - blank)`` —
so a burst-locked decoder sees a phase-consistent reference:

    NTSC:  9 cycles at 180 deg on the U axis (burst = -U)       [A.2]
    PAL:  10 cycles swinging +-135 deg with the V-switch        [A.3]
    SECAM: sync only — SECAM identifies lines by FM, not burst  [A.4]

``measure_burst_phase`` quadrature-correlates the burst window against the
NCO reference: the returned per-line (amplitude, phase) is the hook for
burst-locked demodulation and for channel diagnostics (a static phase error
shows up directly; tests/test_raster.py asserts the spec angles).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp.nco import TWO_PI, line_phase0
from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.standards.base import QamParams

#: Analog blanking-interval timings in seconds: (front porch, sync width,
#: burst start after the leading sync edge, burst cycles).  BT.1700 values.
_TIMING_525 = (1.5e-6, 4.7e-6, 5.3e-6, 9)
_TIMING_625 = (1.65e-6, 4.7e-6, 5.6e-6, 10)

SYNC_LEVEL = -0.4   # sync tip, blanking = 0, white = 1 (100/40 IRE ratio)
BURST_AMP = 0.15    # burst envelope amplitude around blanking level


@dataclasses.dataclass(frozen=True)
class RasterPlan:
    """Sample-grid raster geometry for one (standard, line width) pair."""

    n_active: int
    n_total: int
    sync_start: int      # line-start-relative sample indices
    sync_len: int
    burst_start: int
    burst_len: int       # 0 = no burst (SECAM)
    burst_phase: float   # burst angle on the (un-rotated) U axis, rad
    swinging: bool       # PAL: burst angle sign follows the V-switch

    @property
    def n_blank(self) -> int:
        return self.n_total - self.n_active


def make_raster(plan: ModemPlan) -> RasterPlan:
    cfg = plan.cfg
    fs = plan.fs
    n_total = int(round(fs / cfg.fh))
    front, sync_w, burst_t0, burst_cycles = (
        _TIMING_525 if cfg.total_lines == 525 else _TIMING_625
    )
    sync_start = int(round(front * fs))
    sync_len = int(round(sync_w * fs))
    if isinstance(cfg.chroma, QamParams):
        fsc = cfg.chroma.fsc
        burst_start = sync_start + int(round(burst_t0 * fs))
        burst_len = int(round(burst_cycles / fsc * fs))
        swinging = cfg.chroma.v_switch
        burst_phase = 0.75 * np.pi if swinging else np.pi  # PAL 135 / NTSC 180
    else:
        burst_start, burst_len, burst_phase, swinging = 0, 0, 0.0, False
    n_blank = n_total - plan.n_samples
    if burst_start + burst_len > n_blank:
        raise ValueError(
            f"{cfg.name}: burst does not fit the {n_blank}-sample blanking "
            f"interval at fs={fs/1e6:.2f} MHz"
        )
    return RasterPlan(
        n_active=plan.n_samples,
        n_total=n_total,
        sync_start=sync_start,
        sync_len=sync_len,
        burst_start=burst_start,
        burst_len=burst_len,
        burst_phase=float(burst_phase),
        swinging=swinging,
    )


def _burst_sign(plan: ModemPlan, rp: RasterPlan, gline: jax.Array) -> jax.Array:
    """Per-line burst angle sign: PAL swings with the V-switch parity
    (delegates to the modem's v_sign so the convention has ONE home)."""
    if not rp.swinging:
        return jnp.ones(gline.shape, jnp.float32)
    from color_modem_tpu.modem.qam import v_sign

    return v_sign(plan, gline)


def _blank_phase(plan: ModemPlan, rp: RasterPlan, gline: jax.Array):
    """(..., L, n_blank) NCO phase over the blanking interval.

    Same phase law as the active region: blanking sample ``m`` sits at
    active-relative index ``m - n_blank`` (i.e. just before active sample 0).
    """
    k = TWO_PI * plan.cfg.chroma.fsc / plan.fs
    m = np.arange(rp.n_blank, dtype=np.float64) - rp.n_blank
    # split into f32-safe pieces: per-line start phase (exact int32 rational
    # arithmetic) + small within-blanking ramp
    ramp = (k * m) % (2.0 * np.pi)
    phi0 = line_phase0(plan.cfg.cpl_num, plan.cfg.cpl_den, gline)
    return phi0[..., None] + jnp.asarray(ramp, jnp.float32)


def add_raster(plan: ModemPlan, rp: RasterPlan, comp: jax.Array,
               gline: jax.Array) -> jax.Array:
    """(..., L, n_active) active composite -> (..., L, n_total) rastered."""
    idx = np.arange(rp.n_blank)
    sync_mask = ((idx >= rp.sync_start) & (idx < rp.sync_start + rp.sync_len))
    blank = jnp.where(jnp.asarray(sync_mask), jnp.float32(SYNC_LEVEL), 0.0)
    blank = jnp.broadcast_to(blank, comp.shape[:-1] + (rp.n_blank,))
    if rp.burst_len:
        burst_mask = (idx >= rp.burst_start) & (idx < rp.burst_start + rp.burst_len)
        phi = _blank_phase(plan, rp, gline)
        sgn = _burst_sign(plan, rp, gline)[..., None]
        burst = jnp.float32(BURST_AMP) * jnp.sin(
            phi + sgn * jnp.float32(rp.burst_phase)
        )
        blank = blank + jnp.where(jnp.asarray(burst_mask), burst, 0.0)
    return jnp.concatenate([blank, comp.astype(jnp.float32)], axis=-1)


def strip_raster(rp: RasterPlan, rastered: jax.Array) -> jax.Array:
    """(..., L, n_total) -> (..., L, n_active): drop the blanking interval."""
    if rastered.shape[-1] != rp.n_total:
        raise ValueError(
            f"expected {rp.n_total}-sample rastered lines, got "
            f"{rastered.shape[-1]} — was this composite encoded with "
            "raster=True?"
        )
    return rastered[..., rp.n_blank:]


def decode_burst_locked(plan: ModemPlan, rp: RasterPlan, rastered: jax.Array,
                        gline: jax.Array, decoder: str = "notch",
                        acc: bool = False,
                        color_kill: float = 0.0) -> jax.Array:
    """Decode a rastered block using the burst-measured subcarrier phase.

    The per-line channel phase error is the measured burst angle minus the
    spec angle (NTSC 180 deg, PAL +-135 deg per V-switch); the decoder
    counter-rotates the demodulated chroma by it — so a differential-phase
    channel impairment (frame/channel.py) that visibly shifts NTSC hue under
    nominal-phase decoding is cancelled, like a real burst-locked TV.
    (QAM standards only: SECAM has no burst and is phase-immune anyway.)

    ``acc``: automatic chroma control — the gain twin of the phase lock:
    scale the demodulated chroma by spec-over-measured burst amplitude
    (clipped to [1/4, 4]x — a real ACC's control range), so a chroma-band
    channel gain error (frame/channel.py ``chroma_gain``, which scales
    the burst identically — that co-riding is WHY ACC works) decodes at
    correct saturation.

    ``color_kill``: color-killer threshold as a fraction of the spec
    burst amplitude — lines whose measured burst falls below it decode
    with chroma gain 0.  The receiver circuit that keeps monochrome
    transmissions (no burst) from showing cross-color "confetti": the
    demodulator output on a burstless line is pure luma-detail leakage,
    and killing it yields clean B/W.  Typical setting 0.3–0.5.
    """
    from color_modem_tpu.frame.pipeline import decode_block

    amp, phase = measure_burst_phase(plan, rp, rastered, gline)
    expected = _burst_sign(plan, rp, gline) * jnp.float32(rp.burst_phase)
    delta = phase - expected
    # wrap to (-pi, pi] so a 180-deg-adjacent measurement doesn't unwrap
    delta = jnp.arctan2(jnp.sin(delta), jnp.cos(delta))
    cg = None
    ref = jnp.float32(BURST_AMP)
    if acc:
        cg = jnp.clip(ref / jnp.maximum(amp, 0.05 * ref), 0.25, 4.0)
    if color_kill > 0.0:
        base = cg if cg is not None else jnp.ones_like(amp)
        cg = jnp.where(amp < jnp.float32(color_kill) * ref, 0.0, base)
    comp = strip_raster(rp, rastered)
    return decode_block(plan, comp, gline, decoder,
                        phase_err=delta, chroma_gain=cg)


def identify_vswitch(plan: ModemPlan, rp: RasterPlan, rastered: jax.Array,
                     gline: jax.Array) -> jax.Array:
    """PAL ident: recover the V-switch parity from the swinging burst.

    A real PAL receiver cannot trust its line counter for the V-switch
    flip-flop any more than a SECAM set can for Dr/Db (modem/secam.py's
    ``identify_parity``) — it derives the ident from the burst, whose
    angle swings +-45 deg around 180 deg WITH the V-switch.  The detector
    here is the coherence test that swing affords: under the correct
    parity hypothesis the per-line residual ``measured - v_sign*135deg``
    is one constant (any static channel phase error, and — because the
    NCO phase law is linear in the line index — any k-line counter slip,
    only rotate ALL lines equally); under the flipped hypothesis it
    alternates by 180 deg line-to-line and its mean resultant collapses.

    Returns int32 slip per frame (``gline.shape[:-1]``): 0 = the assumed
    counter parity is right, 1 = decode with ``gline + 1``.  Only parity
    (odd vs even slip) is identifiable — and only parity matters, because
    the burst lock measures and cancels the per-line phase residual of
    any even slip exactly.
    """
    if not rp.swinging:
        raise ValueError(
            f"{plan.cfg.name} has no swinging burst — V-switch "
            "identification is a PAL-family feature"
        )
    _, phase = measure_burst_phase(plan, rp, rastered, gline)
    expected = _burst_sign(plan, rp, gline) * jnp.float32(rp.burst_phase)

    def coherence(exp):
        e = phase - exp
        return jnp.hypot(jnp.mean(jnp.cos(e), axis=-1),
                         jnp.mean(jnp.sin(e), axis=-1))

    return (coherence(-expected) > coherence(expected)).astype(jnp.int32)


def decode_identified(plan: ModemPlan, rp: RasterPlan, rastered: jax.Array,
                      gline: jax.Array, decoder: str = "notch"):
    """Burst-locked decode WITHOUT trusting the line counter's parity.

    The receiver loop of a real PAL set: the ident (from the swinging
    burst) sets the V-switch flip-flop, then the burst lock cancels the
    per-line subcarrier phase residual — so the output is correct for an
    arbitrarily slipped line counter.  Returns ``(rgb, slip)``.
    """
    slip = identify_vswitch(plan, rp, rastered, gline)
    g = gline + slip[..., None]
    return decode_burst_locked(plan, rp, rastered, g, decoder), slip


def measure_burst_phase(plan: ModemPlan, rp: RasterPlan, rastered: jax.Array,
                        gline: jax.Array):
    """Quadrature-correlate the burst window -> per-line (amplitude, phase).

    ``phase`` is the burst angle on the U axis (rad, in (-pi, pi]); for an
    undistorted signal it equals ``+-rp.burst_phase`` (sign per V-switch).
    A channel phase error adds directly — this is the burst-lock hook.
    """
    if not rp.burst_len:
        raise ValueError(f"{plan.cfg.name} has no color burst")
    win = rastered[..., rp.burst_start : rp.burst_start + rp.burst_len]
    phi = _blank_phase(plan, rp, gline)[
        ..., rp.burst_start : rp.burst_start + rp.burst_len
    ]
    i = jnp.mean(2.0 * win * jnp.sin(phi), axis=-1)
    q = jnp.mean(2.0 * win * jnp.cos(phi), axis=-1)
    return jnp.hypot(i, q), jnp.arctan2(q, i)
