"""VIR — the NTSC line-19 Vertical Interval Reference (EIA-516 shape).

US broadcasters inserted a reference line carrying a chrominance reference
*riding on a 70-IRE luminance pedestal*, a 50-IRE luminance reference, and
a black reference.  Receivers with VIR circuits (the "broadcast-controlled
color" sets of the late 1970s) measured the chroma reference's amplitude
and phase against spec and corrected the whole picture's saturation and
hue from it.

Reference parity: beyond-reference (the upstream library has no VBI
services; SURVEY.md §2.1, mount empty §0.1).  This joins the receiver's
other correction loops — burst lock / ACC / color killer key on the
*burst at blanking level*; VIR keys on a reference at PICTURE level, which
is the whole point: a luma-tracking (differential) gain/phase error is
invisible at blanking but fully expressed on the 70-IRE pedestal, so the
VIR measurement captures what the burst physically cannot (the classic
"burst is not where the picture lives" argument for VIR).

Array formulation: the reference line is a closed-form waveform on
the NCO phase law (one array expression), and the measurement is two
masked projections of the chroma segment onto sin/cos of the same phase —
no PLL, no state; corrections feed :func:`frame.pipeline.decode_block`'s
existing ``phase_err`` / ``chroma_gain`` per-line hooks.

Line layout (fractions of the active line; the real line 19 is specified
in microseconds against front porch — proportions preserved):

* [0.10, 0.50): chroma reference — subcarrier at ``CHROMA_AMP`` on the
  +U (sin) axis over a ``PEDESTAL_LUMA`` pedestal
* [0.50, 0.75): luminance reference ``LUMA_REF``
* [0.75, 0.95): black reference ``BLACK_REF``
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.modem.qam import carrier_phase
from color_modem_tpu.standards.base import QamParams

#: composite units (1.0 = 100 IRE, no setup)
PEDESTAL_LUMA = 0.70
CHROMA_AMP = 0.20  # 40 IRE peak-to-peak
LUMA_REF = 0.50
BLACK_REF = 0.075

_SEGS = ((0.10, 0.50), (0.50, 0.75), (0.75, 0.95))


def _check(plan: ModemPlan) -> QamParams:
    p = plan.cfg.chroma
    if not isinstance(p, QamParams):
        raise ValueError(f"VIR needs a QAM subcarrier; {plan.cfg.name} is FM")
    return p


def _masks(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    idx = np.arange(n)
    out = []
    for lo, hi in _SEGS:
        # trim 8 samples off each edge so FIR/channel transients at the
        # segment steps never enter a measurement window
        a, b = int(lo * n) + 8, int(hi * n) - 8
        out.append(((idx >= a) & (idx < b)).astype(np.float32))
    return tuple(out)  # chroma, luma-ref, black


def vir_lines(plan: ModemPlan, gline: jax.Array) -> jax.Array:
    """(..., L) absolute line indices -> (..., L, N) VIR reference lines."""
    _check(plan)
    n = plan.n_samples
    m_ch, m_lu, m_bk = _masks(n)
    phi = carrier_phase(plan, gline)
    base = (
        jnp.asarray(PEDESTAL_LUMA * m_ch + LUMA_REF * m_lu + BLACK_REF * m_bk)
    )
    return base + jnp.asarray(m_ch) * jnp.float32(CHROMA_AMP) * jnp.sin(phi)


def measure_vir(plan: ModemPlan, vir: jax.Array, gline: jax.Array) -> dict:
    """Measure received VIR rows (..., L, N) against spec.

    Returns traced scalars (averaged over all VIR rows given):

    * ``chroma_gain_corr`` — spec-over-measured reference amplitude (the
      multiplicative chroma correction, ACC-style)
    * ``phase_err`` — measured phase error in radians at picture level
      (feed to ``decode_block(phase_err=...)``)
    * ``luma_ref`` / ``black_ref`` — measured pedestal levels
    """
    _check(plan)
    vir = vir.astype(jnp.float32)
    n = vir.shape[-1]
    m_ch, m_lu, m_bk = (jnp.asarray(m) for m in _masks(n))
    phi = carrier_phase(plan, gline)
    w = m_ch / jnp.sum(m_ch)
    # projections: sin carries the reference, cos reads the quadrature
    # leak; the pedestal is DC and integrates out of both
    i = 2.0 * jnp.sum(w * vir * jnp.sin(phi), axis=(-2, -1)) / vir.shape[-2]
    q = 2.0 * jnp.sum(w * vir * jnp.cos(phi), axis=(-2, -1)) / vir.shape[-2]
    amp = jnp.sqrt(i * i + q * q)
    return {
        # same [1/4, 4]x control range as the ACC loop (frame/raster.py)
        "chroma_gain_corr": jnp.clip(
            jnp.float32(CHROMA_AMP)
            / jnp.maximum(amp, 0.05 * CHROMA_AMP),
            0.25,
            4.0,
        ),
        "phase_err": jnp.arctan2(q, i),
        "luma_ref": jnp.sum(m_lu * vir, axis=(-2, -1))
        / (jnp.sum(m_lu) * vir.shape[-2]),
        "black_ref": jnp.sum(m_bk * vir, axis=(-2, -1))
        / (jnp.sum(m_bk) * vir.shape[-2]),
    }


def decode_vir_corrected(
    plan: ModemPlan,
    comp: jax.Array,
    gline: jax.Array,
    n_vir: int,
    decoder: str = "notch",
) -> jax.Array:
    """Decode a composite whose FIRST ``n_vir`` rows are VIR lines.

    Measures the references, then decodes the remaining picture rows with
    the measured phase/gain corrections broadcast to every line.  Returns
    the picture RGB (rows ``n_vir:``).
    """
    from color_modem_tpu.frame.pipeline import decode_block

    rep = measure_vir(plan, comp[..., :n_vir, :], gline[..., :n_vir])
    g_pic = gline[..., n_vir:]
    ones = jnp.ones(g_pic.shape, jnp.float32)
    return decode_block(
        plan,
        comp[..., n_vir:, :],
        g_pic,
        decoder,
        phase_err=rep["phase_err"][..., None] * ones,
        chroma_gain=rep["chroma_gain_corr"][..., None] * ones,
    )
