"""MTS/BTSC-style stereo sound multiplexing (beyond-reference).

Broadcast stereo TV sound (FCC MTS / BTSC, simplified: no dbx companding,
no SAP) multiplexes a stereo pair into ONE baseband that rides the
existing intercarrier FM sound channel (frame/rf.py):

    a(t) = (L+R)/2  +  P * sin(2*pi*fh*t)  +  (L-R)/2 * 2*cos(2*pi*2fh*t)

The pilot sits exactly at the line frequency fh and the difference
channel is DSB suppressed-carrier at 2*fh — both phase-locked to the
raster, which is the BTSC design (the pilot IS fh).  On this sample grid
that makes every carrier closed-form and EXACT: fh is one cycle per
N-sample row, so the phase is ``2*pi*(t mod N)/N`` in int arithmetic —
no oscillator state, the same NCO philosophy as dsp/nco.py.

The decoder needs no PLL for the same reason: fh is known exactly, so
the difference channel demodulates coherently against ``cos(2*ph)``.
(A real receiver locks to the transmitted pilot; here transmitter and
receiver share the raster clock by construction.  The pilot is still
transmitted and measurable — ``pilot_level`` — so a stereo/mono decision
works the authentic way.)

Band plan at the composite rate: sum 0-13.5 kHz, pilot fh = 15.734 kHz
(525/30M) sitting in the sum filter's stopband, difference sidebands
2fh +- 13.5 kHz.  The steep 16385-tap lowpass (transition ~3 kHz at
13.5 MHz) is what keeps the pilot out of the sum channel — a 2049-tap
design would smear 26 kHz of transition across the whole band plan.
Total baseband reaches ~45 kHz, so carry it with
``make_rf_plan(..., audio_bw=50e3)``.
"""

from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from color_modem_tpu.dsp import design
from color_modem_tpu.dsp.apply import fir_same_fft
from color_modem_tpu.modem.plan import ModemPlan

#: pilot amplitude (BTSC: 5 kHz deviation of a 25 kHz channel = 0.2 of
#: full scale; kept small here so program audio dominates the FM budget)
PILOT_AMP = 0.1

#: sum/difference audio bandwidth, Hz — content must stay below this
AUDIO_BW = 13.5e3


@functools.lru_cache(maxsize=8)
def _channel_lpf(fs: float) -> np.ndarray:
    """Steep audio-channel lowpass: passband to AUDIO_BW, pilot (at
    fh ~ 15.7 kHz) in the stopband.  16385 taps at fs ~ 13.5 MHz give a
    ~3 kHz transition — FFT-conv application cost is length-independent."""
    return design.lowpass_taps(fs, AUDIO_BW, 16385)


def _phase(plan: ModemPlan, n_t: int, row_samples: int | None = None):
    """2*pi*fh*t on the composite sample grid, EXACT: fh = 1 cycle per
    row, so phase = 2*pi*(t mod N)/N with int arithmetic.  Pass
    ``row_samples`` (e.g. raster.n_total) when rows are not
    plan.n_samples long."""
    n = plan.n_samples if row_samples is None else int(row_samples)
    t = jnp.arange(n_t, dtype=jnp.int32)
    return (2.0 * np.pi / n) * (t % n).astype(jnp.float32)


def mts_encode(plan: ModemPlan, left, right, row_samples: int | None = None):
    """Stereo pair (B, T) at the composite rate -> MTS baseband (B, T).

    Feed the result to :func:`frame.rf.rf_modulate` as ``audio`` with an
    ``audio_bw=50e3`` RF plan."""
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    ph = _phase(plan, left.shape[-1], row_samples)[None, :]
    s = 0.5 * (left + right)
    d = 0.5 * (left - right)
    return s + PILOT_AMP * jnp.sin(ph) + d * (2.0 * jnp.cos(2.0 * ph))


def mts_decode(plan: ModemPlan, a, row_samples: int | None = None):
    """MTS baseband (B, T) -> (left, right, pilot_level).

    Sum = lowpass; difference = coherent DSB-SC demod against the exact
    2*fh carrier (no PLL needed — see module docstring); pilot_level is
    the correlated pilot amplitude per batch item (a stereo presence
    check: ~PILOT_AMP when stereo is being transmitted, ~0 on mono)."""
    a = jnp.asarray(a, jnp.float32)
    ph = _phase(plan, a.shape[-1], row_samples)[None, :]
    taps = _channel_lpf(plan.fs)
    s = fir_same_fft(a, taps)
    d = fir_same_fft(a * jnp.cos(2.0 * ph), taps)
    pilot = 2.0 * jnp.mean(a * jnp.sin(ph), axis=-1)
    return s + d, s - d, pilot


# --- public-entry jit (one compiled program per call; utils/jitwrap) ---
# mts_decode is wrapped; mts_encode is real elementwise and stays plain.
from color_modem_tpu.utils.jitwrap import plan_jit as _plan_jit

mts_decode = _plan_jit(mts_decode, static=("row_samples",))
