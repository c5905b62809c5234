"""Broadcast test & measurement: staircase stimulus + vectorscope readout.

Analog plants were qualified with standard test signals: a MODULATED
STAIRCASE (stepped luma with constant superimposed chroma) driven through
the chain, and differential gain/phase read off a vectorscope — exactly the
nonlinearities :func:`frame.channel.impair`'s ``diff_gain``/``diff_phase``
model.  This module closes that loop so a user can characterize any channel
configuration the way a broadcast engineer would:

    rgb  = modulated_staircase(plan, lines, samples)
    comp = impair(plan, encode(rgb), diff_phase_deg=20.0, ...)
    rep  = measure_differential(plan, comp, gline)
    rep["dp_deg"]   # ~20 * (luma span), the vectorscope DP number
    rep["dg"]       # (Amax - Amin) / Amax, the DG number

QAM standards only (SECAM's FM has no amplitude/phase to measure — its
immunity is the point).  Measurement is pure jnp and batched; the stimulus
is host NumPy config-time data like every other reference signal here.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp.apply import fir_same
from color_modem_tpu.modem import qam
from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.standards.base import QamParams

#: luma levels of the staircase steps (start near black, end near white —
#: chosen so constant chroma on top never clips RGB out of [0, 1])
_STEP_LUMA = (0.10, 0.25, 0.40, 0.55, 0.70, 0.85)


def modulated_staircase(
    plan: ModemPlan,
    n_lines: int,
    n_samples: int,
    c1: float = 0.06,
    c2: float = 0.06,
) -> np.ndarray:
    """(3, L, N) RGB: stepped luma with CONSTANT chroma (c1, c2) on top.

    The standard differential-distortion stimulus: any variation of the
    decoded chroma across steps was caused by the channel, not the signal.
    """
    steps = len(_STEP_LUMA)
    idx = np.minimum((np.arange(n_samples) * steps) // n_samples, steps - 1)
    y = np.asarray(_STEP_LUMA)[idx]
    ycc = np.stack([
        y,
        np.full(n_samples, c1),
        np.full(n_samples, c2),
    ])  # (3, N)
    rgb = plan.ycc_to_rgb @ ycc
    if rgb.min() < -1e-6 or rgb.max() > 1.0 + 1e-6:
        raise ValueError(
            f"staircase chroma ({c1}, {c2}) clips RGB "
            f"[{rgb.min():.3f}, {rgb.max():.3f}] — lower the amplitudes"
        )
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.broadcast_to(
        rgb[:, None, :], (3, n_lines, n_samples)
    ).astype(np.float32).copy()


#: multiburst packet frequencies, MHz — the classic set (0.5 through the
#: chroma region); packets beyond ~0.45 fs are dropped per-plan
MULTIBURST_MHZ = (0.5, 1.0, 2.0, 3.0, 3.58, 4.2)


def multiburst(plan: ModemPlan, n_lines: int,
               amplitude: float = 0.35) -> np.ndarray:
    """(3, L, N) gray multiburst: a reference pedestal then sine packets at
    :data:`MULTIBURST_MHZ` riding mid-gray — the standard luma
    frequency-response stimulus.  Rendered as equal-RGB (zero chroma), so
    everything the channel does to it happens in the luma path.
    """
    freqs = [f for f in MULTIBURST_MHZ if f * 1e6 < 0.45 * plan.fs]
    n = plan.n_samples
    slots = len(freqs) + 1  # slot 0 = flat reference pedestal
    width = n / slots
    m = np.arange(n)
    y = np.full(n, 0.5)
    for i, f in enumerate(freqs):
        lo = (i + 1) * width + 0.15 * width
        hi = (i + 2) * width - 0.15 * width
        sel = (m >= lo) & (m < hi)
        y[sel] += amplitude * np.sin(2 * np.pi * f * 1e6 / plan.fs * m[sel])
    rgb = np.broadcast_to(y, (3, n_lines, n)).astype(np.float32)
    return rgb.copy()


def measure_frequency_response(
    plan: ModemPlan, luma: jax.Array, amplitude: float = 0.35
) -> dict:
    """Per-packet amplitude of a decoded multiburst LUMA plane (..., L, N).

    Least-squares projection of each packet window onto its own
    ``[sin, cos, DC]`` basis (a plain quadrature correlation is biased up
    to ~25% at the low packets, whose windows hold a non-integer number
    of cycles), normalized by the stimulus amplitude: a flat channel
    reads ~1.0 per packet; VHS playback shows the 3 MHz rolloff; a notch
    decoder shows the chroma-trap dip near fsc.  Returns ``{MHz: gain}``.
    """
    freqs = [f for f in MULTIBURST_MHZ if f * 1e6 < 0.45 * plan.fs]
    n = luma.shape[-1]
    slots = len(freqs) + 1
    width = n / slots
    m = np.arange(n, dtype=np.float64)
    mean_line = jnp.mean(
        luma.reshape(-1, n).astype(jnp.float32), axis=0
    )
    # stack every packet's masked [sin, cos, DC] basis host-side and solve
    # all systems in ONE dispatch + ONE readback (a per-packet float()
    # would wait for the device once per packet)
    wb = np.zeros((len(freqs), 3, n), np.float32)
    for i, f in enumerate(freqs):
        lo = (i + 1) * width + 0.2 * width
        hi = (i + 2) * width - 0.2 * width
        w = (m >= lo) & (m < hi)
        ang = 2.0 * np.pi * f * 1e6 / plan.fs * m
        wb[i] = np.stack([np.sin(ang), np.cos(ang), np.ones(n)]) * w
    wb_j = jnp.asarray(wb)
    G = jnp.einsum("fan,fbn->fab", wb_j, wb_j)
    b = wb_j @ mean_line
    coef = jnp.linalg.solve(G, b[..., None])[..., 0]
    amps = np.asarray(jnp.hypot(coef[:, 0], coef[:, 1]))
    return {f: float(a) / amplitude for f, a in zip(freqs, amps)}


def measure_differential(
    plan: ModemPlan, comp: jax.Array, gline: jax.Array
) -> dict:
    """Vectorscope readout of a (..., L, N) staircase composite.

    Demodulates the chroma, averages the complex chroma vector over the
    central 60% of each step (and over all lines/frames), and reports the
    classic numbers relative to the bottom (near-black) step:

    * ``dg``      — differential gain, ``(Amax - Amin) / Amax``;
    * ``dp_deg``  — differential phase, max-minus-min step phase;
    * ``step_gain`` / ``step_phase_deg`` — the per-step curves.

    NIIR reads through the decoder's reference-line normalization (its
    reference-carrier lines hold no chroma to measure), so its numbers
    show the residual AFTER correction — near zero for channel-induced
    DG/DP, which is the measurement that makes sense for that system.
    """
    if not isinstance(plan.cfg.chroma, QamParams):
        raise ValueError(
            f"{plan.cfg.name}: differential gain/phase is a QAM-standard "
            "measurement (SECAM FM is immune by design)"
        )
    chroma_band = fir_same(comp.astype(jnp.float32), plan.chroma_bpf)
    c1, c2 = qam.demodulate_carrier(plan, chroma_band, gline)
    n = comp.shape[-1]
    niir_ref = plan.cfg.chroma.reference_amplitude is not None
    steps = len(_STEP_LUMA)
    width = n / steps
    masks = []
    m = np.arange(n)
    for k in range(steps):
        lo = k * width + 0.2 * width
        hi = (k + 1) * width - 0.2 * width
        masks.append(((m >= lo) & (m < hi)).astype(np.float32))
    masks = jnp.asarray(np.stack(masks))  # (steps, N)
    # average complex chroma per step — within ONE V-switch parity class:
    # on PAL a phase error appears as +t on one parity and -t on the
    # other, and averaging both arms cancels it to pure saturation loss
    # (that cancellation IS the PAL trick; a real PAL vectorscope shows
    # the two arms separately).  NTSC/NIIR have a single class.
    if niir_ref:
        # NIIR: odd lines carry the unmodulated reference carrier, not
        # chroma — averaging them in would corrupt the step vectors.  The
        # vectorscope reads what the decoder delivers, which is always the
        # reference-normalized chroma (modem/niir.normalize); with the
        # normalization applied, NIIR's DG/DP through an impaired channel
        # reads near zero — that immunity is the system's design goal.
        from color_modem_tpu.modem import niir

        c1, c2 = niir.normalize(plan, c1, c2, gline)
        sel = niir.is_chroma_line(gline).astype(jnp.float32)[..., None]
    else:
        sel = (qam.v_sign(plan, gline) > 0.0).astype(jnp.float32)[..., None]
    flat1 = (c1 * sel).reshape(-1, n)
    flat2 = (c2 * sel).reshape(-1, n)
    denom = jnp.sum(masks, axis=-1) * jnp.maximum(jnp.sum(sel), 1.0)
    re = masks @ jnp.sum(flat1, axis=0) / denom
    im = masks @ jnp.sum(flat2, axis=0) / denom
    amp = jnp.hypot(re, im)
    phase = jnp.arctan2(im, re)
    d = phase - phase[0]
    rel_phase = jnp.rad2deg(jnp.arctan2(jnp.sin(d), jnp.cos(d)))
    gain = amp / jnp.maximum(amp[0], 1e-9)
    dg = (jnp.max(amp) - jnp.min(amp)) / jnp.maximum(jnp.max(amp), 1e-9)
    dp = jnp.max(rel_phase) - jnp.min(rel_phase)
    return {
        "dg": float(dg),
        "dp_deg": float(dp),
        "step_gain": np.asarray(gain),
        "step_phase_deg": np.asarray(rel_phase),
    }


# ---------------------------------------------------------------------------
# ITU-R pulse-and-bar insertion test line (K-factor + chroma/luma inequality)
# ---------------------------------------------------------------------------

def _pb_T_seconds(plan: ModemPlan) -> float:
    """The system's sine-squared unit time T: 125 ns for 525-line systems,
    100 ns for 625-line systems (ITU-R BT.628 convention — T = 1/(2*BW)
    at the nominal video bandwidths 4 MHz / 5 MHz)."""
    return 125e-9 if plan.cfg.total_lines == 525 else 100e-9


def _pb_layout(plan: ModemPlan) -> dict:
    """Sample-index layout of the pulse-and-bar line, shared by stimulus
    and measurement.  All windows are functions of the line length and of
    T so the geometry scales with ``n_samples``/``fs``."""
    n = plan.n_samples
    ts = _pb_T_seconds(plan) * plan.fs  # T in samples
    lay = {
        "T": ts,
        "blank": (int(0.02 * n), int(0.08 * n)),
        "bar_rise": 0.10 * n,          # leading-edge start
        "bar_fall": 0.40 * n,          # trailing-edge start
        "bar_win": (int(0.18 * n), int(0.34 * n)),
        "pulse_c": 0.55 * n,           # 2T pulse center
        "p20_c": 0.78 * n,             # 20T modulated pulse center
    }
    c = lay["pulse_c"]
    lay["pulse_win"] = (int(c - 3.0 * ts), int(c + 3.0 * ts) + 1)
    # K-factor ring/echo windows: baseline disturbance between 3T and 20T
    # on either side of the pulse (the flat-graticule reading — the real
    # graticule relaxes with distance, so this is the conservative bound)
    lay["ring_l"] = (int(c - 20.0 * ts), int(c - 3.0 * ts))
    lay["ring_r"] = (int(c + 3.0 * ts) + 1, int(c + 20.0 * ts) + 1)
    c2 = lay["p20_c"]
    lay["p20_win"] = (int(c2 - 25.0 * ts), int(c2 + 25.0 * ts) + 1)
    return lay


def pulse_and_bar(plan: ModemPlan, n_lines: int,
                  amplitude: float = 0.7) -> np.ndarray:
    """(3, L, N) RGB pulse-and-bar insertion test line.

    The classic ITU-R waveform-distortion stimulus, three elements on one
    line: a white BAR with sine-squared (raised-cosine) edges of duration
    4T, a 2T sine-squared PULSE (half-amplitude duration 2T — energy up to
    the full video band, so it exposes everything the plant does near and
    above fsc), and a 20T MODULATED pulse (sine-squared luma envelope with
    the chroma subcarrier riding at equal amplitude) that reads the
    chrominance/luminance gain and delay inequality.  Bar and 2T pulse are
    equal-RGB (pure luma) at full scale; the 20T element is scaled by
    ``amplitude`` so the chroma excursion stays inside RGB [0, 1].
    """
    lay = _pb_layout(plan)
    n = plan.n_samples
    ts = lay["T"]
    m = np.arange(n, dtype=np.float64)

    # bar with sine-squared edges (rise time 4T each side)
    def edge(t0):
        u = np.clip((m - t0) / (4.0 * ts), 0.0, 1.0)
        return np.sin(0.5 * np.pi * u) ** 2

    y = edge(lay["bar_rise"]) - edge(lay["bar_fall"])

    # 2T pulse: sin^2(pi*t/tau), tau = 4T  (HAD = tau/2 = 2T)
    def sin2(center, tau):
        t = m - (center - 0.5 * tau)
        return np.where((t >= 0) & (t <= tau),
                        np.sin(np.pi * np.clip(t, 0, tau) / tau) ** 2, 0.0)

    y += sin2(lay["pulse_c"], 4.0 * ts)

    # 20T modulated pulse: luma = env/2, chroma magnitude = env/2
    env = amplitude * sin2(lay["p20_c"], 40.0 * ts)
    y20 = 0.5 * env
    cmag = 0.5 * env / np.sqrt(2.0)  # split across both components
    ycc = np.stack([y + y20, cmag, cmag])
    rgb = plan.ycc_to_rgb @ ycc
    if rgb.min() < -1e-6 or rgb.max() > 1.0 + 1e-6:
        raise ValueError(
            f"pulse-and-bar amplitude {amplitude} clips RGB "
            f"[{rgb.min():.3f}, {rgb.max():.3f}] — lower it"
        )
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.broadcast_to(
        rgb[:, None, :], (3, n_lines, n)
    ).astype(np.float32).copy()


def measure_pulse_bar(
    plan: ModemPlan, comp: jax.Array, gline: jax.Array,
    amplitude: float = 0.7,
) -> dict:
    """Waveform-monitor readout of a (..., L, N) pulse-and-bar composite.

    Reads the received composite the way a broadcast monitor does (the bar
    and 2T pulse carry no chroma, so the raw waveform IS the luma there):

    * ``k2t_pct`` — the 2T K-rating in percent: the larger of the
      pulse-to-bar inequality |P/B - 1|/4 and the flat-graticule echo
      reading max|r|/(4B) over the 3T..20T windows flanking the pulse.
      An echo of relative amplitude a reads K = a/4 — e.g. a -12 dB ghost
      inside the window rates ~6 %.
    * ``pulse_bar_ratio`` — P/B itself.
    * ``cl_gain`` — chrominance/luminance gain inequality off the 20T
      pulse (1.0 = equal, as transmitted).
    * ``cl_delay_ns`` — chrominance/luminance delay inequality: centroid
      of the demodulated chroma envelope minus centroid of the low-passed
      luma envelope, in nanoseconds (VHS color-under reads its ~400 ns
      envelope delay here).

    Both 20T envelopes are extracted with zero-phase FIRs (the plan's own
    chroma LPF), so the measurement adds no delay bias of its own.
    """
    if not isinstance(plan.cfg.chroma, QamParams):
        raise ValueError(
            f"{plan.cfg.name}: pulse-and-bar chroma inequality is a "
            "QAM-standard measurement"
        )
    lay = _pb_layout(plan)
    n = comp.shape[-1]
    x = comp.reshape(-1, n).astype(jnp.float32)
    if plan.cfg.chroma.reference_amplitude is not None:
        # NIIR: the unmodulated reference carrier rides the FULL line on
        # alternate lines (blank, bar, and pulse regions included) — a
        # K reading over those lines would rate the system's own carrier
        # as distortion.  Average the waveform over chroma lines only.
        from color_modem_tpu.modem import niir

        sel_w = niir.is_chroma_line(gline).astype(jnp.float32).reshape(-1)
        mean_line = (sel_w @ x) / jnp.maximum(jnp.sum(sel_w), 1.0)
    else:
        mean_line = jnp.mean(x, axis=0)

    def win(name):
        lo, hi = lay[name]
        return mean_line[lo:hi]

    base = jnp.mean(win("blank"))
    bar = jnp.mean(win("bar_win")) - base
    bar = jnp.maximum(bar, 1e-6)
    pulse = jnp.max(win("pulse_win")) - base
    ratio = pulse / bar
    k_pb = jnp.abs(ratio - 1.0) / 4.0
    ring = jnp.maximum(
        jnp.max(jnp.abs(win("ring_l") - base)),
        jnp.max(jnp.abs(win("ring_r") - base)),
    ) / (4.0 * bar)
    k2t = jnp.maximum(k_pb, ring)

    # --- 20T chroma/luma inequality ------------------------------------
    chroma_band = fir_same(comp.astype(jnp.float32), plan.chroma_bpf)
    c1, c2 = qam.demodulate_carrier(plan, chroma_band, gline)
    env = jnp.hypot(c1, c2).reshape(-1, n)
    if plan.cfg.chroma.reference_amplitude is not None:
        # NIIR: reference-carrier lines hold a constant carrier, not the
        # 20T chroma — average the envelope over chroma lines only
        from color_modem_tpu.modem import niir

        sel = niir.is_chroma_line(gline).astype(jnp.float32).reshape(-1)
        env = (sel @ env) / jnp.maximum(jnp.sum(sel), 1.0)
    else:
        env = jnp.mean(env, axis=0)
    # zero-phase LPF strips the subcarrier from the raw waveform, leaving
    # the 20T LUMA envelope (its own bandwidth is ~1/(40T), well inside)
    luma = fir_same(mean_line, plan.c1_lpf)
    lo, hi = lay["p20_win"]
    idx = jnp.arange(lo, hi, dtype=jnp.float32)
    blo, bhi = lay["blank"]
    ce = jnp.maximum(env[lo:hi] - jnp.mean(env[blo:bhi]), 0.0)
    le = jnp.maximum(luma[lo:hi] - jnp.mean(luma[blo:bhi]), 0.0)
    cw = ce * ce
    lw = le * le
    cen_c = jnp.sum(idx * cw) / jnp.maximum(jnp.sum(cw), 1e-12)
    cen_l = jnp.sum(idx * lw) / jnp.maximum(jnp.sum(lw), 1e-12)
    delay_ns = (cen_c - cen_l) / plan.fs * 1e9
    gain = jnp.max(ce) / jnp.maximum(jnp.max(le), 1e-9)
    # one stacked readback (device->host fetches cost ~0.1 s each here)
    k2t, ratio, gain, delay_ns = np.asarray(
        jnp.stack([k2t, ratio, gain, delay_ns]))
    return {
        "k2t_pct": float(100.0 * k2t),
        "pulse_bar_ratio": float(ratio),
        "cl_gain": float(gain),
        "cl_delay_ns": float(delay_ns),
    }


def measure_k_rating(plan: ModemPlan, luma: jax.Array) -> dict:
    """2T K-rating off a DECODED LUMA plane (..., L, N) — the SECAM half
    of the pulse-and-bar instrument (VERDICT r2 item 9).

    SECAM's FM chroma carrier rides the composite at constant amplitude
    everywhere — blank, bar and pulse windows included — so the raw
    waveform reading :func:`measure_pulse_bar` does for QAM standards
    would rate the system's own carrier as ringing.  SECAM plants read
    the 2T elements after the receiver's luma path (carrier trap
    included), which is what this measures: pass the decoded picture's
    Y plane (``plan.rgb_to_ycc @ rgb``).  The 20T chrominance/luminance
    inequality stays QAM-only (its subcarrier-envelope readout has no FM
    counterpart); differential gain/phase stays physically meaningless
    for FM chroma.
    """
    lay = _pb_layout(plan)
    n = luma.shape[-1]
    mean_line = jnp.mean(luma.reshape(-1, n).astype(jnp.float32), axis=0)

    def win(name):
        lo, hi = lay[name]
        return mean_line[lo:hi]

    base = jnp.mean(win("blank"))
    bar = jnp.maximum(jnp.mean(win("bar_win")) - base, 1e-6)
    pulse = jnp.max(win("pulse_win")) - base
    ratio = pulse / bar
    k_pb = jnp.abs(ratio - 1.0) / 4.0
    ring = jnp.maximum(
        jnp.max(jnp.abs(win("ring_l") - base)),
        jnp.max(jnp.abs(win("ring_r") - base)),
    ) / (4.0 * bar)
    k2t, ratio = np.asarray(jnp.stack([jnp.maximum(k_pb, ring), ratio]))
    return {
        "k2t_pct": float(100.0 * k2t),
        "pulse_bar_ratio": float(ratio),
    }


def bar_vectors(plan: ModemPlan, amplitude: float = 0.75) -> np.ndarray:
    """(6, 2) chroma component targets of the 75% color bars (yellow,
    cyan, green, magenta, red, blue) in the standard's own (c1, c2)
    space — the graticule box positions of a real vectorscope, exact per
    standard because they come from the plan's colorimetry matrix."""
    bars = np.array([
        [1, 1, 0], [0, 1, 1], [0, 1, 0], [1, 0, 1], [1, 0, 0], [0, 0, 1],
    ], dtype=np.float64) * amplitude
    ycc = bars @ np.asarray(plan.rgb_to_ycc).T
    return ycc[:, 1:]


def vectorscope_image(
    plan: ModemPlan, comp: jax.Array, gline: jax.Array, size: int = 512
) -> np.ndarray:
    """Render the classic vectorscope instrument display: demodulated
    chroma samples accumulated as a green phosphor trace over the
    (c1, c2) plane, with graticule boxes at the exact 75%-bar targets.

    PAL shows BOTH V-switch arms (c2 re-alternated per line, mirrored
    about the c1 axis) — the familiar two-arm pattern a real PAL scope
    draws, because its reference does not follow the V switch.  Returns
    (size, size, 3) float32 RGB in [0, 1]; +c2 is up, +c1 is right.
    """
    if not isinstance(plan.cfg.chroma, QamParams):
        raise ValueError(
            f"{plan.cfg.name}: the vectorscope demodulates a QAM "
            "subcarrier (SECAM is FM — use the FM deviation readout)"
        )
    chroma_band = fir_same(comp.astype(jnp.float32), plan.chroma_bpf)
    c1, c2 = qam.demodulate_carrier(plan, chroma_band, gline)
    if getattr(plan.cfg.chroma, "v_switch", False):
        c2 = c2 * qam.v_sign(plan, gline)[..., None]
    u = np.asarray(c1, dtype=np.float64).ravel()
    v = np.asarray(c2, dtype=np.float64).ravel()
    targets = bar_vectors(plan)
    rmax = 1.35 * float(np.max(np.hypot(targets[:, 0], targets[:, 1])))
    # phosphor accumulation: 2D histogram, log intensity (a real CRT's
    # brightness follows dwell time; log keeps dim transitions visible)
    hist, _, _ = np.histogram2d(
        v, u, bins=size, range=[[-rmax, rmax], [-rmax, rmax]]
    )
    hist = hist[::-1]  # +c2 up
    g = np.log1p(hist) / max(np.log1p(hist.max()), 1.0)
    img = np.zeros((size, size, 3), np.float32)
    img[..., 0] = 0.25 * g
    img[..., 1] = 0.95 * g
    img[..., 2] = 0.35 * g

    def _px(cu, cv):
        x = int(round((cu + rmax) / (2 * rmax) * (size - 1)))
        y = int(round((rmax - cv) / (2 * rmax) * (size - 1)))
        return np.clip(x, 0, size - 1), np.clip(y, 0, size - 1)

    grat = np.float32([0.35, 0.35, 0.35])
    # center cross
    cx, cy = _px(0.0, 0.0)
    img[cy, :] = np.maximum(img[cy, :], grat * 0.6)
    img[:, cx] = np.maximum(img[:, cx], grat * 0.6)
    # graticule boxes at every bar target; PAL draws both arms' boxes
    arms = (
        np.concatenate([targets, targets * np.array([1.0, -1.0])])
        if getattr(plan.cfg.chroma, "v_switch", False) else targets
    )
    half = max(2, int(round(0.05 * size / 2)))
    for cu, cv in arms:
        x, y = _px(cu, cv)
        x0, x1 = max(x - half, 0), min(x + half, size - 1)
        y0, y1 = max(y - half, 0), min(y + half, size - 1)
        for yy in (y0, y1):
            img[yy, x0:x1 + 1] = np.maximum(img[yy, x0:x1 + 1], grat)
        for xx in (x0, x1):
            img[y0:y1 + 1, xx] = np.maximum(img[y0:y1 + 1, xx], grat)
    return img


def composite_spectrum(plan: ModemPlan, comp: jax.Array):
    """(freqs_hz, power_db) averaged spectrum of a (..., L, N) composite.

    One Hann-windowed pow2 rfft over each concatenated line stream (the
    multi-line coherence is the point: per-line FFTs have exactly fh
    resolution and cannot resolve the fh-spaced comb teeth), power
    averaged over leading dims, normalized to the peak.  Resolution is
    ~2 fh / L — at 64 lines the luma teeth at k*fh and the chroma teeth
    offset by fh/2 (NTSC's half-line phase law; the frequency
    interleaving the whole composite trick rests on) separate cleanly.

    Feed a RASTERED composite (make_pipeline(raster=True)): the fh comb
    is a property of the full line period (858 samples on NTSC), and an
    active-only stream (720) has a different periodicity that scrambles
    the textbook tooth positions (measured: the interleave inverts).
    """
    x = np.asarray(comp, np.float64).reshape(-1, comp.shape[-2] * comp.shape[-1])
    t = x.shape[-1]
    x = (x - x.mean(axis=-1, keepdims=True)) * np.hanning(t)
    nfft = 1 << int(np.ceil(np.log2(t)))
    p = np.mean(np.abs(np.fft.rfft(x, n=nfft, axis=-1)) ** 2, axis=0)
    freqs = np.fft.rfftfreq(nfft, d=1.0 / plan.fs)
    db = 10.0 * np.log10(np.maximum(p, 1e-30) / max(p.max(), 1e-30))
    return freqs, db


def spectrum_image(plan: ModemPlan, comp: jax.Array, size: int = 512,
                   zoom_teeth: int = 16, floor_db: float = -80.0
                   ) -> np.ndarray:
    """Render the spectrum analyzer: top panel 0..fs/2 full band, bottom
    panel zoomed to fsc +- ``zoom_teeth``*fh where the luma/chroma comb
    interleave is visible tooth by tooth.  Graticule: verticals at fsc
    (bright) and, in the zoom, at every multiple of fh (dim — the luma
    teeth positions; chroma energy sits BETWEEN them on half-line
    standards, which is the interleaving trick made visible).
    Horizontal rules every 20 dB.  Returns (size, size, 3) float32 RGB.
    """
    freqs, db = composite_spectrum(plan, comp)
    fh = plan.cfg.fh
    fsc = plan.cfg.chroma.fsc
    img = np.zeros((size, size, 3), np.float32)
    h = size // 2
    grat = np.float32([0.35, 0.35, 0.35])
    trace = np.float32([0.25, 0.95, 0.35])

    def _panel(y0, f_lo, f_hi):
        rows = h - 2
        sel = (freqs >= f_lo) & (freqs <= f_hi)
        f, d = freqs[sel], np.clip(db[sel], floor_db, 0.0)
        col = ((f - f_lo) / (f_hi - f_lo) * (size - 1)).astype(np.int64)
        # per-column max (analyzer peak-hold), filled trace below
        peak = np.full(size, floor_db)
        np.maximum.at(peak, col, d)
        top = np.clip((peak / floor_db * (rows - 1)).astype(np.int64),
                      0, rows - 1)
        yy = np.arange(rows)[:, None]
        fill = yy > top[None, :]
        on = yy == top[None, :]
        img[y0 : y0 + rows][fill] = np.maximum(
            img[y0 : y0 + rows][fill], 0.18 * trace
        )
        img[y0 : y0 + rows][on] = trace
        for k in range(1, 4):  # -20/-40/-60 dB rules
            y = y0 + int(rows * (20.0 * k / -floor_db))
            img[y] = np.maximum(img[y], grat * 0.6)
        if f_lo <= fsc <= f_hi:
            c = int((fsc - f_lo) / (f_hi - f_lo) * (size - 1))
            img[y0 : y0 + rows, c] = np.maximum(
                img[y0 : y0 + rows, c], np.float32([0.8, 0.5, 0.2])
            )
        return f_lo, f_hi

    _panel(0, 0.0, plan.fs / 2)
    f_lo = fsc - zoom_teeth * fh
    f_hi = fsc + zoom_teeth * fh
    _panel(h + 2, f_lo, f_hi)
    # zoom graticule: luma teeth at every multiple of fh (dim)
    k0 = int(np.ceil(f_lo / fh))
    while k0 * fh <= f_hi:
        c = int((k0 * fh - f_lo) / (f_hi - f_lo) * (size - 1))
        img[h + 2 :, c] = np.maximum(img[h + 2 :, c], grat * 0.45)
        k0 += 1
    return img


def waveform_image(
    comp: jax.Array, size: int = 512, lo: float = -0.5, hi: float = 1.2
) -> np.ndarray:
    """Render the waveform monitor: every line of a (..., L, N) composite
    overlaid as a green phosphor trace (x = position along the line,
    y = amplitude in video units), with graticule lines at the video
    levels: sync tip -0.4 (-40 IRE), blanking 0, peak white 1 (100 IRE).

    On a rastered composite the sync pulse and burst envelope show in the
    blanking interval exactly as on a real monitor.  Standard-agnostic:
    the composite's video-unit convention is the whole geometry.
    Returns (size, size, 3) float32 RGB in [0, 1].
    """
    x = np.asarray(comp, dtype=np.float64).reshape(-1, comp.shape[-1])
    n = x.shape[-1]
    # accumulate dwell: for each output column, histogram the amplitudes
    # of the samples that fall in it (log brightness like the CRT)
    col = (np.arange(n) * size // n)
    amp_bin = np.clip(
        ((hi - x) / (hi - lo) * (size - 1)).astype(np.int64), 0, size - 1
    )
    hist = np.zeros((size, size), np.float64)
    np.add.at(hist, (amp_bin.ravel(), np.broadcast_to(col, x.shape).ravel()), 1.0)
    g = np.log1p(hist) / max(np.log1p(hist.max()), 1.0)
    img = np.zeros((size, size, 3), np.float32)
    img[..., 0] = 0.25 * g
    img[..., 1] = 0.95 * g
    img[..., 2] = 0.35 * g
    grat = np.float32([0.35, 0.35, 0.35])
    for level, strength in ((-0.4, 0.9), (0.0, 1.0), (0.7, 0.5), (1.0, 0.9)):
        y = int(round((hi - level) / (hi - lo) * (size - 1)))
        if 0 <= y < size:
            img[y] = np.maximum(img[y], grat * strength)
    return img
