"""A2 / Zweikanalton two-carrier stereo (beyond-reference).

The third of the world's three terrestrial analog stereo systems, and
the one the framework was missing: the Americas' System M multiplexes
MTS/BTSC onto ONE sound carrier (frame/mts.py), the UK/Nordic 625-line
world went digital with NICAM-728 (frame/nicam.py), and the German
IRT "A2" system instead transmits a SECOND FM sound carrier:

* carrier 1 (the normal intercarrier sound, frame/rf.py): (L+R)/2 —
  a mono receiver hears the compatible sum and never knows;
* carrier 2, **15.5 line frequencies above carrier 1** (5.7421875 MHz
  vs 5.5 MHz intercarrier on System B/G), at half the amplitude
  (-20 dB vs the picture carrier against carrier 1's -13 dB): the
  RIGHT channel (stereo mode) or an independent second program (dual /
  "Zweikanalton" mode);
* a pilot at **3.5 fh = 54.6875 kHz** rides carrier 2's FM multiplex,
  amplitude-modulated by the identification tone that tells the
  receiver which mode it is hearing: fh/133 = 117.49 Hz for stereo,
  fh/57 = 274.1 Hz for dual, no pilot for mono.

Array mapping (all conventions from frame/rf.py):

* Carrier 2's frequency is EXACTLY carrier 1's plus 31 half-cycles per
  row.  Carrier 1's half-cycle count is ODD (rf.py snaps it so), which
  makes carrier 2's EVEN: an integer number of cycles per row, so its
  row-start phase never alternates — its closed-form law is the plain
  per-row ramp with NO (-1)^row factor.  Getting this parity wrong is
  not cosmetic: applying the alternating law to an integer-cycles
  carrier splits it into f +- fh/2 sidebands, and the then row-
  DIScontinuous beat against carrier 1 intermodulates to a spur at
  exactly fh in the mono channel (measured: 2.2e-3, -43 dB, before
  this was fixed).
* The pilot's 3.5 cycles/row is 7 half-cycles: its within-row ramp is a
  host-f64 constant and its row phase is the SAME (-1)^row sign — one
  multiply, no NCO.
* The ident tone phase is keyed on the absolute row index with the
  mod-1 split-factor reduction (frame/rf.py::_df_phase's trick), so
  chunked runs stay phase-continuous.
* Mode detection is one quadrature projection: mix the carrier-2
  discriminator output with the closed-form pilot, low-pass, then dot
  the envelope against cos/sin at both ident frequencies — no PLL, no
  scan, batch-parallel.

No reference counterpart (SURVEY.md §2.1 stops at the composite);
constants are the published A2 numbers, cited inline.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp import design
from color_modem_tpu.dsp.apply import fir_same_fft
from color_modem_tpu.dsp.nco import sample_phase_ramp
from color_modem_tpu.frame.rf import RFPlan, _abs_rows, _row_sign

TWO_PI = 2.0 * np.pi

#: carrier-2 offset above carrier 1, in HALF-cycles per row: 15.5 fh.
OFFSET_HALF_CYCLES = 31
#: pilot frequency in half-cycles per row: 3.5 fh = 54.6875 kHz at 625/50.
PILOT_HALF_CYCLES = 7
#: ident tone dividers (of fh): stereo fh/133 = 117.49 Hz, dual fh/57 =
#: 274.12 Hz.
IDENT_DIV = {"stereo": 133, "dual": 57}
#: pilot FM deviation on carrier 2, Hz (+-2.5 kHz per the A2 spec), and
#: its AM modulation depth by the ident tone (50 %).
PILOT_DEV = 2.5e3
PILOT_AM = 0.5


@dataclasses.dataclass(frozen=True, eq=False)
class A2Plan:
    """Carrier-2 + pilot geometry layered over an RFPlan."""

    rfp: RFPlan
    f_snd2: float             # second sound carrier, Hz
    snd2_num: int             # half-cycles per row (odd, = snd_num + 31)
    amp2: float               # carrier-2 amplitude vs peak picture carrier
    snd2_ramp: np.ndarray     # (N*r,) carrier-2 phase ramp, f64
    pilot_ramp: np.ndarray    # (N,) pilot phase ramp at COMPOSITE rate, f64
    bpf1: np.ndarray          # carrier-1 takeoff band-pass (fs_rf)
    bpf2: np.ndarray          # carrier-2 takeoff band-pass (fs_rf)
    snd_lpf: np.ndarray       # post-mix I/Q low-pass (fs_rf)
    pil_lpf: np.ndarray       # pilot-envelope low-pass (composite rate)

    @property
    def fh(self) -> float:
        return self.rfp.plan.fs / self.rfp.row_samples

    def ident_hz(self, mode: str) -> float:
        return self.fh / IDENT_DIV[mode]


def make_a2_plan(rfp: RFPlan) -> A2Plan:
    """Design the A2 second-carrier geometry over ``rfp``.

    The two sound takeoff filters are NARROWER than rf.py's single-sound
    ``snd_bpf`` (whose transition spans the whole 242 kHz A2 spacing):
    Carson half-width is dev + f_aud ~ 65 kHz, so +-100 kHz passbands
    with 70 kHz skirts keep each discriminator's capture clear of the
    neighbor.  Carrier 2 sits at HALF carrier 1's amplitude — the A2
    -13/-20 dB split.
    """
    fs_rf = rfp.fs_rf
    n = rfp.row_samples
    snd2_num = rfp.snd_num + OFFSET_HALF_CYCLES
    f_snd2 = snd2_num / 2 * rfp.plan.fs / n
    half = rfp.snd_dev + 15e3 + 35e3          # Carson half-width + margin
    skirt = 70e3
    if f_snd2 + half + skirt > fs_rf / 2 - 0.2e6:
        raise ValueError(
            f"A2 carrier 2 at {f_snd2/1e6:.3f} MHz does not fit under RF "
            f"Nyquist {fs_rf/2e6:.2f} MHz — raise r"
        )
    ntaps = 4097
    bpf1 = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(
            f, rfp.f_snd - half, rfp.f_snd + half, skirt
        ),
        ntaps,
    )
    bpf2 = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(
            f, f_snd2 - half, f_snd2 + half, skirt
        ),
        ntaps,
    )
    snd_lpf = design.lowpass_taps(fs_rf, half + 30e3, ntaps)
    # pilot-envelope LPF at the composite rate: passes the ident tones
    # (117/274 Hz), stops the 2x-pilot mixing image at ~109 kHz.  8193
    # taps give a ~6.6 kHz transition — overkill for the stop band and
    # the narrowest this one FFT pass buys.
    pil_lpf = design.lowpass_taps(rfp.plan.fs, 2e3, 8193)
    return A2Plan(
        rfp=rfp, f_snd2=f_snd2, snd2_num=snd2_num, amp2=rfp.snd_amp / 2,
        snd2_ramp=sample_phase_ramp(f_snd2, fs_rf, n * rfp.r),
        pilot_ramp=sample_phase_ramp(PILOT_HALF_CYCLES / 2 * rfp.plan.fs / n,
                                     rfp.plan.fs, n),
        bpf1=bpf1, bpf2=bpf2, snd_lpf=snd_lpf, pil_lpf=pil_lpf,
    )


def _ident_phase_rows(a2p: A2Plan, mode: str, rows: jax.Array):
    """(..., N) ident-tone phase for an absolute-row index array.

    cycles/row = 1/IDENT_DIV exactly (the ident divides fh), so the
    row-start phase is (row / div) mod 1 — integer mod, exact at any
    video length; the within-row ramp is host f64.
    """
    n = a2p.rfp.row_samples
    div = IDENT_DIV[mode]
    start = (rows % div).astype(jnp.float32) / np.float32(div)
    in_row = jnp.asarray(
        TWO_PI * np.mod(np.arange(n, dtype=np.float64) / (n * div), 1.0),
        jnp.float32,
    )
    return (TWO_PI * start)[..., None] + in_row


def _ident_phase(a2p: A2Plan, mode: str, frame0, b: int, l: int):
    """(B, L, N) ident-tone phase, keyed on the absolute row index."""
    return _ident_phase_rows(a2p, mode, _abs_rows(frame0, b, l))


def a2_multiplex(a2p: A2Plan, audio2, mode: str, frame0, b: int, l: int):
    """Carrier-2 modulating signal: audio + AM-ident pilot (B, L*N)."""
    n = a2p.rfp.row_samples
    pilot = jnp.asarray(np.cos(a2p.pilot_ramp), jnp.float32)[None, None, :]
    pilot = pilot * _row_sign(a2p.rfp, frame0, b, l)[:, :, None]
    am = 1.0 + PILOT_AM * jnp.cos(_ident_phase(a2p, mode, frame0, b, l))
    pil = (PILOT_DEV / a2p.rfp.snd_dev) * (am * pilot).reshape(b, l * n)
    return jnp.asarray(audio2, jnp.float32) + pil


def a2_on_rf(a2p: A2Plan, rf, frame0, audio2, mode: str = "stereo"):
    """Add the A2 second sound carrier to an RF block (B, L, N*r).

    ``audio2``: (B, L*N) in [-1, 1] — the RIGHT channel (stereo) or the
    second program (dual).  Carrier 1 (with (L+R)/2 or program 1) comes
    from ``rf_modulate(..., audio=...)`` as usual.  ``mode`` picks the
    ident tone; "mono" is expressed by NOT calling this function.
    """
    rfp = a2p.rfp
    b, l, n_rf = rf.shape
    mux = a2_multiplex(a2p, audio2, mode, frame0, b, l)
    a_rf = jnp.repeat(mux, rfp.r, axis=-1)   # ZOH, as rf_modulate's sound
    dphi = (TWO_PI * rfp.snd_dev / rfp.fs_rf) * a_rf
    phi_dev = jnp.cumsum(dphi, axis=-1).reshape(b, l, n_rf)
    phi = jnp.asarray(a2p.snd2_ramp, jnp.float32)[None, None, :] + phi_dev
    snd = jnp.cos(phi) * _carrier2_sign(a2p, frame0, b, l)
    return rf + a2p.amp2 * snd


def _carrier2_sign(a2p: A2Plan, frame0, b: int, l: int):
    """Row-start sign of carrier 2: (-1)^row only if its half-cycle
    count is odd; an integer-cycles-per-row carrier (snd2_num even — the
    normal case, see module docstring) never alternates."""
    if a2p.snd2_num % 2:
        return _row_sign(a2p.rfp, frame0, b, l)[:, :, None]
    return jnp.ones((b, l, 1), jnp.float32)


def _takeoff(a2p: A2Plan, rf, bpf, ramp, frame0, sign=None):
    """FM discriminate one sound carrier -> (raw audio (B, L*N),
    carrier level (B,)) — the rf.py::rf_demodulate_sound chain with A2's
    narrower filters, plus the mean I/Q magnitude (the receiver's
    carrier-presence meter: FM amplitude carries no program, so |z| sits
    at the carrier amplitude and collapses to the noise floor when the
    carrier is absent — the ONLY reliable absence test, because a
    discriminator with no carrier sprays full-scale noise)."""
    rfp = a2p.rfp
    b, l, n_rf = rf.shape
    n = rfp.row_samples
    xs = fir_same_fft(rf.reshape(b, l * n_rf), bpf)
    if sign is None:
        sign = _row_sign(rfp, frame0, b, l)[:, :, None]
    rv = jnp.asarray(ramp, jnp.float32)[None, None, :]
    c = (jnp.cos(rv) * sign).reshape(b, l * n_rf)
    s = (jnp.sin(rv) * sign).reshape(b, l * n_rf)
    i = fir_same_fft(xs * (2.0 * c), a2p.snd_lpf)
    q = fir_same_fft(xs * (-2.0 * s), a2p.snd_lpf)
    i = i.reshape(b, l, n, rfp.r)[..., 0].reshape(b, l * n)
    q = q.reshape(b, l, n, rfp.r)[..., 0].reshape(b, l * n)
    level = jnp.mean(jnp.sqrt(i * i + q * q), axis=-1)
    ip = jnp.concatenate([i[:, :1], i[:, :-1]], axis=-1)
    qp = jnp.concatenate([q[:, :1], q[:, :-1]], axis=-1)
    dphi = jnp.arctan2(ip * q - i * qp, i * ip + q * qp)
    return dphi * (rfp.plan.fs / (TWO_PI * rfp.snd_dev)), level


def a2_detect_mode(a2p: A2Plan, raw2, frame0, b: int, l: int,
                   group: int = 1):
    """Pilot + ident detection from carrier 2's raw discriminator output.

    Returns ``(pilot_level, powers, resid)`` — the pilot level in
    multiplex units (transmitted: PILOT_DEV/snd_dev = 0.05), the fitted
    ident AMPLITUDE per candidate frequency (transmitted: 0.5 * pilot
    level), and each candidate's normalized fit RESIDUAL power.
    Decision rule (the receiver IC's): no pilot -> mono; else the
    candidate whose matched model leaves the smaller residual wins —
    amplitudes alone cannot decide at sub-cycle windows, where the slow
    candidate's basis can over-fit a segment of the other tone.

    ``group``: decide over groups of ``group`` consecutive batch items
    covering consecutive broadcast time — interlaced runs pass 2 so the
    window is the frame's FIELD PAIR.  The ident tones (fh/133 = 117 Hz
    vs fh/57 = 274 Hz) are slow against a field: a single 32-row field
    is a ~quarter-cycle projection window where the two idents stop
    being orthogonal (measured: the wrong one wins, round-4 full-stack
    composition probe); joining the pair restores the progressive-window
    margin.  The absolute-row phase laws are continuous across
    consecutive items, so grouping is a plain reshape — ``group=1`` is
    bit-identical to the ungrouped math.  Returned arrays stay (B,)
    (each group's statistic repeats over its members).
    """
    rfp = a2p.rfp
    n = rfp.row_samples
    if b % group:
        raise ValueError(f"a2_detect_mode: group={group} must divide b={b}")
    bg, lg = b // group, group * l
    # absolute rows of the grouped blocks: the block starts at row
    # frame0*l (same origin as _abs_rows) and each grouped item covers
    # lg consecutive rows
    rows = (jnp.asarray(frame0, jnp.int32) * jnp.int32(l)
            + jnp.arange(bg, dtype=jnp.int32)[:, None] * jnp.int32(lg)
            + jnp.arange(lg, dtype=jnp.int32)[None, :])
    sign = (1.0 - 2.0 * (rows % 2).astype(jnp.float32))[:, :, None]
    pilot = jnp.asarray(np.cos(a2p.pilot_ramp), jnp.float32)[None, None, :]
    qpil = jnp.asarray(np.sin(a2p.pilot_ramp), jnp.float32)[None, None, :]
    raw2g = raw2.reshape(bg, lg * n)
    pc = (pilot * sign).reshape(bg, lg * n)
    ps = (qpil * sign).reshape(bg, lg * n)
    # the pilot-envelope filter runs on the JOINED group stream too:
    # fields are consecutive broadcast time, so the true neighborhood
    # crosses the field seam
    i = fir_same_fft(raw2g * (2.0 * pc), a2p.pil_lpf)
    q = fir_same_fft(raw2g * (-2.0 * ps), a2p.pil_lpf)
    env = jnp.sqrt(i * i + q * q)            # (Bg, Lg*N): pilot AM envelope
    level = jnp.mean(env, axis=-1)
    # Least-squares matched fit [DC, cos, sin] per candidate instead of a
    # naive cos/sin projection: the ident tones are SLOW against a frame
    # (stereo fh/133 spans only ~0.5 cycle over 64 rows), so the basis is
    # far from orthogonal over the window and the plain projection's bias
    # swings with the ident's starting phase — at some absolute rows the
    # WRONG ident won on a noise-free signal (round-4 full-stack probe,
    # odd frame0).  Solving the 3x3 normal equations handles the
    # non-orthogonality exactly; the fitted amplitude is phase-agnostic
    # and reads the true 0.5*PILOT_DEV/snd_dev = 0.025 at every offset.
    powers, resid = {}, {}
    for mode in ("stereo", "dual"):
        ph = _ident_phase_rows(a2p, mode, rows).reshape(bg, lg * n)
        g = jnp.stack(
            [jnp.ones_like(ph), jnp.cos(ph), jnp.sin(ph)], axis=-1
        )                                     # (Bg, T, 3)
        a = jnp.einsum("bti,btj->bij", g, g) / (lg * n)
        c = jnp.einsum("bti,bt->bi", g, env) / (lg * n)
        coef = jnp.linalg.solve(a, c[..., None])[..., 0]  # (Bg, 3)
        powers[mode] = jnp.sqrt(coef[:, 1] ** 2 + coef[:, 2] ** 2)
        # normalized residual power of the fit: mean(env^2) - c . coef
        resid[mode] = jnp.mean(env * env, axis=-1) - jnp.sum(
            c * coef, axis=-1
        )
    if group > 1:
        level = jnp.repeat(level, group)
        powers = {k: jnp.repeat(v, group) for k, v in powers.items()}
        resid = {k: jnp.repeat(v, group) for k, v in resid.items()}
    return level, powers, resid


def _decode_arrays(a2p: A2Plan, rf, frame0, group: int = 1):
    """The array-compute half of :func:`a2_decode` (both takeoffs, mode
    statistics, audio low-passing) — split out so it can self-jit off-CPU
    (utils/jitwrap note)."""
    rfp = a2p.rfp
    b, l, _ = rf.shape
    m, _ = _takeoff(a2p, rf, a2p.bpf1, rfp.snd_ramp, frame0)
    raw2, c2_level = _takeoff(a2p, rf, a2p.bpf2, a2p.snd2_ramp, frame0,
                              sign=_carrier2_sign(a2p, frame0, b, l))
    pilot, powers, resid = a2_detect_mode(a2p, raw2, frame0, b, l, group)
    m = fir_same_fft(m, rfp.aud_lpf)
    r2 = fir_same_fft(raw2, rfp.aud_lpf)     # aud_lpf also strips the pilot
    return m, r2, c2_level, pilot, powers, resid


def a2_decode(a2p: A2Plan, rf, frame0=0, group: int = 1):
    """RF block -> (left, right, info): the full A2 receiver.

    Dematrixes with the DETECTED mode: stereo -> (2M - R, R); dual ->
    both programs as-is (left = program 1, right = program 2); mono ->
    both channels carry carrier 1.  ``info`` holds the per-batch-item
    pilot level, ident powers, and the decided mode string per item.

    ``group``: mode-detection window in consecutive batch items (pass 2
    for interlaced field pairs — see :func:`a2_detect_mode`).
    """
    b = rf.shape[0]
    m, r2, c2_level, pilot, powers, resid = _decode_arrays(
        a2p, rf, frame0, group
    )
    c2 = np.asarray(c2_level)
    p_st = np.asarray(powers["stereo"])
    p_du = np.asarray(powers["dual"])
    r_st = np.asarray(resid["stereo"])
    r_du = np.asarray(resid["dual"])
    modes = []
    left = np.asarray(m).copy()
    right = np.asarray(m).copy()
    r2_np = np.asarray(r2)
    for ib in range(b):
        if c2[ib] < 0.3 * a2p.amp2:          # no second carrier -> mono
            modes.append("mono")
        elif r_st[ib] <= r_du[ib]:           # smaller matched-fit residual
            modes.append("stereo")
            left[ib] = 2.0 * left[ib] - r2_np[ib]
            right[ib] = r2_np[ib]
        else:
            modes.append("dual")
            right[ib] = r2_np[ib]
    info = {"mode": modes, "carrier2_level": c2,
            "pilot_level": np.asarray(pilot),
            "ident_power": {"stereo": p_st, "dual": p_du},
            "ident_resid": {"stereo": r_st, "dual": r_du}}
    return left, right, info


# --- public-entry jit (one compiled program per call; utils/jitwrap) ---
# The takeoff/detect compute is wrapped; a2_on_rf/a2_multiplex are real
# elementwise and stay plain.
from color_modem_tpu.utils.jitwrap import plan_jit as _plan_jit

_decode_arrays = _plan_jit(_decode_arrays, static=("group",))
