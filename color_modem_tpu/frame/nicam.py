"""NICAM-728 digital stereo sound (beyond-reference).

The 625-line world's digital companion to the analog BTSC multiplex in
:mod:`color_modem_tpu.frame.mts`: NICAM 728 (EN 300 163) carries
near-instantaneously companded 14-bit stereo as a 728-bit/ms DQPSK
stream on its own carrier next to the FM sound carrier.  This module
implements the full digital chain —

    float audio -> 14-bit PCM -> per-block companding (10-bit mantissa +
    3-bit scale factor) -> parity with SIGNALLING-IN-PARITY scale-factor
    transport -> 44x16 bit interleave -> PRBS scrambler -> frame
    assembly (FAW + control + data) -> DQPSK at ~364 kBd on a 5.85 MHz
    carrier -> and all the way back, including FAW frame-alignment
    search and majority-decoded scale factors.

Reference parity: the upstream library (SURVEY.md §2.1, mount empty
§0.1) has no sound subsystem at all; this mirrors the MTS/BTSC module
for PAL/SECAM markets.

Deviations from EN 300 163, all documented here and only where this
framework's clocking philosophy differs:

* **Symbol rate locks to the sample grid**: real NICAM clocks 364 kBd
  from its own crystal; here a symbol is exactly ``round(fs/364e3)``
  samples (37 at 13.5 MHz -> 364.86 kBd) so symbol centers are exact
  integers — the same design decision as the closed-form subcarrier NCO
  (no fractional-delay resampler in the hot loop, nothing to drift).
  The frame is still 728 bits; audio blocks are still 32 samples/ms
  nominal.
* **Scale-factor grouping**: the 3 scale bits per channel are signalled
  by XOR into the parity bits of 3 sample groups (11/11/10 of the
  channel's 32) and majority-decoded; EN 300 163 distributes them over
  a 54-sample pattern shared between channels.  Structure and error
  behavior (parity still works per-sample, scale survives bit errors by
  majority) are the real thing; the exact distribution table is not.
* Transmitter and receiver share the sample clock (as
  :mod:`frame.mts` documents for the pilot), so symbol TIMING is known;
  carrier PHASE is not assumed — DQPSK is differential, and tests drive
  a random static carrier phase.  Frame ALIGNMENT is not assumed either:
  the decoder finds the FAW by correlation over all 364 symbol offsets
  in one batched matmul.

Array shape: companding is exponent arithmetic on int32 vectors; parity,
interleave, scrambler and DQPSK mapping are pure gather/XOR ops over
``(frames, 728)`` int arrays; the passband is one complex mix + FIR.
No per-sample or per-frame Python loops anywhere.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp.apply import fir_same_fft
from color_modem_tpu.modem.plan import ModemPlan

TWO_PI = 2.0 * np.pi

#: frame structure (EN 300 163): FAW + 5 control + 11 additional data,
#: then 64 samples x 11 bits of sound
FAW = (0, 1, 0, 0, 1, 1, 1, 0)
N_CONTROL = 5
N_AD = 11
N_HEADER = len(FAW) + N_CONTROL + N_AD      # 24
N_SOUND = 704                                # 64 * 11
FRAME_BITS = N_HEADER + N_SOUND              # 728
SYMBOLS_PER_FRAME = FRAME_BITS // 2          # 364

#: audio geometry: 32 samples per channel per frame (32 kHz nominal)
BLOCK = 32

#: nominal NICAM-I sound carrier offset used as the default passband
CARRIER_HZ = 5.85e6
NOMINAL_BAUD = 364e3

#: companding: 14-bit PCM to 10-bit mantissa, shifts 0..4 (5 ranges)
PCM_BITS = 14
MANT_BITS = 10
MAX_SHIFT = 4


# ---------------------------------------------------------------------------
# Companding (near-instantaneous, per 32-sample block)
# ---------------------------------------------------------------------------


def _quantize14(x: jax.Array) -> jax.Array:
    s = jnp.clip(jnp.round(jnp.asarray(x, jnp.float32) * 8192.0),
                 -8192, 8191)
    return s.astype(jnp.int32)


def compand(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(..., n_blocks, 32) float audio -> (10-bit mantissas, shifts).

    The shift is the per-block number of discarded LSBs: 0 for quiet
    blocks (the 14-bit sample already fits 10 bits — lossless), up to 4
    for full-scale blocks (top 10 of 14 bits kept)."""
    s = _quantize14(x)
    peak = jnp.max(jnp.abs(s), axis=-1, keepdims=True)
    # smallest shift with round(s / 2^shift) in [-512, 511]
    shift = jnp.zeros_like(peak)
    for k in range(1, MAX_SHIFT + 1):
        shift = jnp.where(peak > (512 << (k - 1)) - 1, k, shift)
    mant = jnp.clip(
        jnp.round(s.astype(jnp.float32) / (1 << shift).astype(jnp.float32)),
        -512, 511,
    ).astype(jnp.int32)
    return mant, shift[..., 0]


def expand(mant: jax.Array, shift: jax.Array) -> jax.Array:
    """Inverse of :func:`compand` -> float audio in [-1, 1]."""
    s = mant.astype(jnp.float32) * (1 << shift).astype(jnp.float32)[..., None]
    return s / 8192.0


# ---------------------------------------------------------------------------
# Bit plumbing: parity + signalling-in-parity, interleave, scrambler
# ---------------------------------------------------------------------------

#: per-channel sample-group boundaries carrying the 3 scale bits
_SF_GROUPS = ((0, 11), (11, 22), (22, 32))


def _sound_bits(mant: jax.Array, shift: jax.Array) -> jax.Array:
    """(F, 64) mantissas + (F, 2) shifts -> (F, 704) sound bits.

    Samples interleave A1 B1 A2 B2 ... (mant is already in transmission
    order — see :func:`nicam_frames`); each sample is 10 bits MSB-first
    (two's complement) + 1 parity bit over the 6 MSBs, with the channel's
    scale bits XORed into its groups' parity bits."""
    u = (mant & 0x3FF).astype(jnp.int32)                       # 10-bit field
    shifts = jnp.arange(MANT_BITS - 1, -1, -1, dtype=jnp.int32)
    bits = (u[..., None] >> shifts) & 1                        # (F, 64, 10)
    parity = jnp.sum(bits[..., :6], axis=-1) % 2               # even over MSBs
    # scale bits ride the parity: sample 2k is channel A, 2k+1 channel B
    sf = ((shift[..., None] >> jnp.arange(2, -1, -1)) & 1)     # (F, 2, 3)
    k = jnp.arange(64) // 2                                    # in-channel idx
    chan = jnp.arange(64) % 2
    group = jnp.select(
        [k < _SF_GROUPS[0][1], k < _SF_GROUPS[1][1]], [0, 1], 2
    )
    mark = sf[:, chan, group]                                  # (F, 64)
    parity = (parity + mark) % 2
    return jnp.concatenate([bits, parity[..., None]], axis=-1).reshape(
        mant.shape[:-1] + (N_SOUND,)
    )


def _parse_sound_bits(bits: jax.Array):
    """(F, 704) -> (mant (F, 64), shifts (F, 2), parity_err (F, 64)).

    Scale bits come back by majority over each group's parity residue;
    the residue left AFTER removing the decoded scale bit is the real
    per-sample parity error flag."""
    b = bits.reshape(bits.shape[:-1] + (64, MANT_BITS + 1))
    shifts = jnp.arange(MANT_BITS - 1, -1, -1, dtype=jnp.int32)
    u = jnp.sum(b[..., :MANT_BITS] << shifts, axis=-1)
    mant = jnp.where(u >= 512, u - 1024, u)                    # sign-extend
    parity = jnp.sum(b[..., :6], axis=-1) % 2
    residue = (parity + b[..., MANT_BITS]) % 2                 # (F, 64)
    k = jnp.arange(64) // 2
    chan = jnp.arange(64) % 2
    group = jnp.select(
        [k < _SF_GROUPS[0][1], k < _SF_GROUPS[1][1]], [0, 1], 2
    )
    sf_bits = []
    for c in range(2):
        per_group = []
        for g, (lo, hi) in enumerate(_SF_GROUPS):
            sel = (chan == c) & (group == g)
            votes = jnp.sum(residue * sel, axis=-1)
            per_group.append((votes * 2 > (hi - lo)).astype(jnp.int32))
        sf_bits.append(per_group)
    shift = jnp.stack(
        [sf_bits[c][0] * 4 + sf_bits[c][1] * 2 + sf_bits[c][2]
         for c in range(2)],
        axis=-1,
    )
    shift = jnp.minimum(shift, MAX_SHIFT)
    decoded_mark = jnp.stack(
        [sf_bits[c][g] for c in range(2) for g in range(3)], axis=-1
    ).reshape(bits.shape[:-1] + (2, 3))[..., chan, group]
    err = (residue + decoded_mark) % 2
    return mant, shift, err


def _interleave_order() -> np.ndarray:
    """Transmission order of the 704 sound bits: written into a 44x16
    matrix row-wise, read column-wise (EN 300 163's bit interleave —
    adjacent stream bits land 16 apart, so a DQPSK symbol error never
    hits two bits of one sample)."""
    return np.arange(N_SOUND).reshape(44, 16).T.reshape(-1)


_ILV = _interleave_order()
_DILV = np.argsort(_ILV)


@functools.lru_cache(maxsize=1)
def _prbs() -> np.ndarray:
    """720-bit scrambler sequence: x^9 + x^4 + 1, seed all-ones,
    restarted every frame after the FAW (so frames descramble
    independently — any frame can be decoded without history)."""
    reg = [1] * 9
    out = []
    for _ in range(FRAME_BITS - len(FAW)):
        bit = reg[8] ^ reg[3]
        out.append(reg[8])
        reg = [bit] + reg[:8]
    return np.asarray(out, np.int32)


# ---------------------------------------------------------------------------
# Frame assembly / parse
# ---------------------------------------------------------------------------


def nicam_frames(left: jax.Array, right: jax.Array,
                 control: int = 0b00000) -> jax.Array:
    """Stereo audio -> (F, 728) transmission bit frames.

    ``left``/``right``: float audio in [-1, 1], length a multiple of 32
    (one block per frame and channel).  Companding, parity/signalling,
    interleave and scrambling all happen batched over frames."""
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    if left.shape != right.shape or left.ndim != 1:
        raise ValueError(f"left/right must be equal-length 1-D, got "
                         f"{left.shape} vs {right.shape}")
    if left.shape[0] % BLOCK:
        raise ValueError(f"audio length must be a multiple of {BLOCK}, "
                         f"got {left.shape[0]}")
    n_frames = left.shape[0] // BLOCK
    la, ls = compand(left.reshape(n_frames, BLOCK))
    ra, rs = compand(right.reshape(n_frames, BLOCK))
    # transmission sample order A1 B1 A2 B2 ...
    mant = jnp.stack([la, ra], axis=-1).reshape(n_frames, 2 * BLOCK)
    shift = jnp.stack([ls, rs], axis=-1)
    sound = _sound_bits(mant, shift)
    sound = sound[..., jnp.asarray(_ILV)]
    cbits = jnp.broadcast_to(
        jnp.asarray([(control >> (N_CONTROL - 1 - i)) & 1
                     for i in range(N_CONTROL)], jnp.int32),
        (n_frames, N_CONTROL),
    )
    ad = jnp.zeros((n_frames, N_AD), jnp.int32)
    payload = jnp.concatenate([cbits, ad, sound], axis=-1)
    payload = (payload + jnp.asarray(_prbs())) % 2
    faw = jnp.broadcast_to(jnp.asarray(FAW, jnp.int32),
                           (n_frames, len(FAW)))
    return jnp.concatenate([faw, payload], axis=-1)


def parse_frames(frames: jax.Array):
    """(F, 728) received bits -> (left, right, report dict).

    Inverse of :func:`nicam_frames`; parity errors conceal the affected
    sample by zeroing its mantissa LSB trust — here we keep the sample
    (mantissa errors are audible noise, exactly like a real receiver
    before error concealment) and just report the count."""
    f = jnp.asarray(frames, jnp.int32)
    payload = (f[..., len(FAW):] + jnp.asarray(_prbs())) % 2
    control = payload[..., :N_CONTROL]
    sound = payload[..., N_CONTROL + N_AD:]
    sound = sound[..., jnp.asarray(_DILV)]
    mant, shift, err = _parse_sound_bits(sound)
    pairs = mant.reshape(mant.shape[:-1] + (BLOCK, 2))
    left = expand(pairs[..., 0], shift[..., 0]).reshape(-1)
    right = expand(pairs[..., 1], shift[..., 1]).reshape(-1)
    faw_ok = jnp.all(f[..., :len(FAW)] == jnp.asarray(FAW, jnp.int32),
                     axis=-1)
    return left, right, {
        "faw_ok": faw_ok,
        "control": control,
        "parity_errors": jnp.sum(err, axis=-1),
    }


# ---------------------------------------------------------------------------
# DQPSK passband
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class NicamPlan:
    # eq=False: hash by identity so the plan can be a jax.jit static
    # argument (utils/jitwrap) — the generated field-wise __hash__ would
    # choke on the numpy taps (same convention as RFPlan/ModemPlan)

    fs: float               # sample rate (the composite grid's)
    fc: float               # carrier, Hz
    spb: int                # samples per symbol (integer by design)
    shaping: np.ndarray     # TX pulse-shaping lowpass taps
    matched: np.ndarray     # RX matched lowpass taps

    @property
    def baud(self) -> float:
        return self.fs / self.spb


def _rrc_taps(spb: int, beta: float = 1.0, span: int = 8) -> np.ndarray:
    """Root-raised-cosine pulse: half at TX, half at RX multiplies to an
    ISI-free raised cosine at the symbol centers (integer grid, so the
    zero crossings are exact).  Smaller ``beta`` needs a longer ``span``
    for the tails to die out."""
    if beta < 0.9:
        span = max(span, 16)
    ntaps = span * spb + 1
    t = (np.arange(ntaps) - ntaps // 2) / spb
    num = np.cos((1 + beta) * np.pi * t) + np.sinc(
        (1 - beta) * t
    ) * (1 - beta) * np.pi / (4 * beta)
    den = 1 - (4 * beta * t) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        h = num / den
    # singular points of the RRC closed form
    sing = np.isclose(np.abs(den), 0.0)
    h[sing] = beta / 2 * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))
    )
    return (h / np.sum(h)).astype(np.float64)


def make_nicam_plan(plan: ModemPlan, fc: float = CARRIER_HZ) -> NicamPlan:
    """Symbol grid + raised-cosine-split shaping on the composite rate."""
    fs = plan.fs
    spb = int(round(fs / NOMINAL_BAUD))
    if fs / 2.0 <= fc + 1.2 * NOMINAL_BAUD:
        raise ValueError(
            f"carrier {fc/1e6:.2f} MHz + sidebands exceeds Nyquist at "
            f"fs={fs/1e6:.2f} MHz"
        )
    h = _rrc_taps(spb)
    return NicamPlan(fs=fs, fc=fc, spb=spb, shaping=h, matched=h)


#: Gray-coded DQPSK phase increments for dibit (b0, b1)
_DQPSK_PHASE = {  # dibit value b0*2+b1 -> phase step (radians)
    0: 0.0,
    1: -np.pi / 2,
    3: np.pi,
    2: np.pi / 2,
}


def _tail_symbols(nplan: NicamPlan) -> int:
    """Silent tail symbols so the last real symbol keeps full pulse
    support under the 'same'-mode matched filter (half the pulse span)."""
    return len(nplan.shaping) // (2 * nplan.spb) + 1


def nicam_modulate(nplan: NicamPlan, frames: jax.Array,
                   carrier_phase: float = 0.0) -> jax.Array:
    """(F, 728) bit frames -> (n,) real passband at ``nplan.fs``.

    Differential QPSK: the dibit selects a phase INCREMENT off a
    prepended reference symbol, so the receiver needs no absolute
    carrier phase and no bit is lost to differential startup.
    ``carrier_phase`` models a transmitter whose carrier is rotated
    relative to the receiver's mixers (DQPSK must not care)."""
    f = jnp.asarray(frames, jnp.int32).reshape(-1, 2)
    dibit = f[:, 0] * 2 + f[:, 1]
    step = jnp.asarray(
        [_DQPSK_PHASE[k] for k in range(4)], jnp.float32
    )[dibit]
    sym_phase = jnp.cumsum(step)
    # real (i, q) pair instead of a complex phasor: the complex numbers
    # would only ever carry (cos, sin) pairs
    zi = jnp.concatenate([jnp.ones(1, jnp.float32), jnp.cos(sym_phase)])
    zq = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.sin(sym_phase)])
    n_sym = zi.shape[0] + _tail_symbols(nplan)
    # impulse trains at symbol centers, shaped by the TX RRC
    upi = jnp.zeros(n_sym * nplan.spb, jnp.float32)
    upq = jnp.zeros(n_sym * nplan.spb, jnp.float32)
    upi = upi.at[: zi.shape[0] * nplan.spb : nplan.spb].set(zi)
    upq = upq.at[: zq.shape[0] * nplan.spb : nplan.spb].set(zq)
    i = fir_same_fft(upi, nplan.shaping) * nplan.spb
    q = fir_same_fft(upq, nplan.shaping) * nplan.spb
    n = i.shape[0]
    w = (TWO_PI * nplan.fc / nplan.fs * jnp.arange(n, dtype=jnp.float32)
         + jnp.float32(carrier_phase))
    return i * jnp.cos(w) - q * jnp.sin(w)


def _symbol_samples(nplan: NicamPlan, x: jax.Array):
    """Passband -> symbol-rate (i, q) pair (known timing grid; real
    arrays — see nicam_modulate's eager-complex note)."""
    n = x.shape[-1]
    w = TWO_PI * nplan.fc / nplan.fs * jnp.arange(n, dtype=jnp.float32)
    # single padded transform, NOT overlap-save: measured in the fused
    # rf-sound row, blocking the matched filter cost the whole row ~6
    # Mpix/s where the giant transform fused better (round-5 whole-row
    # bisect — the aud_lpf stage measured the OPPOSITE; in-context
    # fusion decides, not the standalone stage time)
    zi = fir_same_fft(x * (2.0 * jnp.cos(w)), nplan.matched)
    zq = fir_same_fft(x * (-2.0 * jnp.sin(w)), nplan.matched)
    return zi[..., :: nplan.spb], zq[..., :: nplan.spb]


def nicam_demodulate(
    nplan: NicamPlan, x: jax.Array, n_frames: int | None = None
):
    """Real passband -> (bit frames (F, 728), lock report).

    Differential detect (``z * conj(z_prev)``), then FAW frame-alignment
    search: the descrambler-independent FAW bits are correlated at all
    364 symbol offsets in one matmul; the peak sets the frame boundary.
    Works with any static carrier phase (differential) and any integer
    symbol offset (the search)."""
    zi, zq = _symbol_samples(nplan, x)
    # d = z[1:] * conj(z[:-1]) in real arithmetic (eager-complex note)
    dre = zi[..., 1:] * zi[..., :-1] + zq[..., 1:] * zq[..., :-1]
    dim = zq[..., 1:] * zi[..., :-1] - zi[..., 1:] * zq[..., :-1]
    ang = jnp.arctan2(dim, dre)
    quad = jnp.round(ang / (np.pi / 2)).astype(jnp.int32) % 4
    # inverse of _DQPSK_PHASE: quadrant q (step q*90deg) -> dibit
    dibit = jnp.asarray([0, 2, 3, 1], jnp.int32)[quad]
    b0, b1 = dibit // 2, dibit % 2
    bits = jnp.stack([b0, b1], axis=-1).reshape(-1)
    # FAW search over all symbol (2-bit) offsets, one gather + reduce
    n_total = bits.shape[0]
    max_frames = n_total // FRAME_BITS
    if n_frames is None:
        n_frames = max_frames - 1 if max_frames > 1 else max_frames
    pm = 1 - 2 * bits.astype(jnp.float32)          # 0/1 -> +1/-1
    fm = 1 - 2 * jnp.asarray(FAW, jnp.float32)
    offs = jnp.arange(0, FRAME_BITS, 2)[:, None, None]
    idx = (offs + jnp.arange(n_frames)[None, :, None] * FRAME_BITS
           + jnp.arange(len(FAW))[None, None, :])
    fits = idx[:, -1, -1] < n_total
    scores = jnp.where(
        fits,
        jnp.sum(pm[jnp.clip(idx, 0, n_total - 1)] * fm, axis=(1, 2)),
        -jnp.inf,
    )
    best = jnp.argmax(scores)
    off = best * 2
    fidx = (off + jnp.arange(n_frames)[:, None] * FRAME_BITS
            + jnp.arange(FRAME_BITS))
    frames = bits[jnp.clip(fidx, 0, n_total - 1)]
    return frames, {"offset_bits": off, "faw_score": scores[best],
                    "n_frames": n_frames}


# ---------------------------------------------------------------------------
# Riding the RF layer: NICAM next to the FM sound carrier
# ---------------------------------------------------------------------------

#: NICAM carrier offset above the FM SOUND carrier.  The real channel
#: plans put NICAM 0.35 MHz (B/G, 5.5->5.85) or 0.552 MHz (I, 6.0->6.552)
#: above FM sound; this framework's transparency-mode RF geometry floats
#: the sound carrier with the video band (frame/rf.py), so NICAM is
#: placed relative to it the same way.  0.5 MHz clears the FM Carson
#: band (~130 kHz) plus NICAM's own 0.4-rolloff sideband (~255 kHz).
RF_OFFSET_HZ = 0.5e6

#: NICAM carrier amplitude relative to the RF layer's units (real spec:
#: -20 dB vs peak vision carrier; ENV_BLANK is 0.75 of our unit scale)
RF_AMP = 0.075

#: spectral roll-off on the RF channel (EN 300 163 System B/G: 0.4)
RF_BETA = 0.4


def make_nicam_rf_plan(rfp, offset: float = RF_OFFSET_HZ) -> NicamPlan:
    """A NICAM plan living on the RF sample grid, carrier at
    ``FM sound + offset`` — generated directly at the RF rate, so no
    bandpass resampling is ever needed (same reasoning as the RF layer's
    own closed-form carriers).

    The RECEIVER's matched filter is the RRC composed with a sharp
    channel-selection lowpass: the FM sound carrier sits only 0.5 MHz
    below NICAM at 2.7x its amplitude (snd_amp 0.2 vs RF_AMP 0.075), and
    the bare RRC's slow stopband let it through at symbol-error level
    when both were transmitted (round-4 full-stack probe: 71 parity
    errors on a clean channel).  The selector is flat across NICAM's
    (1+beta)*baud/2 ~ 255 kHz band — the raised-cosine ISI nulls at the
    symbol centers survive to its ripple — and is ~60 dB down at the FM
    Carson band's near edge, exactly the adjacent-sound selectivity a
    real NICAM tuner front end provides."""
    fs_rf = rfp.fs_rf
    fc = rfp.f_snd + offset
    half = (1 + RF_BETA) * NOMINAL_BAUD / 2
    snd_half = 2.0 * (rfp.snd_dev + 15e3)
    if fc - half < rfp.f_snd + snd_half:
        raise ValueError(
            f"NICAM at {fc/1e6:.2f} MHz overlaps the FM sound Carson "
            f"band — raise offset (>= {((snd_half + half))/1e6:.2f} MHz)"
        )
    if fs_rf / 2.0 <= fc + 1.5 * half:
        raise ValueError(
            f"NICAM at {fc/1e6:.2f} MHz exceeds Nyquist at the RF rate "
            f"{fs_rf/1e6:.1f} MHz — raise r"
        )
    spb = int(round(fs_rf / NOMINAL_BAUD))
    h = _rrc_taps(spb, beta=RF_BETA)
    from color_modem_tpu.dsp import design

    # channel selector at complex baseband: pass NICAM's own sidebands
    # (to ~half + 25 kHz), stop by the FM carrier's Carson band edge
    # (offset - snd_half); the FM carrier lands at -offset after the mix
    sel = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(
            f, 0.0, half + 25e3, max(offset - snd_half - half - 50e3, 60e3)
        ),
        8193,
    )
    return NicamPlan(fs=fs_rf, fc=fc, spb=spb, shaping=h,
                     matched=np.convolve(h, sel))


def _head_samples(nplan: NicamPlan) -> int:
    """Guard before the burst inside an RF block, whole symbols: half the
    RX matched+selector span, so even the REFERENCE symbol sees the
    interferers with full filter support.  A burst starting at the block
    edge put the reference symbol where the truncated 'same' window
    loses its FM-carrier rejection — the first differential angle landed
    on the +-45 deg decision boundary and one flipped FAW bit sent the
    frame-alignment search to a spurious offset (round-4 full-stack
    probe).  A real NICAM stream is continuous and has no cold start;
    the guard is this windowed model's equivalent."""
    half_sym = len(nplan.matched) // (2 * nplan.spb) + 1
    return half_sym * nplan.spb


def nicam_capacity(rfp, rf_shape: tuple) -> int:
    """How many whole NICAM frames fit in an RF block of ``rf_shape``
    (B, L, N*r) — 728 bits per ~1 ms, so a 64-line block carries ~4."""
    nplan = make_nicam_rf_plan(rfp)
    n_total = rf_shape[-2] * rf_shape[-1]
    per_frame = SYMBOLS_PER_FRAME * nplan.spb
    overhead = (1 + _tail_symbols(nplan)) * nplan.spb + _head_samples(nplan)
    return max(0, (n_total - overhead) // per_frame)


def nicam_on_rf(rfp, rf: jax.Array, left, right) -> jax.Array:
    """Add the NICAM carrier to an RF block (B, L, N*r).

    Audio length must be ``32 * nicam_capacity(...)`` per channel; the
    digital burst occupies the front of the block (a real transmitter
    runs continuously — a block here is a window of that stream)."""
    nplan = make_nicam_rf_plan(rfp)
    b, l, nr = rf.shape
    frames = nicam_frames(left, right)
    x = nicam_modulate(nplan, frames)
    head = _head_samples(nplan)  # symbol-aligned guard (see _head_samples)
    if head + x.shape[0] > l * nr:
        raise ValueError(
            f"{frames.shape[0]} NICAM frames need {head + x.shape[0]} RF "
            f"samples, block has {l * nr} — see nicam_capacity"
        )
    pad = jnp.zeros(l * nr - x.shape[0] - head, jnp.float32)
    burst = jnp.concatenate([jnp.zeros(head, jnp.float32), x, pad])
    return rf + RF_AMP * burst.reshape(l, nr)[None]


def nicam_from_rf(rfp, rf: jax.Array, n_frames: int):
    """Recover (left, right, report, lock) from an RF block's row 0
    batch element (B > 1 blocks decode their own streams separately;
    pass ``rf[k]`` reshaped if needed)."""
    nplan = make_nicam_rf_plan(rfp)
    stream = rf.reshape(rf.shape[0], -1)[0]
    rx_frames, lock = nicam_demodulate(nplan, stream, n_frames=n_frames)
    left, right, rep = parse_frames(rx_frames)
    return left, right, rep, lock


# ---------------------------------------------------------------------------
# Top-level convenience
# ---------------------------------------------------------------------------


def nicam_roundtrip(plan: ModemPlan, left, right, *,
                    noise_sigma: float = 0.0,
                    carrier_phase: float = 0.0,
                    key: jax.Array | None = None):
    """Encode, optionally impair, decode.  Returns (left, right, report).

    ``noise_sigma`` is relative to the transmitted signal's RMS;
    ``carrier_phase`` rotates the transmitter's carrier against the
    receiver's mixers (DQPSK must shrug it off)."""
    nplan = make_nicam_plan(plan)
    frames = nicam_frames(left, right)
    x = nicam_modulate(nplan, frames, carrier_phase=carrier_phase)
    if noise_sigma > 0.0:
        if key is None:
            key = jax.random.PRNGKey(0)
        rms = jnp.sqrt(jnp.mean(x * x))
        x = x + noise_sigma * rms * jax.random.normal(key, x.shape)
    rx_frames, lock = nicam_demodulate(nplan, x, n_frames=frames.shape[0])
    return parse_frames(rx_frames) + (lock,)


# --- public-entry jit (one compiled program per call; utils/jitwrap) ---
# Every NICAM passband path (fir_same_fft filtering) is wrapped.  The bit
# plumbing (compand, frames, parse) is int math and stays eager.
from color_modem_tpu.utils.jitwrap import plan_jit as _plan_jit

nicam_modulate = _plan_jit(nicam_modulate, static=("carrier_phase",))
nicam_demodulate = _plan_jit(nicam_demodulate, static=("n_frames",))
nicam_on_rf = _plan_jit(nicam_on_rf)
nicam_from_rf = _plan_jit(nicam_from_rf, static=("n_frames",))
