"""VITC — vertical interval timecode (SMPTE 12M-shaped, beyond-reference).

The last classic VBI data service next to captions (frame/vbi.py),
teletext (frame/teletext.py) and WSS (frame/wss.py): a 90-bit NRZ word on
a vertical-interval line carrying the tape timecode, readable at any
shuttle speed because every frame's address rides inside the frame
itself.  The reference has nothing like it (SURVEY.md §2.1); the layout
here follows the published SMPTE 12M shape [MEM-M] and is documented
where memory is uncertain:

* 90 bits = 9 groups of 10: a "1 0" sync pair then 8 payload bits.
  Groups 0-7 carry (4 timecode bits | 4 binary-group/user bits); group 8
  carries the CRC byte.
* Timecode nibbles are BCD: frame units/tens (+ drop-frame, color-frame
  flags), seconds, minutes, hours (+ field flag) — the LTC bit
  assignment, transplanted into the VITC groups.
* CRC-8 with generator x^8 + 1 over bits 0..81: since x^8 == 1 mod
  (x^8+1), the remainder is the XOR of the message folded into 8-bit
  columns (bit k contributes to column k mod 8) — one reduction, no
  shift register.
* Bit rate 115 x fh (~1.81 MHz on 525 — the published figure), ~7.5
  samples/bit on the 13.5 MHz grid.

Unlike the run-in services in frame/vbi.py, VITC has NO clock run-in —
receivers time off the nine embedded sync pairs.  The decoder here does
the same, as one array program: it slices the line at a GRID of candidate clock
phases in one batched gather, scores each phase by sync-pair matches, and
argmax-picks — the same all-offsets-at-once pattern as teletext's frame
alignment search (frame/teletext.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp import design
from color_modem_tpu.dsp.apply import fir_same
from color_modem_tpu.modem.plan import ModemPlan

N_BITS = 90
N_GROUPS = 9
#: bit positions of the "1 0" sync pairs (start of each group)
SYNC_ONES = tuple(10 * g for g in range(N_GROUPS))
SYNC_ZEROS = tuple(10 * g + 1 for g in range(N_GROUPS))
#: leading guard before bit 0, samples at the 13.5 MHz grid (scaled by fs)
GUARD_FRAC = 0.02


def _crc8(bits82: np.ndarray) -> np.ndarray:
    """x^8 + 1 remainder: XOR-fold the message into 8 columns."""
    crc = np.zeros(8, dtype=np.int64)
    for k, b in enumerate(bits82):
        crc[k % 8] ^= int(b)
    return crc


def vitc_pack(
    hours: int, minutes: int, seconds: int, frames: int,
    *, drop_frame: bool = False, field: bool = False,
    user: tuple = (0,) * 8,
) -> np.ndarray:
    """Timecode -> the 90-bit VITC word (host config data, like cc_pack).

    ``user``: 8 binary-group nibbles (0..15 each).  Bits within each
    nibble are LSB-first, the LTC convention.
    """
    if not (0 <= hours < 24 and 0 <= minutes < 60 and 0 <= seconds < 60
            and 0 <= frames < 60):
        raise ValueError(f"bad timecode {hours}:{minutes}:{seconds}:{frames}")
    digits = [
        frames % 10,                                 # group 0: frame units
        (frames // 10) | (0x4 if drop_frame else 0),  # group 1: tens+flags
        seconds % 10,
        seconds // 10 | (0x8 if field else 0),       # group 3: tens+field
        minutes % 10,
        minutes // 10,
        hours % 10,
        hours // 10,
    ]
    bits = np.zeros(N_BITS, dtype=np.int64)
    for g in range(8):
        base = 10 * g
        bits[base] = 1                                # sync "1 0"
        for i in range(4):                            # 4 timecode bits, LSB first
            bits[base + 2 + i] = (digits[g] >> i) & 1
        for i in range(4):                            # 4 user bits
            bits[base + 6 + i] = (int(user[g]) >> i) & 1
    bits[80] = 1                                      # CRC group sync
    bits[82:90] = _crc8(bits[:82])
    return bits


def vitc_unpack(bits) -> dict:
    """90 received bits -> decoded timecode + validity flags."""
    b = np.asarray(bits, dtype=np.int64)
    sync_ok = bool(
        np.all(b[list(SYNC_ONES)] == 1) and np.all(b[list(SYNC_ZEROS)] == 0)
    )
    crc_ok = bool(np.all(_crc8(b[:82]) == b[82:90]))
    digits = []
    user = []
    for g in range(8):
        base = 10 * g
        digits.append(int(sum(b[base + 2 + i] << i for i in range(4))))
        user.append(int(sum(b[base + 6 + i] << i for i in range(4))))
    return {
        "hours": (digits[7] & 0x3) * 10 + digits[6],
        "minutes": (digits[5] & 0x7) * 10 + digits[4],
        "seconds": (digits[3] & 0x7) * 10 + digits[2],
        "frames": (digits[1] & 0x3) * 10 + digits[0],
        "drop_frame": bool(digits[1] & 0x4),
        "field": bool(digits[3] & 0x8),
        "user": tuple(user),
        "sync_ok": sync_ok,
        "crc_ok": crc_ok,
    }


def _geometry(plan: ModemPlan):
    f_bit = 115.0 * plan.cfg.fh
    spb = plan.fs / f_bit
    guard = GUARD_FRAC * plan.n_samples
    if guard + N_BITS * spb > plan.n_samples:
        raise ValueError(
            f"VITC needs {guard + N_BITS * spb:.0f} samples, line has "
            f"{plan.n_samples}"
        )
    return spb, guard


def encode_vitc_line(plan: ModemPlan, bits: jax.Array,
                     level: float = 0.8) -> jax.Array:
    """(..., 90) bits -> (..., N) VITC line waveform in luma units."""
    bits = jnp.asarray(bits)
    if bits.shape[-1] != N_BITS:
        raise ValueError(f"expected {N_BITS} bits, got {bits.shape[-1]}")
    spb, guard = _geometry(plan)
    m = np.arange(plan.n_samples, dtype=np.float64)
    cell = np.floor((m - guard) / spb).astype(np.int64)
    in_pay = (cell >= 0) & (cell < N_BITS)
    sel = jnp.asarray(np.clip(cell, 0, N_BITS - 1))
    wave = jnp.where(
        jnp.asarray(in_pay), bits[..., sel].astype(jnp.float32), 0.0
    ) * jnp.float32(level)
    taps = design.lowpass_taps(plan.fs, 1.4 * 115.0 * plan.cfg.fh, 63)
    return fir_same(wave, tuple(taps))


def decode_vitc_line(plan: ModemPlan, line: jax.Array, n_phases: int = 24):
    """(..., N) line -> ((..., 90) bits, (...,) best sync score 0..18).

    Clock recovery without a run-in: slice all ``n_phases`` candidate
    clock phases (plus/minus half a bit around nominal) in one gather,
    score each by matched sync-pair bits, argmax.  The slicing threshold
    per phase is half the mean of that phase's sync-'1' cells — gain
    errors cancel exactly like the run-in services' amplitude recovery.
    """
    spb, guard = _geometry(plan)
    x = line.astype(jnp.float32)
    taus = jnp.linspace(-0.5 * spb, 0.5 * spb, n_phases)      # (P,)
    centers = (
        guard + (jnp.arange(N_BITS, dtype=jnp.float32) + 0.5) * spb
    )[None, :] + taus[:, None]                                 # (P, 90)
    offs = jnp.arange(
        -np.floor(0.3 * spb), np.floor(0.3 * spb) + 1.0, dtype=jnp.float32
    )
    idx = jnp.clip(
        jnp.round(centers[..., None] + offs).astype(jnp.int32),
        0, plan.n_samples - 1,
    )                                                          # (P, 90, K)
    vals = jnp.mean(x[..., idx], axis=-1)                      # (..., P, 90)
    ones = jnp.asarray(SYNC_ONES)
    zeros = jnp.asarray(SYNC_ZEROS)
    # slicing threshold: midpoint of the sync-'1' and sync-'0' cell means.
    # Both syncs are ISOLATED pulses (a lone 1 reads slightly low through
    # the shaping filter, a 0 next to 1s slightly high), so the midpoint
    # centers the eye where level/2 off the '1's alone sat a few percent
    # low and clipped the margin of ISI-lifted zeros (measured bit flips
    # at 16-sigma noise before this).
    hi = jnp.mean(vals[..., ones], axis=-1, keepdims=True)     # (..., P, 1)
    lo = jnp.mean(vals[..., zeros], axis=-1, keepdims=True)
    bits_p = (vals > 0.5 * (hi + lo)).astype(jnp.int32)        # (..., P, 90)
    score = (
        jnp.sum(bits_p[..., ones], axis=-1)
        + jnp.sum(1 - bits_p[..., zeros], axis=-1)
    )                                                          # (..., P)
    best = jnp.argmax(score, axis=-1)
    bits = jnp.take_along_axis(
        bits_p, best[..., None, None], axis=-2
    )[..., 0, :]
    return bits, jnp.take_along_axis(score, best[..., None], axis=-1)[..., 0]


def timecode_for_frame(n: int, fps: int = 25) -> tuple:
    """Frame counter -> (h, m, s, f), non-drop."""
    f = n % fps
    s = (n // fps) % 60
    m = (n // (fps * 60)) % 60
    h = (n // (fps * 3600)) % 24
    return h, m, s, f
