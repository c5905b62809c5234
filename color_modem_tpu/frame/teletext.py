"""World System Teletext (WST) packet service over the VBI data-line layer.

The 625-line world's counterpart of the EIA-608 captions already carried
by :mod:`color_modem_tpu.frame.vbi`: broadcast teletext (ETS 300 706
"level 1") puts 45-byte packets on vertical-blanking lines — a clock
run-in, a framing code, a Hamming-8/4-protected magazine/packet address,
and 40 payload bytes (odd-parity characters on display rows, Hamming
nibbles in the page header).  A page is one header packet (X/0) plus up
to 23 display rows (X/1..X/23).

Reference parity: the upstream library (SURVEY.md §2.1 C7, mount empty
§0.1) has no data services at all; this subsystem is beyond-reference
capability mirroring the caption channel for PAL/SECAM.

Authentic rate needs the wide grid.  Real WST clocks bits at 444*fh
(6.9375 Mbit/s on 625-line systems) so a 360-bit line fits in the 52 us
active window.  On the 13.5 MHz / 720-sample grid that is under 2
samples per bit — unsliceable — but on the 27 MHz / 1440-sample grid it
is 3.89 samples/bit, above the 3-sample floor of the data-line decoder.
So full-rate, full-size packets are supported at ``width >= 1440`` and
:func:`wst_spec` refuses narrower grids (callers can fall back to
:func:`color_modem_tpu.frame.vbi.teletext_spec`'s half-rate short lines
for demos).

Array shape: every packet of a page encodes/decodes in ONE batched call —
rows stack on the line axis of the (..., L, N) composite exactly like
ordinary video lines, the correlating decoder recovers each row's clock
in parallel, and Hamming correction is a 256-entry ``jnp.take`` LUT, not
a per-byte loop.  Text extraction (host-side) touches only the decoded
int bits.

Byte order: WST transmits each byte LSB-first; all bit arrays here are
in transmission order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.frame.vbi import (
    DataLineSpec,
    decode_data_line,
    encode_data_line,
)
from color_modem_tpu.modem.plan import ModemPlan

PACKET_BYTES = 42          # 2 address + 40 payload (framing code is framing)
PACKET_BITS = PACKET_BYTES * 8
ROW_CHARS = 40             # display row payload
HEADER_CHARS = 32          # header payload after the 8 Hamming bytes

# Framing code 0xE4 (11100100), transmitted LSB-first.
_FRAMING_LSB_FIRST = (0, 0, 1, 0, 0, 1, 1, 1)

# ---------------------------------------------------------------------------
# Hamming 8/4 (ETS 300 706 table 36): 4 data bits -> 8-bit codeword with
# single-error correction.  Bit layout (transmission order b1..b8):
# b1=P1 b2=D1 b3=P2 b4=D2 b5=P3 b6=D3 b7=P4 b8=D4, parities chosen so the
# standard's published codeword table results.
# ---------------------------------------------------------------------------

_HAM84_CODE = np.array(
    [0x15, 0x02, 0x49, 0x5E, 0x64, 0x73, 0x38, 0x2F,
     0xD0, 0xC7, 0x8C, 0x9B, 0xA1, 0xB6, 0xFD, 0xEA],
    dtype=np.int64,
)


def _ham84_tables() -> tuple[np.ndarray, np.ndarray]:
    """256-entry decode LUTs: corrected nibble, and ok flag.

    A received byte equal to a codeword or at Hamming distance 1 from
    exactly one codeword decodes to that codeword's nibble (ok=1);
    anything else is an uncorrectable (double) error (nibble 0, ok=0).
    """
    val = np.zeros(256, np.int64)
    ok = np.zeros(256, np.int64)
    for nib, cw in enumerate(_HAM84_CODE):
        val[cw], ok[cw] = nib, 1
        for b in range(8):
            flipped = cw ^ (1 << b)
            val[flipped], ok[flipped] = nib, 1
    return val, ok


_HAM84_VAL, _HAM84_OK = _ham84_tables()


def hamming84_encode(nibbles: jax.Array | np.ndarray) -> jax.Array:
    """(...,) nibbles 0..15 -> (..., 8) codeword bits, LSB first."""
    n = jnp.asarray(nibbles, jnp.int32)
    cw = jnp.take(jnp.asarray(_HAM84_CODE, jnp.int32), n)
    shifts = jnp.arange(8, dtype=jnp.int32)
    return (cw[..., None] >> shifts) & 1


def hamming84_decode(bits: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(..., 8) received bits -> ((...,) nibble, (...,) ok flag)."""
    b = jnp.asarray(bits, jnp.int32)
    shifts = jnp.arange(8, dtype=jnp.int32)
    byte = jnp.sum(b << shifts, axis=-1)
    val = jnp.take(jnp.asarray(_HAM84_VAL, jnp.int32), byte)
    ok = jnp.take(jnp.asarray(_HAM84_OK, jnp.int32), byte)
    return val, ok


def _parity_bytes(text: str, n: int) -> np.ndarray:
    """Text -> (n, 8) odd-parity 7-bit character bits, LSB first."""
    padded = text.ljust(n)[:n]
    out = np.zeros((n, 8), np.int64)
    for i, ch in enumerate(padded):
        v = ord(ch)
        if v > 0x7F:
            raise ValueError(f"teletext level 1 is 7-bit: {ch!r}")
        data = [(v >> k) & 1 for k in range(7)]
        out[i, :7] = data
        out[i, 7] = 1 - (sum(data) % 2)
    return out


def _chars_from_bits(bits: np.ndarray) -> tuple[str, np.ndarray]:
    """(n, 8) decoded bits -> (text, per-char parity-ok flags).

    Parity failures render as the spec's convention for a damaged cell
    (we use '?'); the flag array lets callers count errors.
    """
    data = (bits[:, :7] * (1 << np.arange(7))).sum(axis=1)
    ok = bits.sum(axis=1) % 2 == 1
    chars = [chr(int(v)) if o else "?" for v, o in zip(data, ok)]
    return "".join(chars), ok


def wst_spec(plan: ModemPlan) -> DataLineSpec:
    """Full-rate WST data-line spec: 444*fh NRZ, 42-byte packets.

    Requires the wide (>= 2x13.5 MHz) sample grid; see module docstring.
    """
    f_bit = 444.0 * plan.cfg.fh
    if plan.fs / f_bit < 3.0:
        raise ValueError(
            f"WST at {f_bit/1e6:.3f} Mbit/s needs >=3 samples/bit; "
            f"fs={plan.fs/1e6:.2f} MHz gives {plan.fs/f_bit:.2f} — use "
            f"width >= 1440 (27 MHz grid) for full-rate teletext"
        )
    return DataLineSpec(
        f_bit=f_bit,
        n_bits=PACKET_BITS,
        run_in_cycles=8,           # 8 cycles at f_bit/2 = the real 16-bit
        #                            10101010 run-in (run_in_alt)
        level=0.66,                # spec data level: 66% of white
        start_bits=_FRAMING_LSB_FIRST,
        # the authentic alternating run-in + 100% cosine roll-off pulse
        # shaping (ETS 300 706): full-rate WST then fits real ~5-6 MHz
        # video channels — the f_bit sine run-in needed bandwidth ABOVE
        # 6.94 MHz, which no real channel (nor the satellite sound
        # multiplex's video low-pass) provides (round-5 full-stack probe)
        run_in_alt=True,
    )


# ---------------------------------------------------------------------------
# Packet assembly / parse
# ---------------------------------------------------------------------------


def _address_bits(magazine: int, packet: int) -> np.ndarray:
    """Magazine 1..8, packet 0..31 -> (2, 8) Hamming address bytes.

    WST codes magazine 8 as 0; the two address nibbles are
    (packet<<3 | mag) split low/high per the spec's bit allocation.
    """
    if not 1 <= magazine <= 8:
        raise ValueError(f"magazine must be 1..8, got {magazine}")
    if not 0 <= packet <= 31:
        raise ValueError(f"packet must be 0..31, got {packet}")
    mag = magazine % 8
    addr = (packet << 3) | mag        # 8 bits: M1 M2 M3 Y1..Y5
    return np.asarray(
        jax.device_get(hamming84_encode(np.array([addr & 0xF, addr >> 4])))
    )


def row_packet_bits(magazine: int, row: int, text: str) -> jax.Array:
    """Display row (packet X/1..X/25): (PACKET_BITS,) transmission bits."""
    if not 1 <= row <= 25:
        raise ValueError(f"display rows are packets 1..25, got {row}")
    addr = _address_bits(magazine, row)
    chars = _parity_bytes(text, ROW_CHARS)
    return jnp.asarray(
        np.concatenate([addr, chars]).reshape(-1), jnp.int32
    )


def header_packet_bits(
    magazine: int, page: int, subcode: int = 0, text: str = ""
) -> jax.Array:
    """Page header (packet X/0): page number + subcode in Hamming bytes,
    then 32 odd-parity caption characters (the clock/channel ident row).

    ``page`` is the two-digit hex page number 0x00..0xFF as displayed
    (page 100 == magazine 1, page units 0x00)."""
    if not 0 <= page <= 0xFF:
        raise ValueError(f"page number is two hex digits, got {page:#x}")
    if not 0 <= subcode <= 0x3FFF:
        raise ValueError(f"subcode is 13 bits + control, got {subcode:#x}")
    addr = _address_bits(magazine, 0)
    # 8 Hamming bytes: units, tens, S1, S2(+C4), S3, S4(+C5/C6), C7..C10,
    # C11..C14 — control bits transmitted 0 here (plain page).
    nibbles = np.array(
        [
            page & 0xF,
            (page >> 4) & 0xF,
            subcode & 0xF,
            (subcode >> 4) & 0x7,
            (subcode >> 7) & 0xF,
            (subcode >> 11) & 0x3,
            0,
            0,
        ]
    )
    ham = np.asarray(jax.device_get(hamming84_encode(nibbles)))
    chars = _parity_bytes(text, HEADER_CHARS)
    return jnp.asarray(
        np.concatenate([addr, ham, chars]).reshape(-1), jnp.int32
    )


def encode_page(
    plan: ModemPlan,
    magazine: int,
    page: int,
    rows: list[str],
    header: str = "",
) -> jax.Array:
    """A whole page -> (1 + len(rows), N) data-line waveforms.

    Row 0 is the page header; ``rows[i]`` becomes display packet i+1.
    All lines encode in one batched data-line call.
    """
    if len(rows) > 25:
        raise ValueError(f"a page has at most 25 display rows, got "
                         f"{len(rows)}")
    spec = wst_spec(plan)
    bits = jnp.stack(
        [header_packet_bits(magazine, page, text=header)]
        + [row_packet_bits(magazine, i + 1, t) for i, t in enumerate(rows)]
    )
    return encode_data_line(plan, spec, bits)


@dataclasses.dataclass(frozen=True)
class TeletextPacket:
    """One decoded packet (host-side view)."""

    magazine: int
    packet: int
    address_ok: bool
    text: str
    parity_ok: np.ndarray      # per-character flags
    page: int | None = None    # header packets only
    subcode: int | None = None
    header_ok: bool = True     # Hamming flags on the header bytes
    margin: float = 0.0        # slicing eye margin from the data-line layer


def decode_packets(
    plan: ModemPlan, lines: jax.Array
) -> list[TeletextPacket]:
    """(R, N) received data lines -> R parsed packets.

    The slice + Hamming LUT run batched on device; the per-packet parse
    below touches only the resulting small int arrays on host.
    """
    spec = wst_spec(plan)
    bits, margin = decode_data_line(plan, spec, lines)
    bytes_ = bits.reshape(bits.shape[:-1] + (PACKET_BYTES, 8))
    addr_val, addr_ok = hamming84_decode(bytes_[..., :2, :])
    ham_val, ham_ok = hamming84_decode(bytes_[..., 2:10, :])
    bits_h, margin_h, addr_val, addr_ok, ham_val, ham_ok = jax.device_get(
        (bits, margin, addr_val, addr_ok, ham_val, ham_ok)
    )
    out = []
    for r in range(bits_h.shape[0]):
        addr = int(addr_val[r, 0]) | (int(addr_val[r, 1]) << 4)
        mag = addr & 0x7
        packet = addr >> 3
        a_ok = bool(addr_ok[r].all())
        row_bits = bits_h[r].reshape(PACKET_BYTES, 8)
        if packet == 0:
            page = int(ham_val[r, 0]) | (int(ham_val[r, 1]) << 4)
            subcode = (
                int(ham_val[r, 2])
                | ((int(ham_val[r, 3]) & 0x7) << 4)
                | (int(ham_val[r, 4]) << 7)
                | ((int(ham_val[r, 5]) & 0x3) << 11)
            )
            text, ok = _chars_from_bits(row_bits[10:])
            out.append(
                TeletextPacket(
                    magazine=8 if mag == 0 else mag,
                    packet=0,
                    address_ok=a_ok,
                    text=text,
                    parity_ok=ok,
                    page=page,
                    subcode=subcode,
                    header_ok=bool(ham_ok[r].all()),
                    margin=float(margin_h[r]),
                )
            )
        else:
            text, ok = _chars_from_bits(row_bits[2:])
            out.append(
                TeletextPacket(
                    magazine=8 if mag == 0 else mag,
                    packet=packet,
                    address_ok=a_ok,
                    text=text,
                    parity_ok=ok,
                    margin=float(margin_h[r]),
                )
            )
    return out


def render_page(packets: list[TeletextPacket]) -> str:
    """Decoded packets -> the page as display text (header first,
    display rows in packet order, missing rows blank)."""
    rows: dict[int, str] = {}
    header = ""
    for p in packets:
        if p.packet == 0:
            header = p.text.rstrip()
        elif 1 <= p.packet <= 25:
            rows[p.packet] = p.text.rstrip()
    body = []
    if rows:
        for i in range(1, max(rows) + 1):
            body.append(rows.get(i, ""))
    return "\n".join([header] + body).rstrip()
