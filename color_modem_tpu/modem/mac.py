"""D2-MAC time-multiplexed analog components modem (beyond-reference family).

The MAC/packet family (ITU-R BO.650, EN 300 250) is the satellite-era
alternative to composite color: instead of frequency-interleaving chroma on
a subcarrier, each 64 us line TIME-multiplexes a digital duobinary data
burst, one time-compressed color-difference component (3:1), and the
time-compressed luminance (3:2).  There is no subcarrier, hence no
cross-color/cross-luminance by construction — the classic composite
artifacts this framework's comb decoders exist to fight simply cannot
occur, which makes MAC the natural "clean" end of the gallery.

The upstream reference (`kFYatek/color_modem`, mount empty — SURVEY.md §0)
has no MAC support; all constants below are literature-derived from the
published D2-MAC line geometry [MEM-M] and documented inline.  The layout
matches BO.650's sample numbering on the 20.25 MHz grid (1296 samples/line):
data burst in the blanking interval (105 duobinary symbols at 10.125 Mbaud
= half the D-MAC rate, which is what lets D2-MAC fit cable channels), then
clamp, chroma, luma.

Array formulation, consistent with modem/qam.py:

* everything is a pure function of a whole ``(..., L, N)`` block plus the
  absolute line index array ``gline`` — no per-line Python loop, no state;
* time compression/expansion is the windowed-sinc resampling MATRIX from
  dsp/resample (one matmul per segment, anti-aliasing built in);
* duobinary precoding p_k = b_0 xor ... xor b_k is a CLOSED FORM —
  ``cumsum(bits) mod 2`` — not a sequential scan;
* the burst is shaped by a half-band interpolator whose even-offset taps
  are exactly zero, so symbol-center samples are preserved EXACTLY through
  the shaping filter and a clean channel decodes with literally zero bit
  errors (the discrete-grid analog of Nyquist's vestigial symmetry);
* line-sequential chroma (U on even absolute lines, V on odd) is
  reassembled by neighbor averaging — the same ±1-line stencil as the comb
  family, so sharding reuses parallel/halo with halo=1.

Verified line-by-line against the frozen sequential oracle golden/mac.py.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp.apply import fir_same
from color_modem_tpu.dsp.colorimetry import apply_mat3, clamp01
from color_modem_tpu.dsp.resample import resample_width
from color_modem_tpu.modem.mac_plan import (  # noqa: F401  (re-exports)
    MacConfig,
    MacPlan,
    make_mac_plan,
)
from color_modem_tpu.separate.stencil import next_reflect, prev_reflect


# ---------------------------------------------------------------------------
# duobinary data burst
# ---------------------------------------------------------------------------

def duobinary_levels(bits: jax.Array) -> jax.Array:
    """(..., K) bits in {0,1} -> (..., K) duobinary levels in {-1, 0, +1}.

    Precoded duobinary: p_k = b_0 xor ... xor b_k (closed form: prefix-sum
    parity), a_k = 2 p_k - 1, d_k = (a_k + a_{k-1}) / 2 with a_{-1} = -1.
    b_k = 1 always maps to level 0 and b_k = 0 to +/-1, independent of
    history — that is the whole point of the precoder (no error
    propagation at the receiver).
    """
    b = bits.astype(jnp.float32)
    p = jnp.cumsum(b, axis=-1) % 2.0       # prefix XOR as parity
    a = 2.0 * p - 1.0
    a_prev = jnp.concatenate(
        [jnp.full_like(a[..., :1], -1.0), a[..., :-1]], axis=-1
    )
    return 0.5 * (a + a_prev)


def duobinary_bits(levels: jax.Array) -> jax.Array:
    """Inverse decision rule: bit = 1 iff the 3-level sample is near 0."""
    return (jnp.abs(levels) < 0.5).astype(jnp.int32)


def _burst_signal(plan: MacPlan, bits: jax.Array) -> jax.Array:
    """(..., L, K) bits -> (..., L, spb*K) shaped burst around 0 (no
    pedestal).  D2 (spb=2): zero-stuff to the grid and half-band shape —
    symbol centers stay exact.  D-MAC (spb=1): every grid sample IS a
    symbol; the duobinary (1+D)/2 correlation already shapes the
    spectrum (null at the 10.125 MHz Nyquist of the baud), no filter."""
    cfg = plan.cfg
    d = duobinary_levels(bits)                       # (..., L, K)
    if cfg.samples_per_symbol == 1:
        return jnp.float32(cfg.data_amplitude) * d
    up = jnp.zeros(
        d.shape[:-1] + (cfg.samples_per_symbol * cfg.data_symbols,),
        jnp.float32,
    )
    up = up.at[..., 0 :: cfg.samples_per_symbol].set(d)
    shaped = fir_same(up, plan.halfband)             # even samples preserved
    return jnp.float32(cfg.data_amplitude) * shaped


def line_bits(plan: MacPlan, payload: Optional[jax.Array], n_lines_shape) -> jax.Array:
    """Assemble per-line burst bits: sync word + payload (zero-padded).

    ``payload``: (..., L, <=99) user bits or None; returns (..., L, 105).
    """
    cfg = plan.cfg
    cap = cfg.data_symbols - len(cfg.line_sync_word)
    sync = jnp.asarray(cfg.line_sync_word, dtype=jnp.int32)
    if payload is None:
        payload = jnp.zeros(tuple(n_lines_shape) + (cap,), jnp.int32)
    if payload.shape[-1] > cap:
        raise ValueError(f"payload {payload.shape[-1]} bits > capacity {cap}")
    if payload.shape[-1] < cap:
        pad = jnp.zeros(payload.shape[:-1] + (cap - payload.shape[-1],), jnp.int32)
        payload = jnp.concatenate([payload, pad], axis=-1)
    sync_b = jnp.broadcast_to(sync, payload.shape[:-1] + sync.shape)
    return jnp.concatenate([sync_b, payload], axis=-1)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def chroma_is_u(gline: jax.Array) -> jax.Array:
    """Line-sequential color: even absolute lines carry U, odd carry V."""
    return (gline % 2) == 0


def encode(
    plan: MacPlan,
    rgb: jax.Array,
    gline: jax.Array,
    payload_bits: Optional[jax.Array] = None,
) -> jax.Array:
    """(..., 3, L, W) RGB in [0,1] + (..., L) lines -> (..., L, 1296) MAC.

    Levels: luminance rides 0..1 full scale (black 0, white 1 — the clamp
    period, not a sync floor, carries the DC reference); color difference
    0.5 + chroma_gain * c; data 0.5 +/- 0.4.  These are normalized units of
    the published 1 V-ish swings; only their ratios matter to the round
    trip and they keep every segment inside [0, 1].
    """
    cfg = plan.cfg
    ycc = apply_mat3(plan.rgb_to_ycc, rgb.astype(jnp.float32))
    y, u, v = ycc[..., 0, :, :], ycc[..., 1, :, :], ycc[..., 2, :, :]

    is_u = chroma_is_u(gline)[..., None]             # (..., L, 1)
    c_sel = jnp.where(is_u, u, v)                    # line-sequential component

    luma_seg = resample_width(y, cfg.luma_len)       # 3:2 time compression
    chroma_seg = (
        jnp.float32(cfg.pedestal)
        + jnp.float32(cfg.chroma_gain) * resample_width(c_sel, cfg.chroma_len)
    )

    bits = line_bits(plan, payload_bits, gline.shape)
    burst = jnp.float32(cfg.pedestal) + _burst_signal(plan, bits)

    ped = jnp.float32(cfg.pedestal)
    n_burst = cfg.samples_per_symbol * cfg.data_symbols

    def gap(n):
        return jnp.full(y.shape[:-1] + (n,), ped, jnp.float32)

    parts = [
        burst,                                        # [0, 210)
        gap(cfg.chroma_start - n_burst),              # clamp + guard
        chroma_seg,                                   # [235, 584)
        gap(cfg.luma_start - (cfg.chroma_start + cfg.chroma_len)),
        luma_seg,                                     # [586, 1283)
        gap(cfg.samples_per_line - (cfg.luma_start + cfg.luma_len)),
    ]
    return jnp.concatenate(parts, axis=-1)


def _seg(x: jax.Array, start: int, length: int) -> jax.Array:
    return x[..., start : start + length]


def clamp_correction(plan: MacPlan, sig: jax.Array) -> jax.Array:
    """Per-line DC error measured over the clamp period (..., L, 1)."""
    cfg = plan.cfg
    clamp = _seg(sig, cfg.clamp_start, cfg.clamp_len)
    return jnp.mean(clamp, axis=-1, keepdims=True) - jnp.float32(cfg.pedestal)


def decode_components(plan: MacPlan, sig: jax.Array, gline: jax.Array):
    """(..., L, 1296) -> (y, u, v) each (..., L, W), before the RGB matrix.

    The missing line-sequential component is reassembled by averaging the
    two vertical neighbors (the MAC receiver's chroma line store); the
    global top/bottom edges follow the framework-wide reflect rule.  The
    ±1-line neighborhood is the decoder's only cross-line dependency —
    halo = 1, edge = 'reflect' when sharded (parallel/halo).
    """
    cfg = plan.cfg
    sig = sig.astype(jnp.float32) - clamp_correction(plan, sig)

    y = resample_width(_seg(sig, cfg.luma_start, cfg.luma_len), plan.width)
    c = resample_width(
        (_seg(sig, cfg.chroma_start, cfg.chroma_len) - jnp.float32(cfg.pedestal))
        / jnp.float32(cfg.chroma_gain),
        plan.width,
    )

    interp = 0.5 * (prev_reflect(c, 1) + next_reflect(c, 1))
    is_u = chroma_is_u(gline)[..., None]
    u = jnp.where(is_u, c, interp)
    v = jnp.where(is_u, interp, c)
    return y, u, v


def decode(plan: MacPlan, sig: jax.Array, gline: jax.Array) -> jax.Array:
    """(..., L, 1296) MAC signal -> (..., 3, L, W) RGB, clamped to [0,1]."""
    y, u, v = decode_components(plan, sig, gline)
    ycc = jnp.stack([y, u, v], axis=-3)
    return clamp01(apply_mat3(plan.ycc_to_rgb, ycc))


def decode_data(plan: MacPlan, sig: jax.Array):
    """(..., L, 1296) -> (sync_ok (..., L) bool, payload (..., L, 99) bits).

    Samples the burst at symbol centers (even offsets — exact through the
    half-band shaper on a clean channel), undoes the level mapping, applies
    the duobinary decision, then checks the line sync word.
    """
    cfg = plan.cfg
    sig = sig.astype(jnp.float32) - clamp_correction(plan, sig)
    burst = _seg(sig, cfg.data_start,
                 cfg.samples_per_symbol * cfg.data_symbols)
    d = (burst[..., 0 :: cfg.samples_per_symbol]
         - jnp.float32(cfg.pedestal)) / jnp.float32(cfg.data_amplitude)
    bits = duobinary_bits(d)
    n_sync = len(cfg.line_sync_word)
    sync = jnp.asarray(cfg.line_sync_word, dtype=jnp.int32)
    sync_ok = jnp.all(bits[..., :n_sync] == sync, axis=-1)
    return sync_ok, bits[..., n_sync:]


def roundtrip(
    plan: MacPlan,
    rgb: jax.Array,
    gline: jax.Array,
    payload_bits: Optional[jax.Array] = None,
) -> jax.Array:
    return decode(plan, encode(plan, rgb, gline, payload_bits), gline)


# ---------------------------------------------------------------------------
# MAC packet sound: NICAM-coded audio in the duobinary burst
# ---------------------------------------------------------------------------

def sound_capacity(plan: MacPlan, n_lines: int) -> int:
    """NICAM 728-bit sound frames that fit one video frame's burst payload.

    D2-MAC carried its sound digitally in the data burst as packets of
    NICAM-companded samples (the same coding as the terrestrial NICAM-728
    carrier — frame/nicam.py); here the framework's NICAM bit frames ride
    the burst payload verbatim.  625 lines x 99 bits at 25 fps is
    ~1.55 Mb/s — two full NICAM stereo services' worth; this transport
    uses the head of each frame's payload and leaves the tail for data.
    """
    cap = plan.cfg.data_symbols - len(plan.cfg.line_sync_word)
    return (n_lines * cap) // 728


def pack_sound(plan: MacPlan, left, right, n_lines: int):
    """Stereo audio -> (payload (..., n_lines, 99), n_audio_frames).

    ``left``/``right``: float in [-1, 1], length a multiple of 32 with
    length//32 <= :func:`sound_capacity`.  The NICAM frames' bits are laid
    head-first across the burst payload rows; unused tail bits are zero.
    """
    from color_modem_tpu.frame.nicam import nicam_frames

    frames = nicam_frames(left, right)               # (F, 728)
    n_f = frames.shape[0]
    cap = plan.cfg.data_symbols - len(plan.cfg.line_sync_word)
    if n_f > sound_capacity(plan, n_lines):
        raise ValueError(
            f"{n_f} NICAM frames need {n_f * 728} bits; {n_lines} lines "
            f"carry {n_lines * cap}"
        )
    flat = frames.reshape(-1)
    pad = n_lines * cap - flat.shape[0]
    payload = jnp.concatenate(
        [flat, jnp.zeros((pad,), jnp.int32)]
    ).reshape(n_lines, cap)
    return payload, n_f


def unpack_sound(plan: MacPlan, payload: jax.Array, n_audio_frames: int):
    """Inverse of :func:`pack_sound`: burst payload rows -> (L, R, report)."""
    from color_modem_tpu.frame.nicam import parse_frames

    flat = payload.reshape(-1)[: n_audio_frames * 728]
    return parse_frames(flat.reshape(n_audio_frames, 728))
