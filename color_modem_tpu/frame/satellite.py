"""Satellite FM transmission (beyond-reference): wideband video FM at IF.

Terrestrial analog TV is VSB-AM (frame/rf.py); satellite TV was FM — the
other half of the transmission story, and the channel the MAC family
(modem/mac.py) was actually designed for (D2-MAC on DBS transponders).
SECAM/PAL composites also flew this way (the classic Astra/Gorizont
downlinks).  The chain simulated here is the standard one:

    baseband -> CCIR-405-shaped pre-emphasis -> energy dispersal ->
    wideband FM onto an IF carrier (Carson bandwidth inside a 27-36 MHz
    transponder) -> AWGN channel at some CNR ->
    receiver band-pass -> quadrature FM discriminator -> de-emphasis ->
    (clamp removes dispersal at the next layer: MAC's clamp period or a
    rastered composite's back porch)

The reference has none of this (SURVEY.md §2.1 stops at the composite);
constants are literature-shaped and documented inline.

Design, mirroring frame/rf.py's conventions:

* The IF carrier is pinned to EXACTLY fs_rf/4: its cos/sin are the
  repeating 4-sample patterns [1,0,-1,0] / [0,1,0,-1] — the mixers are
  exact multiplies with no accumulating phase state, and every line/frame
  starts at the same carrier phase by construction.
* FM phase is the midpoint-rule integral of the deviation only (the
  carrier part is the exact ramp above), per FRAME over the contiguous
  row-major stream: one ``cumsum`` per frame, no cross-frame state —
  frames stay DP-shardable.  Worst-case deviation phase is ~2.4 krad per
  *line* and grows with DC content over the stream; the per-line carry is
  re-wrapped mod 2pi line by line so float32 never sees more than one
  line's unwrapped magnitude (the SECAM trick from modem/plan.py, scaled
  up one level).
* All filters are design-time FIRs applied as overlap-save stream
  convolutions (dsp/stream.py) — line-seam-free, pow2 32k blocks, with
  the rate changes done in the
  frequency domain and the receiver's filter-mix-filter cascade composed
  into ONE complex FIR (VERDICT r2 item 3, same treatment as frame/rf.py):

  - modulate: zero-stuff + anti-image interpolation is one
    :func:`dsp.stream.upsample_fir_stream` (rfft at the BASEBAND rate);
    the video pre-emphasis and the sound-multiplex low-pass compose by
    tap convolution into one baseband FIR.
  - demodulate: band-pass -> exact fs/4 quadrature mix -> I/Q low-pass is
    one :func:`dsp.stream.conv_complex_stream` with
    ``h_z = conv(2·iq·e^{+j(pi/2)(k-lo)}, rx)`` (the modulation identity,
    frame/rf.py:89); the residual ``e^{-j(pi/2)n}`` rotation cancels in
    the symmetric discriminator to an exact sign flip
    (``z[n+1]conj(z[n-1]) = e^{-j pi}·w[n+1]conj(w[n-1]) = -P_w``), so no
    per-sample rotation is ever materialized.  The final low-pass +
    decimation is one :func:`dsp.stream.fir_decim_stream` (ifft at the
    BASEBAND rate); the sound-reject and de-emphasis FIRs compose.
* Discrimination is the symmetric phase difference
  ``angle(z[n+1] conj(z[n-1])) * fs/(4 pi)`` — no unwrap, no Hilbert, and
  the symmetric form reads f_inst at exactly sample n (the same
  half-sample argument as the SECAM decoder).

Measured-and-rejected (round 5): a DECIMATING audio takeoff in the
frame/rf.py style (mix + I/Q low-pass composed into one conv_decim pass
at base_fs/8-16, discriminator + audio filters at ~1.7 MHz, the wider
discriminator window's sinc droop folded inverse into the decimated
filter design, interpolation back to the base rate).  It works — audio
SNR within ~1 dB below 12 kHz — but its parity against the frozen
full-rate oracle (golden/sound.py) tops out at ~60-73 dB: the in-band
flatness of the three cascaded realizable FIRs (decimated de-emphasis x
interpolation LPF vs the oracle's single aud_rx) is the floor, far
under the 107 dB the full-rate chain records
(tests/test_golden_sound.py's >100 dB bar).  The ~1.5x satellite-row
speedup it offered was judged not worth weakening the co-regression
oracle for the whole audio chain; the full-rate takeoff stands.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache as _lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp import design
from color_modem_tpu.dsp.stream import (
    _carrier_taps,
    conv_decim_stream,
    fir_decim_stream,
    fir_stream,
    pad_taps_center,
    upsample_fir_stream,
)

TWO_PI = 2.0 * np.pi


def preemph_response(f, f1: float, f2: float, g0: float):
    """CCIR Rec. 405-shaped video pre-emphasis for FM: attenuate LF,
    boost HF, crossing unity in between.

    |P(f)|^2 = g0^2 (1 + (f/f1)^2) / (1 + (f/f2)^2) with f2 = (1/g0) f1
    gives LF gain g0 and HF gain g0 f2/f1 = 1/g0 — the classic +-~7 dB
    swing at g0 ~ 0.45.  Zero phase (the real 405 network's phase is
    absorbed by its inverse at the receiver; modeling the pair as
    zero-phase keeps each FIR individually delay-free, like SECAM's
    emphasis pair in dsp/design).
    """
    f = np.asarray(f, dtype=np.float64)
    mag = g0 * np.sqrt((1.0 + (f / f1) ** 2) / (1.0 + (f / f2) ** 2))
    return mag.astype(np.complex128)


def _emph50_mag(f, audio_bw: float, tau: float = 50e-6):
    """50 us audio emphasis shelf magnitude |1 + j 2 pi f tau|, held flat
    above ``audio_bw`` so the pre taps stay bounded; the de-emphasis pair
    is the exact reciprocal, so pre * de == 1 at EVERY frequency and the
    cap only shapes out-of-band noise (which the audio low-pass removes
    anyway)."""
    f50 = 1.0 / (2.0 * np.pi * tau)
    fe = np.minimum(np.abs(np.asarray(f, np.float64)), audio_bw)
    return np.sqrt(1.0 + (fe / f50) ** 2).astype(np.complex128)


@dataclasses.dataclass(frozen=True, eq=False)
class SatPlan:
    """Host-side constants for one (baseband geometry) satellite link."""

    base_fs: float            # baseband sample rate (Hz)
    n_base: int               # baseband samples per row
    r: int                    # RF oversampling factor (fs_rf = r * base_fs)
    fs_rf: float
    n_rf: int                 # RF samples per row = r * n_base
    deviation: float          # Hz per video unit
    center: float             # video value mapped to the carrier rest freq
    dispersal: float          # energy-dispersal amplitude, video units (pk)
    total_lines: int          # dispersal period (one frame)
    interp_taps: np.ndarray   # zero-stuff anti-image LPF (RF rate)
    rx_taps: np.ndarray       # receiver transponder band-pass (RF rate)
    iq_taps: np.ndarray       # post-mixer I/Q low-pass (RF rate)
    dec_taps: np.ndarray      # pre-decimation low-pass (RF rate; the
                              # frozen oracle's naive chain uses it)
    pre_taps: np.ndarray      # pre-emphasis (baseband rate)
    de_taps: np.ndarray       # de-emphasis (baseband rate)
    dec2_taps: np.ndarray | None = None  # pre-decimation low-pass at
                              # fs_rf/2 (the half-rate demod path)
    # --- analog audio subcarriers (empty tuple = no sound designed) -----
    sub_freqs: tuple = ()     # subcarrier frequencies, Hz (baseband mux)
    sub_dev: float = 85e3     # audio FM deviation per subcarrier, Hz
    sub_amp: float = 0.11     # subcarrier amplitude, video units each
    audio_bw: float = 15e3
    mux_lpf: np.ndarray | None = None  # video LPF clearing the sub band
    sub_lpf: np.ndarray | None = None  # post-mix I/Q LPF (baseband rate)
    aud_rx: np.ndarray | None = None   # audio LPF * 50us de-emphasis
    aud_pre: np.ndarray | None = None  # 50us pre-emphasis

    # --- composed-FIR views (host numpy, built at trace time) ----------
    def tx_video_taps(self) -> np.ndarray:
        """Transmit-side baseband video FIR: pre-emphasis, composed with
        the sound-multiplex low-pass when subcarriers are designed."""
        if self.mux_lpf is not None:
            return np.convolve(self.mux_lpf, self.pre_taps)
        return np.asarray(self.pre_taps, np.float64)

    def rx_video_taps(self) -> np.ndarray:
        """Receive-side baseband video FIR: de-emphasis, composed with the
        subcarrier-reject low-pass when subcarriers are designed."""
        if self.mux_lpf is not None:
            return np.convolve(self.mux_lpf, self.de_taps)
        return np.asarray(self.de_taps, np.float64)

    def interp_up_taps(self) -> np.ndarray:
        """Anti-image interpolation FIR for upsample_fir_stream, with the
        zero-stuffing gain ``r`` folded in and the overlap-save geometry
        aligned to the rate change."""
        return pad_taps_center(self.r * np.asarray(self.interp_taps,
                                                   np.float64), 2 * self.r)

    def h_demod_taps(self) -> np.ndarray:
        """Receiver front end as ONE complex FIR: band-pass, exact fs/4
        quadrature mix, I/Q low-pass — ``2·conv(iq·e^{+j(pi/2)(k-lo)},
        rx)``.  Output w relates to the true complex baseband by
        ``z[n] = e^{-j(pi/2)n}·w[n]``; the rotation cancels to a sign
        flip in the symmetric discriminator (module docstring)."""
        return np.convolve(
            2.0 * _carrier_taps(self.iq_taps, 0.5 * np.pi), self.rx_taps
        )

    def dec_down_taps(self) -> np.ndarray:
        """Pre-decimation low-pass for fir_decim_stream (geometry-aligned)."""
        return pad_taps_center(np.asarray(self.dec_taps, np.float64),
                               2 * self.r)

    def h_demod2_taps(self) -> np.ndarray:
        """The :meth:`h_demod_taps` complex FIR geometry-aligned for the
        half-rate front end (conv_decim_stream r=2)."""
        return pad_taps_center(self.h_demod_taps(), 4)

    def dec_down2_taps(self) -> np.ndarray:
        """Pre-decimation low-pass at fs_rf/2 for the half-rate demod's
        final fir_decim_stream (r//2), geometry-aligned."""
        return pad_taps_center(np.asarray(self.dec2_taps, np.float64),
                               max(2 * (self.r // 2), 2))


#: Analog-satellite audio subcarrier ladder (Hz): the classic 6.50 MHz
#: main mono slot, then slots on the Astra 180 kHz grid anchored at
#: 7.02 MHz.  The real Astra pairs sat 180 kHz apart because they ran
#: +-50 kHz Panda-companded deviation; at this module's default 85 kHz
#: mono-spec deviation the Carson widths need every THIRD grid slot
#: (7.02/7.56/8.10).  Callers wanting the literal 7.02/7.20 pair pass
#: sub_freqs=(7.02e6, 7.20e6), sub_dev=50e3 — the spacing check scales
#: with the deviation.  Used verbatim when the baseband rate has room
#: (27 MHz composites, MAC geometries); scaled positions otherwise.
AUDIO_SUB_LADDER = (6.50e6, 7.02e6, 7.56e6, 8.10e6)


def make_sat_plan(
    base_fs: float,
    n_base: int,
    *,
    r: int = 4,
    deviation: float = 12.0e6,
    center: float = 0.5,
    dispersal: float = 0.0,
    total_lines: int = 625,
    f_emph: float = 1.0e6,
    g_emph: float = 0.45,
    audio_subs: int = 0,
    sub_freqs: tuple | None = None,
    sub_dev: float = 85e3,
    sub_amp: float = 0.11,
    audio_bw: float = 15e3,
) -> SatPlan:
    """Design the satellite link for a given baseband geometry.

    Defaults: r=4 puts the carrier at exactly fs_rf/4 (e.g. 20.25 MHz IF
    over the 20.25 MHz MAC baseband, fs_rf = 81 MHz); deviation 12 MHz per
    video unit = +-6 MHz peak around ``center``, Carson bandwidth
    2*(6 + f_base) — a 27-36 MHz transponder for the video basebands here.
    ``dispersal`` > 0 adds the frame-synchronous triangular energy
    dispersal (in video units; removed by the NEXT layer's clamp — MAC's
    clamp period or a raster's porch — not by this module).

    ``audio_subs`` > 0 adds that many analog FM audio subcarriers to the
    baseband multiplex above the (then low-passed) video — the way real
    analog satellite TV carried sound (MAC instead rides its packet-sound
    burst, modem/mac.py).  Frequencies come from :data:`AUDIO_SUB_LADDER`
    when they fit under the interpolation/decimation passband (true from
    ~15.5 MHz baseband rates, e.g. 27 MHz composites); at narrower
    basebands (13.5 MHz composites) they scale to 0.43/0.465 of the rate
    (5.8/6.3 MHz — the same positions relative to the video band).  The
    multiplex video LPF lands below the lowest subcarrier: NTSC/PAL
    chroma always fits; SECAM at 13.5 MHz loses its outermost FM
    sideband tops (use the 1440-sample/27 MHz SECAM geometry).
    """
    if r < 1 or r & (r - 1):
        raise ValueError(
            f"make_sat_plan: oversampling r={r} must be a power of two — "
            "the stream engine's rate changes partition pow2 FFT blocks "
            "into r dense sub-blocks (dsp/stream._check_rate)"
        )
    fs_rf = r * base_fs
    fc = fs_rf / 4.0
    f_base = 0.5 * base_fs
    bw = 2.0 * (deviation * max(center, 1.0 - center) + f_base)  # Carson
    bw = min(bw, 2.0 * fc - 2.0e6)  # keep the band off DC/Nyquist
    ntaps_rf = 4 * design.DEFAULT_NTAPS + 1   # RF-rate filters: same time
    #                                           span as a 129-tap baseband FIR

    # subcarrier geometry first: with sound, the interp/dec passband
    # opens to 0.49 * base_fs so the subcarriers clear its rolloff
    sub_half = 2.0 * (sub_dev + audio_bw)  # Carson half-width, x2 margin
    if audio_subs:
        if sub_freqs is None:
            top = 0.49 * base_fs - sub_half - 0.1e6
            if AUDIO_SUB_LADDER[audio_subs - 1] <= top:
                sub_freqs = AUDIO_SUB_LADDER[:audio_subs]
            elif audio_subs <= 2:
                sub_freqs = tuple(
                    (0.43 + 0.035 * i) * base_fs for i in range(audio_subs)
                )
            else:
                raise ValueError(
                    f"audio_subs={audio_subs}: only 2 scaled subcarrier "
                    f"slots fit a {base_fs/1e6:.1f} MHz baseband — use a "
                    "wider geometry (27 MHz) for the full ladder"
                )
        sub_freqs = tuple(float(f) for f in sub_freqs)
        for f in sub_freqs:
            if f + sub_half > 0.49 * base_fs - 0.05e6:
                raise ValueError(
                    f"subcarrier {f/1e6:.2f} MHz + {sub_half/1e3:.0f} kHz "
                    f"Carson width exceeds the {base_fs/1e6:.1f} MHz "
                    "baseband's passband"
                )
        fl = sorted(sub_freqs)
        # spacing scales with the true Carson half-width (dev + f_aud),
        # not the x2-margined filter width: the authentic Astra grid
        # (180 kHz at +-50 kHz deviation) must remain expressible
        if any(b - a < 2.2 * (sub_dev + audio_bw) for a, b in zip(fl, fl[1:])):
            raise ValueError(f"subcarriers too close: {fl}")
    else:
        sub_freqs = ()

    base_cut = 0.49 * base_fs if sub_freqs else 0.5 * base_fs * 0.96
    interp = design.lowpass_taps(fs_rf, base_cut, ntaps_rf)
    rx = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(
            f, fc - 0.5 * bw, fc + 0.5 * bw, 1.0e6
        ),
        ntaps_rf,
    )
    iq = design.lowpass_taps(fs_rf, 0.5 * bw, ntaps_rf)
    dec = design.lowpass_taps(fs_rf, base_cut, ntaps_rf)
    # half-rate demod decimation filter: same time span at fs_rf/2
    dec2 = design.lowpass_taps(
        fs_rf / 2.0, base_cut, 2 * design.DEFAULT_NTAPS + 1
    )
    f1 = f_emph
    f2 = f1 / g_emph
    pre = design.freq_sampled_taps(
        base_fs, lambda f: preemph_response(f, f1, f2, g_emph)
    )
    de = design.freq_sampled_taps(
        base_fs, lambda f: 1.0 / preemph_response(f, f1, f2, g_emph)
    )
    mux_lpf = sub_lpf = aud_rx = aud_pre = None
    if sub_freqs:
        ntaps_b = 4 * design.DEFAULT_NTAPS + 1
        mux_lpf = design.lowpass_taps(
            base_fs, min(sub_freqs) - sub_half - 0.25e6, ntaps_b
        )
        # I/Q low-pass IS the subcarrier band selection: cap the cutoff
        # at just over half the closest spacing so a tight grid (e.g. the
        # 180 kHz Astra pairs at 50 kHz deviation) still rejects its
        # neighbor
        cut = sub_half + 50e3
        if len(sub_freqs) > 1:
            fl0 = sorted(sub_freqs)
            cut = min(cut, 0.55 * min(b - a for a, b in zip(fl0, fl0[1:])))
        sub_lpf = design.lowpass_taps(base_fs, cut, ntaps_b)
        # The audio emphasis/LPF taps scale with the BASEBAND RATE (fixed
        # ~600 us time span): the 50 us emphasis corner at 3.18 kHz needs
        # the FIR's frequency resolution, which is ~4*fs/ntaps — a fixed
        # 8193 resolves it at 13.5 MHz but at the 27 MHz grid it halves
        # the resolution and clipped the de-emphasis tail: measured 35/31
        # dB subcarrier audio where the fs-scaled design reads 92/62
        # (round-5 full-stack-over-satellite probe).  One FFT pass either
        # way (the same tradeoff as frame/rf.py's audio low-pass).
        nt_aud = 8192 * max(1, round(base_fs / 13.5e6)) + 1
        aud_rx = design.freq_sampled_taps(
            base_fs,
            lambda f: design.raised_cosine_bandpass_response(
                f, 0.0, audio_bw + 3e3, 6e3
            ) / _emph50_mag(f, audio_bw),
            nt_aud,
        )
        aud_pre = design.freq_sampled_taps(
            base_fs, lambda f: _emph50_mag(f, audio_bw), nt_aud
        )
    return SatPlan(
        base_fs=base_fs, n_base=n_base, r=r, fs_rf=fs_rf, n_rf=r * n_base,
        deviation=deviation, center=center, dispersal=dispersal,
        total_lines=total_lines,
        interp_taps=interp, rx_taps=rx, iq_taps=iq, dec_taps=dec,
        pre_taps=pre, de_taps=de, dec2_taps=dec2,
        sub_freqs=sub_freqs, sub_dev=sub_dev, sub_amp=sub_amp,
        audio_bw=audio_bw, mux_lpf=mux_lpf, sub_lpf=sub_lpf,
        aud_rx=aud_rx, aud_pre=aud_pre,
    )


def _carrier_patterns(n: int):
    """cos / sin of the exact fs/4 carrier: repeating [1,0,-1,0] / [0,1,0,-1]."""
    c = jnp.tile(jnp.asarray([1.0, 0.0, -1.0, 0.0], jnp.float32), n // 4)
    s = jnp.tile(jnp.asarray([0.0, 1.0, 0.0, -1.0], jnp.float32), n // 4)
    return c, s


def dispersal_offset(sp: SatPlan, gline: jax.Array) -> jax.Array:
    """Frame-synchronous triangular energy dispersal, video units (..., L).

    The real dispersal is a 25 Hz triangle; per line that is a triangle
    over the ``total_lines`` of each frame — closed form of the absolute
    line index, so chunked video runs stay chunk-size independent.
    """
    if sp.dispersal == 0.0:
        return jnp.zeros(gline.shape, jnp.float32)
    ph = (gline % (2 * sp.total_lines)).astype(jnp.float32) / sp.total_lines
    tri = 1.0 - jnp.abs(1.0 - ph) * 2.0  # -1 -> +1 -> -1 over 2 frames
    return jnp.float32(sp.dispersal) * tri


#: Stream-edge margin at the BASEBAND rate: every stream filter here
#: (pre/de-emphasis 129 taps at base rate, interp/dec 517 taps at 4x =
#: ~65 base samples of half-width) has its warm-up inside 256 samples.
#: Zero edges are not "blanking" in this model — the stream is active
#: video end to end, so an unpadded stream filter visibly clips the first
#: line (measured 0.4+ absolute error on line 0's first samples, i.e. the
#: MAC data burst).  256 * r is a multiple of 4: the fs/4 mixer patterns
#: and the decimation grid stay aligned across the crop.
_EDGE_PAD = 256


def _wrap_pad(s: jax.Array, p: int) -> jax.Array:
    """Circular (wrap-around) edge extension along the stream axis.

    The frame is modulated as ONE PERIOD of a periodic signal (the FM
    phase is closed over the frame in :func:`fm_modulate`, and the fs/4
    carrier wraps exactly because the stream length is a multiple of 4),
    so the true history of sample 0 IS the end of the stream — wrap
    padding gives every stream filter its exact neighborhood instead of a
    reflected approximation.  A real transmission is continuous (line 0
    follows the previous frame's last line); periodicity is this model's
    equivalent, with no privileged cold-start sample anywhere.
    """
    return jnp.concatenate([s[..., -p:], s, s[..., :p]], axis=-1)


def _wrap_filter(s: jax.Array, taps: np.ndarray) -> jax.Array:
    """Stream FIR with exact circular edge treatment: wrap-pad by the
    filter half-width (the frame stream is ONE PERIOD, see _wrap_pad), so
    even the 8193-tap audio filters see their true neighborhoods."""
    n = s.shape[-1]
    p = -(-(len(taps) // 2 + 1) // 8) * 8  # half-width, rounded up to 8
    if p > n:
        raise ValueError(
            f"stream of {n} samples is shorter than the {len(taps)}-tap "
            "filter's half-width — use more lines"
        )
    return fir_stream(_wrap_pad(s, p), taps)[..., p : p + n]


@_lru_cache(maxsize=8)
def _sub_trig(k_cycles: int, n_total: int):
    """cos/sin (f32) of a subcarrier completing EXACTLY ``k_cycles`` over
    the ``n_total``-sample frame stream — integer cycles per period, so
    the wrap-padded filters and the circular discriminator are exact.
    Host f64 with the product reduced mod n_total BEFORE the divide:
    k*i reaches ~1e13 (< 2^53, exact in f64), and the reduced phase is
    < 2 pi so the f32 cast costs ~1e-7 rad."""
    ph = (TWO_PI / n_total) * (
        (k_cycles * np.arange(n_total, dtype=np.float64)) % n_total
    )
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


def _audio_mux(sp: SatPlan, audio: jax.Array, l: int) -> jax.Array:
    """(B, K, L*n_base) audio in [-1, 1] -> subcarrier multiplex
    (B, L*n_base) in video units: 50 us pre-emphasis, per-frame circular
    FM on each subcarrier (deviation phase closed mod 2 pi over the frame,
    like the main carrier's in fm_modulate)."""
    a = jnp.asarray(audio, jnp.float32)
    if a.ndim == 2:
        a = a[:, None, :]
    n_tot = l * sp.n_base
    if a.shape[1] != len(sp.sub_freqs) or a.shape[-1] != n_tot:
        raise ValueError(
            f"audio shape {audio.shape} != (B, {len(sp.sub_freqs)}, {n_tot})"
        )
    a = _wrap_filter(a, sp.aud_pre)
    out = jnp.zeros(a.shape[:1] + (n_tot,), jnp.float32)
    for j, f in enumerate(sp.sub_freqs):
        k_cyc = int(round(f * n_tot / sp.base_fs))
        dphi = jnp.float32(TWO_PI * sp.sub_dev / sp.base_fs) * a[:, j]
        tot = jnp.sum(dphi, axis=-1, keepdims=True) % TWO_PI
        tot = jnp.where(tot > jnp.pi, tot - TWO_PI, tot)
        dphi = dphi - tot / n_tot
        phi = jnp.cumsum(dphi, axis=-1) - 0.5 * dphi
        c, s = _sub_trig(k_cyc, n_tot)
        out = out + jnp.float32(sp.sub_amp) * (
            jnp.asarray(c) * jnp.cos(phi) - jnp.asarray(s) * jnp.sin(phi)
        )
    return out


def fm_modulate(sp: SatPlan, base: jax.Array, gline=None,
                audio: jax.Array | None = None) -> jax.Array:
    """Baseband (B, L, N) video units -> FM signal (B, L, N*r) at IF.

    Pre-emphasis at the baseband rate, zero-stuff interpolation to the RF
    rate, midpoint-rule deviation integral per frame (line-carry wrapped
    mod 2pi, see module docstring), exact fs/4 carrier.  Stream filters
    run on reflect-padded streams (see ``_EDGE_PAD``).

    ``audio``: (B, K, L*n_base) (or (B, L*n_base) when K=1) audio in
    [-1, 1] at the baseband rate, one stream per designed subcarrier —
    added to the multiplex above the video, which is then low-passed
    below the lowest subcarrier (the plan must have ``audio_subs`` > 0).
    """
    b, l, n = base.shape
    if n != sp.n_base:
        raise ValueError(f"rows have {n} samples, plan expects {sp.n_base}")
    if audio is not None and not sp.sub_freqs:
        raise ValueError(
            "this SatPlan has no audio subcarriers — pass audio_subs= to "
            "make_sat_plan"
        )
    # video shaping as ONE composed baseband FIR (pre-emphasis, and the
    # sound-multiplex low-pass when subcarriers are designed); the wrap
    # pad is the composed filter's own half-width
    v = _wrap_filter(
        base.astype(jnp.float32).reshape(b, l * n), sp.tx_video_taps()
    )
    if sp.sub_freqs and audio is not None:
        v = v + _audio_mux(sp, audio, l)
    v = v.reshape(b, l, n)
    if gline is not None:
        # dispersal enters at the FM modulator input (after pre-emphasis),
        # matching the real chain; the receiver's de-emphasis scales a
        # per-line DC by g0 * (1/g0) = 1, so the next layer's clamp sees
        # the full dispersal offset and removes it exactly
        v = v + dispersal_offset(sp, gline)[..., None]
    # zero-stuff + anti-image LPF in one frequency-domain pass (the rfft
    # runs at the BASEBAND rate; stuffing gain r folded into the taps);
    # the PADDED baseband is stuffed so the prefix keeps the stuffing grid
    pb = _EDGE_PAD
    vp = _wrap_pad(v.reshape(b, l * n), pb)
    v_rf = upsample_fir_stream(vp, sp.interp_up_taps(), sp.r)
    v_rf = v_rf[..., pb * sp.r : pb * sp.r + l * sp.n_rf]
    v_rf = v_rf.reshape(b, l, sp.n_rf)

    # midpoint-rule FM integral of the DEVIATION (carrier = exact ramp):
    # per-line cumsum (<= ~2.4 krad unwrapped) + mod-2pi line carry
    dphi = (TWO_PI * sp.deviation / sp.fs_rf) * (
        v_rf - jnp.float32(sp.center)
    )
    # close the phase over the frame: distribute the (mod-2pi) residual of
    # the total deviation phase across all samples, so the frame is ONE
    # PERIOD of a periodic FM signal and _wrap_pad is exact at both ends.
    # The correction is < pi/n_total rad/sample = a < fs_rf/(2 n_total)
    # ~ 160 Hz carrier bias (vs 12 MHz/unit deviation): ~1e-5 video units,
    # and the downstream clamp removes line DC anyway.
    ls0 = jnp.sum(dphi, axis=-1)                            # (B, L)
    tot = jnp.cumsum(ls0 % TWO_PI, axis=-1)[..., -1:] % TWO_PI  # (B, 1)
    tot = jnp.where(tot > jnp.pi, tot - TWO_PI, tot)
    dphi = dphi - (tot / jnp.float32(l * sp.n_rf))[..., None]
    line_sum = jnp.sum(dphi, axis=-1)                       # (B, L)
    carry = jnp.cumsum(line_sum % TWO_PI, axis=-1) % TWO_PI  # (B, L)
    carry = jnp.concatenate(
        [jnp.zeros_like(carry[..., :1]), carry[..., :-1]], axis=-1
    )
    phi = jnp.cumsum(dphi, axis=-1) - 0.5 * dphi + carry[..., None]

    cpat, spat = _carrier_patterns(sp.n_rf)
    cpat = jnp.tile(cpat, l).reshape(l, sp.n_rf)
    spat = jnp.tile(spat, l).reshape(l, sp.n_rf)
    # cos(ramp + phi) = cos(ramp) cos(phi) - sin(ramp) sin(phi), with the
    # exact-pattern ramp: each term is a single VPU multiply
    return cpat * jnp.cos(phi) - spat * jnp.sin(phi)


def _demod_multiplex(sp: SatPlan, rf: jax.Array) -> jax.Array:
    """Receiver front end shared by video and sound: band-pass, exact
    fs/4 quadrature mixers, I/Q low-pass, symmetric phase-difference
    discriminator, decimation — returns the recovered baseband MULTIPLEX
    stream (B, L*n_base) in video units, before de-emphasis and before
    the video/sound band split."""
    b, l, n_rf = rf.shape
    if n_rf != sp.n_rf:
        raise ValueError(f"rows have {n_rf} RF samples, plan expects {sp.n_rf}")
    if sp.r < 2 or sp.dec2_taps is None:
        raise ValueError(
            "the half-rate demod needs r >= 2 and a plan with dec2_taps "
            "(rebuild the SatPlan with make_sat_plan)"
        )
    # Stream-edge treatment: a zero edge means zero CARRIER, and a dead
    # carrier makes the discriminator spray wideband noise that the
    # decimation LPF smears into the first line — line 0's data burst sits
    # exactly there (measured: its sync word is the first casualty under
    # channel noise).  A real receiver is continuously locked and never
    # sees a carrier start; the frame stream is ONE PERIOD (see _wrap_pad)
    # so circular extension gives every stage its true neighborhood.
    # pad % (4*r) == 0 keeps the fs/4 patterns and decimation grid aligned.
    pad = _EDGE_PAD * sp.r

    stream = _wrap_pad(rf.astype(jnp.float32).reshape(b, l * n_rf), pad)
    # HALF-RATE front end (round 4, VERDICT r3 item 1): the composed
    # complex FIR already bandlimits z to the I/Q low-pass's +-bw/2 <
    # fs_rf/4, so the front end can decimate by 2 INSIDE the
    # frequency-domain conv — the c2c ifft runs at HALF rate, and every
    # downstream stage (the arctan2 discriminator's elementwise chain,
    # the decimation conv) touches half the samples.  Feeding the stream
    # ADVANCED by one sample keeps the ODD complex-baseband samples:
    #   a[m] = (h * s1)[2m] = w[2m+1] = j(-1)^m z(2m+1)
    # so adjacent products pair z(2m+3) with z(2m+1) — the same 2-sample
    # spacing as the full-rate symmetric discriminator (|dphi| < pi at
    # the Carson deviation) reading f_inst at exactly the EVEN RF times
    # 2m+2: no fractional delay appears anywhere, and a final one-sample
    # (integer, exact) shift puts index m on time 2m for the decimation
    # grid.  The one-sample advance/shift edge-holds land inside the
    # cropped pad margin.
    s1 = jnp.concatenate([stream[..., 1:], stream[..., -1:]], axis=-1)
    a = conv_decim_stream(s1, sp.h_demod2_taps(), 2)
    i, q = a.real, a.imag
    # adjacent-product discriminator: a[m+1]conj(a[m]) = -z(2m+3)z*(2m+1)
    # (the |j|^2 (-1)^(2m+1) rotation residue), angle/(2 RF samples)
    ip = jnp.concatenate([i[..., 1:], i[..., -1:]], axis=-1)
    qp = jnp.concatenate([q[..., 1:], q[..., -1:]], axis=-1)
    re = -(ip * i + qp * q)
    imag = -(qp * i - ip * q)
    f_dev = jnp.arctan2(imag, re) * jnp.float32(sp.fs_rf / (2.0 * TWO_PI))
    # f_dev[m] reads time 2m+2; delay one half-rate sample -> time 2m
    f_dev = jnp.concatenate([f_dev[..., :1], f_dev[..., :-1]], axis=-1)

    v = f_dev / jnp.float32(sp.deviation) + jnp.float32(sp.center)
    # low-pass + decimate the remaining r//2 in one pass (the ifft runs
    # at the baseband rate)
    v = fir_decim_stream(v, sp.dec_down2_taps(), sp.r // 2)
    pc = pad // sp.r
    return v[..., pc : pc + l * sp.n_base]                   # crop


def fm_demodulate(sp: SatPlan, rf: jax.Array) -> jax.Array:
    """FM signal (B, L, N*r) -> baseband (B, L, N) video units.

    The shared front end (:func:`_demod_multiplex`), then the video side
    of the multiplex: sound subcarriers low-passed away (when designed),
    de-emphasis.  Dispersal (if transmitted) is still present in the
    output — the next layer's clamp removes it, as in the real receiver.
    """
    b, l, _ = rf.shape
    v = _demod_multiplex(sp, rf)
    # subcarrier-reject + de-emphasis as ONE composed baseband FIR
    v = _wrap_filter(v, sp.rx_video_taps())
    return v.reshape(b, l, sp.n_base)


def fm_demodulate_audio(sp: SatPlan, rf: jax.Array) -> jax.Array:
    """FM signal (B, L, N*r) -> subcarrier audio (B, K, L*n_base).

    The sound side of the multiplex: per subcarrier, quadrature mix with
    the exact integer-cycles-per-frame carrier (so the mixed baseband is
    itself frame-periodic), I/Q low-pass (which IS the band selection —
    the neighboring subcarrier lands >= 2.2 Carson widths away and the
    low-pass removes it), circular symmetric discriminator, audio
    low-pass combined with 50 us de-emphasis in one FIR.
    """
    if not sp.sub_freqs:
        raise ValueError("this SatPlan has no audio subcarriers")
    b, l, _ = rf.shape
    mux = _demod_multiplex(sp, rf)
    n_tot = l * sp.n_base
    outs = []
    for f in sp.sub_freqs:
        k_cyc = int(round(f * n_tot / sp.base_fs))
        c, s = _sub_trig(k_cyc, n_tot)
        i = _wrap_filter(mux * (2.0 * jnp.asarray(c)), sp.sub_lpf)
        q = _wrap_filter(mux * (-2.0 * jnp.asarray(s)), sp.sub_lpf)
        # circular symmetric discriminator — jnp.roll is EXACT here
        # because the mixed-down stream is frame-periodic by construction
        ip, im = jnp.roll(i, -1, -1), jnp.roll(i, 1, -1)
        qp, qm = jnp.roll(q, -1, -1), jnp.roll(q, 1, -1)
        f_dev = jnp.arctan2(qp * im - ip * qm, ip * im + qp * qm) * (
            jnp.float32(sp.base_fs / (2.0 * TWO_PI))
        )
        a = _wrap_filter(f_dev / jnp.float32(sp.sub_dev), sp.aud_rx)
        # AC coupling (every real sound IF is): removes the ~100 Hz
        # carrier bias left by the per-frame FM phase closure, which
        # otherwise floors non-zero-mean audio at ~45 dB
        outs.append(a - jnp.mean(a, axis=-1, keepdims=True))
    return jnp.stack(outs, axis=1)


def noise_sigma(sp: SatPlan, cnr_db: float) -> float:
    """White-noise sigma for a given carrier-to-noise ratio.

    CNR is referenced to the noise power inside the receiver band-pass
    (the convention link budgets use): carrier power is 1/2 (unit cos),
    the band-pass passes ~bw/fs_rf of white noise power, so
    sigma^2 = (1/2) / CNR / (bw_fraction).  Host design-time math, so
    callers (e.g. the chunked video runner) can key their own per-frame
    noise realizations.
    """
    H = np.fft.rfft(np.asarray(sp.rx_taps), n=1 << 15)
    bw_frac = float(np.sum(np.abs(H) ** 2) / len(H) / np.max(np.abs(H)) ** 2)
    cnr = 10.0 ** (cnr_db / 10.0)
    return float(np.sqrt(0.5 / cnr / max(bw_frac, 1e-6)))


def awgn(sp: SatPlan, rf: jax.Array, key, cnr_db: float) -> jax.Array:
    """Add channel noise at a given carrier-to-noise ratio."""
    sigma = noise_sigma(sp, cnr_db)
    return rf + sigma * jax.random.normal(key, rf.shape, rf.dtype)


def sat_roundtrip(sp: SatPlan, base: jax.Array, gline=None,
                  key=None, cnr_db: float | None = None) -> jax.Array:
    rf = fm_modulate(sp, base, gline)
    if cnr_db is not None:
        rf = awgn(sp, rf, key, cnr_db)
    return fm_demodulate(sp, rf)


# --- public-entry jit (one compiled program per call; utils/jitwrap) ---
# fm_modulate's upsample and the demod front end carry complex spectra
# from dsp/stream.py; awgn/sat_roundtrip are real-elementwise or pure
# callers of wrapped functions and stay plain.
from color_modem_tpu.utils.jitwrap import plan_jit as _plan_jit

fm_modulate = _plan_jit(fm_modulate)
fm_demodulate = _plan_jit(fm_demodulate)
fm_demodulate_audio = _plan_jit(fm_demodulate_audio)
