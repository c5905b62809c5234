"""RF/IF vestigial-sideband picture transmission (beyond-reference).

Extends the simulation chain one layer outward from the composite signal:

    composite -> negative-AM VSB picture signal at a low IF
              -> Nyquist-flank receiver + synchronous detection -> composite

None of this exists in the reference (SURVEY.md §2.1 stops at the
composite), but it is the canonical next stage of every real analog TV
chain (BT.470 §3: vestigial-sideband AM, negative polarity for Systems
M/B/G/D/K; the receiver Nyquist flank is standard textbook practice).
Receiver structures: coherent product detection (clean; carrier phase
recoverable from the signal via :func:`recover_carrier_phase`) and
envelope detection (phase-immune, authentic VSB quadrature distortion).
An intercarrier FM sound channel rides above the video sideband.

Time model: row-major composite samples are treated as ONE contiguous
stream per frame — the same convention as frame/channel.py's ghost delay
(`_stream_delay`).  Works for active-only (L, N) blocks and for rastered
lines (frame/raster.py), where the stream really is gap-free time.

Design:

* The picture carrier is a closed-form NCO, like the chroma subcarrier
  (dsp/nco.py): the carrier frequency is snapped to a HALF-INTEGER number
  of cycles per row, so the row-start phase alternates 0/pi — a (-1)^row
  sign, no sequential phase state.  Rows, frames and batch items stay
  independent: vmap/shard-compatible, continuous across the stream.
* All filtering is design-time FIR taps (dsp/design.freq_sampled_taps)
  applied by overlap-save pow2-FFT convolution over the whole stream
  (dsp/stream.py): line-seam-free, and the long (~1k tap) channel
  filters cost the same as short ones this way.
* Each direction's filter-mix-filter cascade is COMPOSED into one
  complex FIR (RFPlan.mod_taps/dem_taps/snd_dem_taps) via the modulation
  identity ``h*(y cos wn) = Re{e^{jwn}((h e^{-jw·})*y)}``, with the
  rate change done in the frequency domain (dsp/stream.upconv_stream /
  conv_decim_stream): the interpolation rfft runs at the composite rate
  and the detection ifft at the decimated rate, so a roundtrip pays
  ~2.25 complex-FFT-equivalents instead of the 8 real transforms of the
  naive chain.
* Integer-R up/down sampling reuses the one video lowpass design as both
  the interpolation (anti-image) filter on the way up and the
  post-detection/decimation filter on the way down.

Transparency vs authenticity: the default video bandwidth is 0.46*fs
("transparency mode" — the RF hop passes everything the composite can
carry, so it composes with any decoder at full quality).  Authentic
channel bandwidths (NTSC 4.2 MHz, PAL B/G 5.0, SECAM 6.0) can be forced
with ``f_video=`` — narrower than the composite's chroma top end, so
expect the authentic quality loss.  The FM sound intercarrier sits
above the video sideband either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp import design
from color_modem_tpu.dsp.apply import fir_same_fft
from color_modem_tpu.dsp.stream import fir_stream
from color_modem_tpu.dsp.nco import sample_phase_ramp
from color_modem_tpu.dsp.stream import (
    _carrier_taps,
    conv_decim_stream,
    pad_taps_center,
    upconv_stream,
)
from color_modem_tpu.modem.plan import ModemPlan

TWO_PI = 2.0 * np.pi

#: Negative-modulation envelope map (BT.470 System M levels, fractions of
#: peak carrier): sync tip 100 %, blanking 75 %, peak white 12.5 %.  With
#: raster.SYNC_LEVEL = -0.4 video units, one linear map covers all three:
#: env = BLANK - (BLANK - WHITE) * v  ->  env(-0.4) = 1.0 exactly.
ENV_BLANK = 0.75
ENV_WHITE = 0.125

#: Design margins (Hz): band-edge transition width, guard to DC/Nyquist.
_TRANSITION = 0.3e6
_GUARD = 0.2e6


# _carrier_taps (the modulation-identity tap helper) lives in
# dsp/stream.py beside the 'same'-centering contract it encodes; imported
# above, shared with frame/satellite.py.


def _nyquist_flank(f, fc: float, f_vestige: float, f_video: float,
                   transition: float = _TRANSITION):
    """Receiver response: raised-cosine flank through 0.5 at the carrier
    (width 2*f_vestige), flat over the upper sideband, raised-cosine
    rolloff after ``fc + f_video``.  The flank folds the twice-received
    DSB band [fc - f_v, fc + f_v] back to unity: H(fc+f) + H(fc-f) = 1."""
    f = np.asarray(f, dtype=np.float64)
    lo, hi = fc - f_vestige, fc + f_vestige
    flank = np.where(
        f <= lo, 0.0,
        np.where(f >= hi, 1.0, 0.5 * (1 - np.cos(np.pi * (f - lo) / (hi - lo)))),
    )
    top = fc + f_video
    roll = np.where(
        f <= top, 1.0,
        np.where(
            f >= top + transition, 0.0,
            0.5 * (1 + np.cos(np.pi * (f - top) / transition)),
        ),
    )
    return flank * roll


@dataclasses.dataclass(frozen=True, eq=False)
class RFPlan:
    """Config-time RF geometry + filter taps for one (plan, R) pair.

    ``eq=False`` keeps the object hashable by identity so it can be a
    ``jax.jit`` static argument (the utils/jitwrap entry points) — the
    generated field-wise ``__hash__`` would choke on the numpy taps."""

    plan: ModemPlan
    r: int                  # oversampling: fs_rf = r * plan.fs
    row_samples: int        # composite samples per row (plan.n_samples, or
                            # raster.n_total for rastered lines)
    fc: float               # picture carrier, Hz (exact: cpl_num/2 cycles/row)
    cpl_num: int            # carrier cycles per row = cpl_num / 2 (odd)
    f_vestige: float        # lower (vestigial) sideband width, Hz
    f_video: float          # upper sideband width, Hz
    tx_taps: np.ndarray     # VSB shaping bandpass (fs_rf)
    rx_taps: np.ndarray     # Nyquist-flank receiver bandpass (fs_rf)
    det_taps: np.ndarray    # post-detection video lowpass (fs_rf)
    ramp: np.ndarray        # (N*r,) within-row carrier phase ramp, f64
    # --- intercarrier FM sound (None-free; sound is always designed) ----
    f_snd: float            # sound carrier, Hz (exact: snd_num/2 cycles/row)
    snd_num: int
    snd_dev: float          # peak FM deviation, Hz (audio in [-1, 1])
    snd_amp: float          # sound carrier amplitude vs peak picture carrier
    snd_bpf: np.ndarray     # receiver sound-takeoff bandpass (fs_rf)
    snd_lpf: np.ndarray     # post-mix I/Q lowpass (fs_rf)
    aud_lpf: np.ndarray     # recovered-audio lowpass (composite rate fs)
    snd_ramp: np.ndarray    # (N*r,) sound-carrier phase ramp, f64

    @property
    def fs_rf(self) -> float:
        return self.r * self.plan.fs

    @property
    def n_rf(self) -> int:
        """RF samples per row."""
        return self.row_samples * self.r

    def mod_taps(self, df: float = 0.0) -> np.ndarray:
        """Composed complex modulate filter (VERDICT r2 item 3): the
        anti-image video lowpass, the carrier mix at ``fc + df`` and the
        VSB shaping collapse into ONE complex FIR via the modulation
        identity ``h*(y·cos wn) = Re{e^{jwn}·((h·e^{-jw·})*y)}`` — so the
        whole composite->RF chain is one :func:`dsp.stream.upconv_stream`
        pass plus an elementwise carrier multiply.  Includes the
        zero-stuffing gain ``r``."""
        w = TWO_PI * (self.fc + df) / self.fs_rf
        return pad_taps_center(
            self.r * np.convolve(_carrier_taps(self.tx_taps, -w),
                                 self.det_taps),
            2 * self.r,
        )

    def dem_taps(self, df: float = 0.0) -> np.ndarray:
        """Composed complex demodulate filter: Nyquist-flank selection,
        product mix at ``fc + df`` and post-detection lowpass as ONE
        complex FIR for :func:`dsp.stream.conv_decim_stream`; the carrier
        rotation moves outside, to the decimated (composite) rate."""
        w = TWO_PI * (self.fc + df) / self.fs_rf
        return pad_taps_center(
            np.convolve(_carrier_taps(self.det_taps, -w), self.rx_taps),
            2 * self.r,
        )

    def snd_dem_taps(self, df: float = 0.0) -> np.ndarray:
        """Composed complex sound-takeoff filter: sound bandpass + I/Q mix
        at ``f_snd + df`` + I/Q lowpass as one complex FIR (factor 2 of
        the quadrature mix included)."""
        w = TWO_PI * (self.f_snd + df) / self.fs_rf
        return pad_taps_center(
            2.0 * np.convolve(_carrier_taps(self.snd_lpf, +w),
                              self.snd_bpf),
            2 * self.r,
        )

    @property
    def ramp_comp(self) -> np.ndarray:
        """Within-row picture-carrier phase at the COMPOSITE rate (the
        decimated grid): fc is a half-integer number of cycles per row at
        either rate, so the (-1)^row law carries over unchanged."""
        return sample_phase_ramp(self.fc, self.plan.fs, self.row_samples)

    @property
    def snd_ramp_comp(self) -> np.ndarray:
        return sample_phase_ramp(self.f_snd, self.plan.fs, self.row_samples)

    @property
    def video_zero(self) -> float:
        """Composite level at which the carrier nulls (env = 0): the
        pivot about which any RF-linear channel (e.g. :func:`rf_ghost`)
        is linear at composite rate — pass to
        ``frame.equalize.design_equalizer(pivot=...)`` and
        ``apply_equalizer(pivot=...)``."""
        return ENV_BLANK / (ENV_BLANK - ENV_WHITE)


def make_rf_plan(
    plan: ModemPlan,
    r: int = 4,
    fc: float | None = None,
    f_video: float | None = None,
    ntaps: int = 1025,
    intercarrier: float | None = None,
    snd_dev: float | None = None,
    snd_amp: float = 0.2,
    audio_bw: float = 15e3,
    snd_ntaps: int = 4097,
    transition: float = _TRANSITION,
    row_samples: int | None = None,
) -> RFPlan:
    """Design the RF geometry and filters for ``plan`` at oversampling ``r``.

    The carrier frequency is snapped to the nearest half-integer number of
    cycles per row so its phase law is closed-form (see module docstring);
    defaults put it at ``f_video + 2 MHz``, comfortably clear of both the
    synchronous detector's 2fc image band and RF Nyquist.

    ``transition`` is the band-edge rolloff width of the video filters
    (default 0.3 MHz).  The authentic System-M geometry (4.2 MHz video,
    4.5 MHz intercarrier) leaves only 300 kHz between video top and sound
    carrier — like the real channel, it needs the sharper edge
    (``transition=0.2e6``) to fit.
    """
    if r < 1 or r & (r - 1):
        raise ValueError(
            f"make_rf_plan: oversampling r={r} must be a power of two — "
            "the stream engine's rate changes partition pow2 FFT blocks "
            "into r dense sub-blocks (dsp/stream._check_rate)"
        )
    fs = plan.fs
    fs_rf = r * fs
    # rastered lines are longer rows on the SAME sample clock: pass
    # raster.n_total so the half-integer cycles/row carrier law stays
    # exact for the actual row length (tests/test_rf.py raster test)
    n = plan.n_samples if row_samples is None else int(row_samples)
    if f_video is None:
        # transparency mode (module docstring).  SECAM's FM sidebands run
        # right up to ~6.5 MHz (standards/__init__.py), so the FM standards
        # get the extra headroom: 0.46 fs clipped the sideband tops to a
        # 40.6 dB composite transparency, 0.49 fs measures 56.7 dB (the
        # decoded picture is unaffected either way — the clipped tops are
        # above the bell takeoff — but headroom is free here).
        f_video = (0.49 if plan.cfg.is_fm else 0.46) * fs
    # vestige per BT.470: 0.75 MHz for System M (525), 1.25 MHz for 625-line
    f_vestige = 0.75e6 if plan.cfg.total_lines == 525 else 1.25e6
    if fc is None:
        fc = f_video + 2.0e6
    # snap to a half-integer number of carrier cycles per N-sample row
    cpl_num = 2 * int(round(fc * n / fs - 0.5)) + 1
    fc = cpl_num / 2 * fs / n
    # feasibility: [the synchronous detector's sum band, lowest component
    # 2fc - f_vestige, must clear the video band] and [upper sideband +
    # transition inside RF Nyquist] and [vestige clear of DC]
    if 2 * fc - f_vestige < f_video + transition + _GUARD:
        raise ValueError(
            f"fc={fc/1e6:.2f} MHz too low: the 2fc detection image "
            f"(down to {(2*fc - f_vestige)/1e6:.2f} MHz) overlaps the "
            f"{f_video/1e6:.2f} MHz video band — raise fc"
        )
    if fc + f_video + transition > fs_rf / 2 - _GUARD:
        raise ValueError(
            f"fc+f_video={(fc+f_video)/1e6:.2f} MHz exceeds RF Nyquist "
            f"{fs_rf/2e6:.2f} MHz — raise r (r={r})"
        )
    if fc - f_vestige < _GUARD:
        raise ValueError(f"fc={fc/1e6:.2f} MHz leaves no room for the vestige")

    tx_taps = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(
            f, fc - f_vestige, fc + f_video, transition
        ),
        ntaps,
    )
    rx_taps = design.freq_sampled_taps(
        fs_rf,
        lambda f: _nyquist_flank(f, fc, f_vestige, f_video, transition),
        ntaps,
    )
    det_taps = design.lowpass_taps(fs_rf, f_video + transition, ntaps)

    # --- intercarrier FM sound ------------------------------------------
    # Authentic intercarrier spacings (4.5 / 5.5 / 6.5 MHz) assume the
    # authentic video bandwidths; in transparency mode (f_video = 0.46 fs)
    # the carrier must clear the wider video sideband, so the default is
    # relative: f_video + 0.75 MHz.  Deviation per BT.470: +-25 kHz for
    # System M (525 lines), +-50 kHz for the 625-line systems.
    if intercarrier is None:
        intercarrier = f_video + 0.75e6
    if snd_dev is None:
        snd_dev = 25e3 if plan.cfg.total_lines == 525 else 50e3
    snd_num = 2 * int(round((fc + intercarrier) * n / fs - 0.5)) + 1
    f_snd = snd_num / 2 * fs / n
    snd_half = 2.0 * (snd_dev + audio_bw)  # Carson bandwidth, half-width x2 margin
    if f_snd - snd_half < fc + f_video + transition:
        raise ValueError(
            f"sound carrier {f_snd/1e6:.2f} MHz overlaps the video "
            f"sideband top {(fc + f_video)/1e6:.2f} MHz — raise intercarrier"
        )
    if f_snd + snd_half > fs_rf / 2 - _GUARD:
        raise ValueError(
            f"sound carrier {f_snd/1e6:.2f} MHz too close to RF Nyquist "
            f"{fs_rf/2e6:.2f} MHz — raise r"
        )
    snd_bpf = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(
            f, f_snd - snd_half, f_snd + snd_half, snd_half
        ),
        snd_ntaps,
    )
    snd_lpf = design.lowpass_taps(fs_rf, snd_half, snd_ntaps)
    # The audio lowpass runs at the COMPOSITE rate, so its transition width
    # is ~4*fs/ntaps: 2049 taps at 13.5 MHz put a 26 kHz transition right
    # across the audio band (measured: a 7 kHz tone lost ~6% -> 32 dB
    # two-tone SNR).  8193 taps at 13.5 MHz narrow it to ~6.6 kHz — and
    # the count scales with fs (fixed time span) so the 27 MHz/1440
    # grid keeps the same passband flatness; the FFT-conv cost is
    # unchanged either way.
    aud_lpf = design.lowpass_taps(
        fs, audio_bw + 3e3, 8192 * max(1, round(fs / 13.5e6)) + 1
    )
    return RFPlan(
        plan=plan, r=r, row_samples=n, fc=fc, cpl_num=cpl_num,
        f_vestige=f_vestige, f_video=f_video,
        tx_taps=tx_taps, rx_taps=rx_taps, det_taps=det_taps,
        ramp=sample_phase_ramp(fc, fs_rf, n * r),
        f_snd=f_snd, snd_num=snd_num, snd_dev=snd_dev, snd_amp=snd_amp,
        snd_bpf=snd_bpf, snd_lpf=snd_lpf, aud_lpf=aud_lpf,
        snd_ramp=sample_phase_ramp(f_snd, fs_rf, n * r),
    )


def _abs_rows(frame0, b: int, l: int):
    """(B, L) absolute row indices, keyed by the ABSOLUTE frame index so
    video chunks stay phase-continuous (frame/video.py)."""
    g = (jnp.asarray(frame0, jnp.int32) + jnp.arange(b, dtype=jnp.int32))
    return g[:, None] * jnp.int32(l) + jnp.arange(l, dtype=jnp.int32)[None, :]


def _row_sign(rfp: RFPlan, frame0, b: int, l: int):
    """(-1)^(absolute row index): the carrier's row-start phase (half-
    integer cycles/row => alternating 0/pi)."""
    rows = _abs_rows(frame0, b, l)
    return (1.0 - 2.0 * (rows % 2).astype(jnp.float32))


def _df_phase(rfp: RFPlan, df: float, frame0, b: int, l: int,
              comp_rate: bool = False):
    """(B, L, n_rf) extra carrier phase (radians) of a STATIC frequency
    offset ``df`` Hz: 2*pi*df*t over the contiguous stream, keyed by the
    absolute row index so video chunks stay phase-continuous.

    Precision: the row-start part is (df*n/fs * row) mod 1 cycles with
    ``row`` up to ~1e6 for long video — a single f32 product would lose
    the fraction entirely.  Split the row index as row = q*4096 + r and
    reduce each factor's CYCLES mod 1 in host f64 first: q <= 256 and
    r < 4096 keep both f32 products' absolute error below ~5e-4 cycles
    (0.2 deg).  The within-row ramp is exact host f64, frac-reduced.

    ``comp_rate``: evaluate on the COMPOSITE (decimated-by-r) sample grid
    instead — shape (B, L, row_samples); the row-start law is identical
    (same rows, same duration), only the within-row ramp subsamples.
    """
    n = rfp.row_samples
    cyc = float(df) * n / rfp.plan.fs           # cycles per row (f64)
    frac1 = cyc % 1.0                           # per-row step
    frac2 = (4096.0 * cyc) % 1.0                # per-4096-row step
    rows = _abs_rows(frame0, b, l)
    q, rr = rows // 4096, rows % 4096
    cycles = (q.astype(jnp.float32) * np.float32(frac2)
              + rr.astype(jnp.float32) * np.float32(frac1)) % 1.0
    fs_here = rfp.plan.fs if comp_rate else rfp.fs_rf
    n_here = rfp.row_samples if comp_rate else rfp.n_rf
    in_row = jnp.asarray(
        TWO_PI * ((float(df) / fs_here)
                  * np.arange(n_here, dtype=np.float64) % 1.0),
        jnp.float32,
    )
    return (TWO_PI * cycles)[:, :, None] + in_row[None, None, :]


def rf_modulate(rfp: RFPlan, comp, frame0=0, audio=None, df: float = 0.0):
    """Composite (B, L, N) video units -> VSB picture RF (B, L, N*r).

    Negative AM (sync tip = peak carrier), zero-stuffed to the RF rate,
    mixed onto the closed-form carrier, VSB-shaped in one FFT pass over
    the contiguous stream (which also removes the zero-stuffing images).

    ``audio``: optional (B, L*N) mono audio in [-1, 1] at the COMPOSITE
    rate (one audio sample per video sample) — added as the intercarrier
    FM sound carrier.  ZOH upsampling to the RF rate is exact enough here:
    the ZOH images FM-map to sidebands at beta ~ dev/fs < 2e-3, i.e.
    < -60 dB, outside every receiver filter.

    ``df``: transmitter mistuning, Hz — BOTH carriers shift together
    (they come from the same LO chain), which is exactly why intercarrier
    sound exists: the 4.5 MHz picture-sound spacing is mistuning-immune.
    The picture carrier slides off the receiver's Nyquist-flank 0.5 point
    (a small gain tilt, ~df/2f_vestige) and, far worse, rolls the phase
    of any fixed-frequency mixer — see :func:`recover_carrier_frequency`
    for the receiver-side AFT that undoes it.
    """
    b, l, n = comp.shape
    if n != rfp.row_samples:
        raise ValueError(
            f"rf_modulate: rows have {n} samples but the RF plan was "
            f"designed for {rfp.row_samples} — pass row_samples= to "
            "make_rf_plan (e.g. raster.n_total for rastered lines)"
        )
    env = ENV_BLANK - (ENV_BLANK - ENV_WHITE) * comp.astype(jnp.float32)
    # One composed pass (RFPlan.mod_taps): zero-stuff interpolation,
    # anti-image lowpass, carrier mix and VSB shaping collapse into a
    # single complex upconversion filter; only the carrier rotation
    # remains outside, elementwise on the closed-form NCO arrays.  The
    # forward rfft runs at the COMPOSITE rate (dsp/stream.py).
    v = upconv_stream(
        env.reshape(b, l * n), rfp.mod_taps(df), rfp.r
    ).reshape(b, l, rfp.n_rf)
    if df != 0.0:
        ph = (jnp.asarray(rfp.ramp, jnp.float32)[None, None, :]
              + _df_phase(rfp, df, frame0, b, l))
        cos_t, sin_t = jnp.cos(ph), jnp.sin(ph)
    else:
        cos_t = jnp.asarray(np.cos(rfp.ramp), jnp.float32)[None, None, :]
        sin_t = jnp.asarray(np.sin(rfp.ramp), jnp.float32)[None, None, :]
    rf = (jnp.real(v) * cos_t - jnp.imag(v) * sin_t) * _row_sign(
        rfp, frame0, b, l
    )[:, :, None]
    if audio is not None:
        # FM: phase = closed-form carrier ramp + deviation integral.  The
        # integral is ONE cumsum over the contiguous stream (VPU work; the
        # f32 random-walk rounding is ~60 dB below the deviation after the
        # audio lowpass).  cos(pi*row + x) = row_sign * cos(x), so the
        # carrier's half-integer row law still factors out of the FM term.
        a_rf = jnp.repeat(
            jnp.asarray(audio, jnp.float32), rfp.r, axis=-1
        )  # (B, L*N*r) zero-order hold (plain RF-rate integral — the
        #    telescoped variant regressed the fused row, sound_on_rf note)
        dphi = (2.0 * np.pi * rfp.snd_dev / rfp.fs_rf) * a_rf
        phi_dev = jnp.cumsum(dphi, axis=-1).reshape(b, l, rfp.n_rf)
        ramp = jnp.asarray(rfp.snd_ramp, jnp.float32)
        phi = ramp[None, None, :] + phi_dev
        if df != 0.0:  # same LO chain: the sound carrier shifts too
            phi = phi + _df_phase(rfp, df, frame0, b, l)
        snd = jnp.cos(phi)
        rf = rf + rfp.snd_amp * snd * _row_sign(rfp, frame0, b, l)[:, :, None]
    return rf


#: DOC carrier-loss threshold: the legitimate envelope never falls below
#: the peak-white level ENV_WHITE = 0.125, so anything under half of it
#: can only be carrier loss — detection is unambiguous, which is exactly
#: why real dropout compensators key on the RF envelope and not on video.
DOC_THRESHOLD = 0.06


def rf_demodulate(rfp: RFPlan, rf, frame0=0, detection: str = "sync",
                  phase_error: float = 0.0, doc: bool = False,
                  agc: bool = False, freq_error: float = 0.0):
    """VSB picture RF (B, L, N*r) -> composite (B, L, N) video units.

    Nyquist-flank selectivity, detection, post-detection lowpass (which
    is also the decimation filter), strided decimation, envelope-map
    inversion.  Two detectors:

    * ``"sync"`` — synchronous (coherent) product detection against the
      closed-form carrier: the textbook-clean VSB receiver, but it needs
      the carrier phase.  ``phase_error`` (radians) models a mis-locked
      local oscillator: gain falls as cos(err) and the VSB quadrature
      component leaks in (90 deg = picture gone).
    * ``"envelope"`` — I/Q magnitude (the vectorized equivalent of a
      diode envelope detector): insensitive to carrier phase entirely,
      at the cost of the authentic VSB quadrature distortion on
      high-frequency content (the reason real TV keeps the modulation
      depth off 100 %).  With the composed complex detection filter the
      envelope is literally ``4|z|`` — no extra filter pass.

    ``doc``: dropout compensation — samples whose detected envelope sits
    below :data:`DOC_THRESHOLD` (carrier loss, see the constant's note;
    e.g. :func:`rf_dropout` tape hits) are replaced with the PREVIOUS
    LINE's samples, the classic 1H-delay compensator.  The detected mask
    is dilated a few samples to cover the detection filters' edge ramps.

    ``agc``: sync-tip keyed automatic gain control — THE reason negative
    modulation puts sync at peak carrier: the sync tip is a constant
    amplitude reference regardless of picture content, so the receiver
    normalizes the envelope by its robust maximum (99.9th percentile per
    batch item).  Needs a RASTERED composite (sync present); on a clean
    unit-gain signal it is a near-exact no-op.

    ``freq_error``: receiver LO frequency offset, Hz — the mixers run at
    ``fc + freq_error``.  Pass :func:`recover_carrier_frequency`'s
    estimate to track a mistuned transmitter (``rf_modulate(df=...)``);
    the residual Nyquist-flank misalignment is the authentic ~df/2f_v
    gain tilt a real AFT also leaves until the tuner itself retunes.
    Envelope detection is immune to frequency error at the mixer for the
    same rotation-invariance reason as phase error.
    """
    b, l, n_rf = rf.shape
    # Composed pass (RFPlan.dem_taps): Nyquist-flank selection, product
    # mix and post-detection lowpass as ONE complex filter, decimated to
    # the composite rate in the frequency domain (dsp/stream.py) —
    # z[m] = (det~ * rx * x)[r m].  The carrier rotation applies at the
    # DECIMATED rate: fc is a half-integer number of cycles per row at
    # the composite rate too (ramp_comp), so the (-1)^row law holds.
    # Product detector gain 4: x2 to cancel the cos^2 halving, and x2
    # because the Nyquist-flank convention H(fc+f) + H(fc-f) = 1 delivers
    # HALF the envelope everywhere (USB-only region: A/2 * 1; DSB region:
    # A/2 * [H+ + H-] = A/2).
    z = conv_decim_stream(
        rf.reshape(b, l * n_rf), rfp.dem_taps(freq_error), rfp.r
    ).reshape(b, l, rfp.row_samples)
    sign = _row_sign(rfp, frame0, b, l)[:, :, None]
    if detection == "sync":
        if freq_error != 0.0:
            ph = (jnp.asarray(rfp.ramp_comp + phase_error,
                              jnp.float32)[None, None, :]
                  + _df_phase(rfp, freq_error, frame0, b, l,
                              comp_rate=True))
            mix_c, mix_s = jnp.cos(ph), jnp.sin(ph)
        else:
            mix_c = jnp.asarray(np.cos(rfp.ramp_comp + phase_error),
                                jnp.float32)[None, None, :]
            mix_s = jnp.asarray(np.sin(rfp.ramp_comp + phase_error),
                                jnp.float32)[None, None, :]
        env = 4.0 * (jnp.real(z) * mix_c - jnp.imag(z) * mix_s) * sign
    elif detection == "envelope":
        # phase_error/freq_error at the mixer cannot matter: a mixer
        # offset only rotates the complex z, and the magnitude is
        # rotation-invariant — that insensitivity is the whole point of
        # envelope detection (here it is literally |z|).
        env = 4.0 * jnp.abs(z)
    else:
        raise ValueError(f"unknown detection {detection!r}")
    if agc:
        # the sync plateau holds ~7% of the samples (4.7 us of each
        # line), all at the SAME level: the 97.5th percentile lands
        # mid-plateau, away from both picture content below and the
        # detection filters' ring overshoot at the extreme tail (a
        # 99.9th-percentile reference measured ~1% high -> 42 dB floor)
        b_ = env.shape[0]
        ref = jnp.quantile(env.reshape(b_, -1), 0.975, axis=-1)
        env = env / jnp.maximum(ref, 1e-6)[:, None, None]
    if doc:
        lost = env < DOC_THRESHOLD
        for k in (1, 2, 3, 4):  # dilate over the detection-filter ramps
            lost = lost | jnp.roll(lost, k, -1) | jnp.roll(lost, -k, -1)
        prev_line = jnp.concatenate([env[:, :1], env[:, :-1]], axis=1)
        env = jnp.where(lost, prev_line, env)
    return (ENV_BLANK - env) / (ENV_BLANK - ENV_WHITE)


def rf_cochannel(rfp: RFPlan, comp, frame0=0, offset_num: int = 1,
                 offset_den: int = 2):
    """Co-channel interferer: a second station's VSB picture on the SAME
    channel, its carrier offset by ``offset_num/offset_den`` CYCLES PER
    ROW (offset frequency = that fraction of the line rate; 1/2 = the
    classic half-line "precision offset", 0/1 = no offset).  Returns the
    interferer's RF — scale by the protection ratio and add to the wanted
    signal.

    Why the offset exists: the beat between the two carriers rides into
    the detected video; with a half-line offset its phase reverses every
    line AND every frame (odd total half-cycles per frame for any integer
    line count... the line reversal makes the venetian-blind bars a fine
    interleaved pattern and the frame reversal cancels them in temporal
    integration — the eye's, or a 2-frame average, which is what the test
    measures).  The offset carrier's phase law stays closed-form: cycles
    per row = cpl_num/2 + offset is rational, so the row-start phase is
    dsp.nco.line_phase0's exact int arithmetic — no sequential state.
    """
    from color_modem_tpu.dsp.nco import line_phase0

    b, l, n = comp.shape
    if n != rfp.row_samples:
        raise ValueError(
            f"rf_cochannel: rows have {n} samples, plan expects "
            f"{rfp.row_samples}"
        )
    env = ENV_BLANK - (ENV_BLANK - ENV_WHITE) * comp.astype(jnp.float32)
    # offset carrier: cpl2 = cpl_num/2 + offset_num/offset_den
    num = rfp.cpl_num * offset_den + 2 * offset_num
    den = 2 * offset_den
    phi0 = line_phase0(num, den, _abs_rows(frame0, b, l))
    fh = rfp.plan.fs / rfp.row_samples
    fc2 = rfp.fc + offset_num / offset_den * fh
    # composed modulate filter at the OFFSET carrier (the identity needs
    # the taps modulated at the actual mix frequency; host, per offset)
    w2 = TWO_PI * fc2 / rfp.fs_rf
    taps2 = pad_taps_center(
        rfp.r * np.convolve(_carrier_taps(rfp.tx_taps, -w2), rfp.det_taps),
        2 * rfp.r,
    )
    v = upconv_stream(
        env.reshape(b, l * n), taps2, rfp.r
    ).reshape(b, l, rfp.n_rf)
    ph = phi0[:, :, None] + jnp.asarray(
        sample_phase_ramp(fc2, rfp.fs_rf, rfp.n_rf), jnp.float32
    )[None, None, :]
    return jnp.real(v) * jnp.cos(ph) - jnp.imag(v) * jnp.sin(ph)


def rf_ghost(rfp: RFPlan, rf, delay_us: float, gain: float):
    """Multipath ghost AT RF: add a delayed, attenuated copy of the RF
    stream (B, L, N*r -> same).

    Unlike the composite-domain ghost (frame/channel.py ``ghost_*``), the
    reflection delays the CARRIER too: at fc ~ 8 MHz one RF sample is
    ~55 degrees of carrier, so the ghost's apparent polarity swings with
    the path length at fractional-wavelength scale — why real ghosts
    range from white through ringing to black as the reflector moves
    inches.  ``gain`` may be negative (an inverting bounce).  Through the
    LTI synchronous-detection chain this maps to a linear composite-rate
    channel, so the GCR equalizer (frame/equalize.py) cancels it — the
    test proves that composition; through ENVELOPE detection it does not
    (|.| is nonlinear), the authentic reason equalization belongs after
    coherent detection.  The delay rides the contiguous stream
    (crosses row boundaries); only the block's first samples lack a
    predecessor, as in channel._stream_delay."""
    b, l, n_rf = rf.shape
    d = max(1, int(round(delay_us * 1e-6 * rfp.fs_rf)))
    stream = rf.reshape(b, l * n_rf)
    g = jnp.concatenate(
        [jnp.zeros((b, d), stream.dtype), stream[:, :-d]], axis=-1
    )
    return (stream + gain * g).reshape(b, l, n_rf)


def rf_dropout(rfp: RFPlan, rf, key, rate: float = 0.05,
               len_us: float = 10.0):
    """Tape dropout simulation AT RF: with probability ``rate`` per line,
    the carrier vanishes (oxide flake / head clog) over a ``len_us``-long
    span starting at a random position.  Carrier LOSS is an RF-layer
    phenomenon — a composite-level model could not be detected honestly,
    which is why the dropout compensator lives in the RF receiver
    (``rf_demodulate(..., doc=True)``)."""
    import jax

    b, l, n_rf = rf.shape
    k1, k2 = jax.random.split(jax.random.PRNGKey(key) if isinstance(key, int)
                              else key)
    span = jnp.int32(round(len_us * 1e-6 * rfp.fs_rf))
    hit = jax.random.bernoulli(k1, rate, (b, l))
    start = jax.random.randint(k2, (b, l), 0, max(n_rf - span, 1))
    idx = jnp.arange(n_rf, dtype=jnp.int32)[None, None, :]
    mask = (
        hit[:, :, None]
        & (idx >= start[:, :, None])
        & (idx < start[:, :, None] + span)
    )
    return jnp.where(mask, 0.0, rf)


def recover_carrier_phase(rfp: RFPlan, rf, frame0=0, freq_error: float = 0.0):
    """Estimate the received picture-carrier phase offset, radians (B,).

    Quasi-synchronous receivers recover the carrier from the signal
    itself: the negative-AM envelope never drops below ~12.5 %, so the
    carrier line dominates the spectrum at fc.  Correlating the stream
    against the nominal I/Q mixers and averaging leaves exactly that
    line: theta = atan2(<x*(-sin)>, <x*cos>).  Feed the result to
    :func:`rf_demodulate` as ``phase_error`` (it mixes with ramp +
    phase_error, so passing the estimate cancels the channel's offset).
    One pass, two reductions — no filtering needed because the mean IS
    the DC bin.

    ``freq_error``: correlate against ``fc + freq_error`` instead — the
    second AFT step: after :func:`recover_carrier_frequency` pins the
    frequency, this pins the remaining static phase at the same mixer
    setting :func:`rf_demodulate` will use.
    """
    b, l, n_rf = rf.shape
    sign = _row_sign(rfp, frame0, b, l)[:, :, None]
    if freq_error != 0.0:
        dphi = _df_phase(rfp, freq_error, frame0, b, l)
        c = jnp.cos(jnp.asarray(rfp.ramp, jnp.float32)[None, None, :] + dphi)
        s = jnp.sin(jnp.asarray(rfp.ramp, jnp.float32)[None, None, :] + dphi)
    else:
        c = jnp.asarray(np.cos(rfp.ramp), jnp.float32)[None, None, :]
        s = jnp.asarray(np.sin(rfp.ramp), jnp.float32)[None, None, :]
    xi = jnp.mean(rf * c * sign, axis=(1, 2))
    xq = jnp.mean(rf * (-s) * sign, axis=(1, 2))
    return jnp.arctan2(xq, xi)


def recover_carrier_frequency(rfp: RFPlan, rf, frame0=0,
                              search: float = 100e3):
    """Estimate the received picture-carrier frequency offset, Hz (B,).

    The AFT (automatic fine tuning) discriminator of a real TV tuner,
    done in two stages over the contiguous stream:

    1. **Coarse** — peak |rfft| bin within ``fc ± search`` (pow2 FFT).
       The carrier line towers over the
       modulation sidebands per bin (the negative-AM envelope never
       drops below ~12.5 %, and a ~1.4 M-sample frame gives ~hundreds
       of kHz of sidebands spread over ~50k bins), so the argmax IS the
       carrier.  Resolution = fs_rf / nfft (~10–30 Hz here).
    2. **Fine** — derotate by the coarse estimate (block-relative time:
       frequency is a phase SLOPE, so the time origin only shifts the
       constant phase), correlate per row against the nominal carrier,
       and read the per-row phase step: df_fine = dtheta * fs / (2 pi n).
       Unambiguous for residuals below half the line rate — thousands of
       times the coarse bin width.

    Returns ``df_hat`` to pass to :func:`rf_demodulate` /
    :func:`recover_carrier_phase` as ``freq_error`` (as a host scalar —
    the correction path needs a static value for its split-precision
    phase law).  Accuracy on a clean frame is ~1 Hz, limited by the fine
    correlation's f32 floor, i.e. ~0.03 cycles of drift over a frame.
    """
    b, l, n_rf = rf.shape
    stream = rf.reshape(b, l * n_rf)
    t = stream.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(t)))
    spec = jnp.abs(jnp.fft.rfft(stream, n=nfft, axis=-1))
    dbin = rfp.fs_rf / nfft
    k0 = max(int(np.floor((rfp.fc - search) / dbin)), 1)
    k1 = min(int(np.ceil((rfp.fc + search) / dbin)) + 1, nfft // 2)
    k = k0 + jnp.argmax(spec[:, k0:k1], axis=-1)          # (B,)
    df_c = k.astype(jnp.float32) * np.float32(dbin) - np.float32(rfp.fc)
    # fine: block-relative sample times, split j = row*n_rf + i so the
    # f32 products stay small (alpha*row <= search/fh rows ~ 5e3 cycles;
    # ulp there ~5e-4 cycles — well under the +-0.5-cycle/row ambiguity)
    alpha = df_c[:, None, None] * np.float32(n_rf / rfp.fs_rf)  # cyc/row
    rows = jnp.arange(l, dtype=jnp.float32)[None, :, None]
    i_in = jnp.arange(n_rf, dtype=jnp.float32)[None, None, :]
    derot = TWO_PI * ((alpha * rows) % 1.0
                      + (df_c[:, None, None] / np.float32(rfp.fs_rf)) * i_in)
    sign = _row_sign(rfp, frame0, b, l)[:, :, None]
    base_c = jnp.asarray(np.cos(rfp.ramp), jnp.float32)[None, None, :]
    base_s = jnp.asarray(np.sin(rfp.ramp), jnp.float32)[None, None, :]
    # e^{-i(ramp + derot)} against the signal, summed per row
    cc, ss = jnp.cos(derot), jnp.sin(derot)
    zr = jnp.sum(rf * sign * (base_c * cc - base_s * ss), axis=-1)
    zi = jnp.sum(rf * sign * (-base_s * cc - base_c * ss), axis=-1)
    # mean per-row rotation: angle of sum_k z[k+1] * conj(z[k])
    dre = jnp.sum(zr[:, 1:] * zr[:, :-1] + zi[:, 1:] * zi[:, :-1], axis=-1)
    dim = jnp.sum(zi[:, 1:] * zr[:, :-1] - zr[:, 1:] * zi[:, :-1], axis=-1)
    dtheta = jnp.arctan2(dim, dre)
    fh = rfp.plan.fs / rfp.row_samples
    return df_c + dtheta * np.float32(fh / TWO_PI)


def rf_retune(rfp: RFPlan, rf, df: float, frame0=0):
    """Digital AFC retune: frequency-shift the received RF by ``-df`` so
    its spectrum re-centers on the receiver's filters (B, L, N*r -> same).

    :func:`rf_demodulate`'s ``freq_error`` corrects the MIXERS, but the
    shifted signal still rides the Nyquist flank off its 0.5 point — a
    first-order residual (measured: 50.6 dB recovered composite at 2 kHz
    offset falling 6 dB per octave to 24.6 dB at 40 kHz).  A real AFT
    closes the loop by retuning the tuner LO; this is that step done
    digitally: one-sided (analytic) spectrum via a pow2 FFT over the
    contiguous stream, heterodyne by ``e^{-i 2 pi df t}`` on the
    absolute-row time law (chunk-continuous), real part.  After it, the
    stream IS a correctly tuned signal: demodulate with ``freq_error=0``
    (recover the leftover static phase as usual).

    Edge honesty: the zero-padded FFT's Hilbert tails decay like 1/t —
    below -80 dB two rows in from either stream end at this geometry.
    """
    b, l, n_rf = rf.shape
    stream = rf.reshape(b, l * n_rf)
    t = stream.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(t)))
    spec = jnp.fft.fft(stream, n=nfft, axis=-1)
    w = np.zeros(nfft, np.float32)
    w[0] = 1.0
    w[nfft // 2] = 1.0
    w[1:nfft // 2] = 2.0
    za = jnp.fft.ifft(spec * jnp.asarray(w)[None, :], axis=-1)[:, :t]
    ph = _df_phase(rfp, -df, frame0, b, l).reshape(b, l * n_rf)
    shifted = za * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    return jnp.real(shifted).reshape(b, l, n_rf)


def _snd_rotate(rfp: RFPlan, zc, frame0, freq_error: float):
    """(i, q) from the composed sound-takeoff output: the quadrature mix's
    carrier rotation e^{-j theta} applied at the COMPOSITE rate —
    i + jq = zc * e^{-j(snd ramp + (-1)^row law + df phase)} (the factor 2
    already lives in RFPlan.snd_dem_taps)."""
    b, l, n = zc.shape
    sign = _row_sign(rfp, frame0, b, l)[:, :, None]
    if freq_error != 0.0:
        ph = (jnp.asarray(rfp.snd_ramp_comp, jnp.float32)[None, None, :]
              + _df_phase(rfp, freq_error, frame0, b, l, comp_rate=True))
        c, s = jnp.cos(ph) * sign, jnp.sin(ph) * sign
    else:
        c = jnp.asarray(np.cos(rfp.snd_ramp_comp),
                        jnp.float32)[None, None, :] * sign
        s = jnp.asarray(np.sin(rfp.snd_ramp_comp),
                        jnp.float32)[None, None, :] * sign
    zr, zi = jnp.real(zc), jnp.imag(zc)
    return zr * c + zi * s, zi * c - zr * s


def rf_demodulate_sound(rfp: RFPlan, rf, frame0=0, freq_error: float = 0.0):
    """Intercarrier FM sound takeoff: RF (B, L, N*r) -> audio (B, L*N).

    ``freq_error``: track a mistuned transmitter (Hz, from
    :func:`recover_carrier_frequency`).  Untracked, a transmitter offset
    ``df`` shows up as a constant audio DC shift of ``df / snd_dev`` (the
    discriminator reads the carrier off-center) — the defect a true
    intercarrier receiver avoids by beating sound against the picture
    carrier, which this parameter emulates.

    Sound-channel bandpass, quadrature mix against the closed-form sound
    carrier and I/Q lowpass run as ONE composed complex filter decimated
    to the composite rate in the frequency domain (RFPlan.snd_dem_taps +
    dsp/stream.py; the carrier rotation applies after, at the decimated
    rate).  Then the EXACT phase-difference discriminator: dphi =
    atan2(Im, Re) of z[t]*conj(z[t-1]) — per-sample phase step, no unwrap
    (|dphi| < pi), and unlike a FIR differentiator it has no design error
    at the tiny omega/fs of an audio-bandwidth signal (a 31-tap
    frequency-sampled d/dn measured ~30 dB audio SNR; this form is
    exact).  Decimating first makes the step r times larger — precision
    and compute both improve.
    """
    b, l, n_rf = rf.shape
    n = rfp.row_samples
    zc = conv_decim_stream(
        rf.reshape(b, l * n_rf), rfp.snd_dem_taps(freq_error), rfp.r
    ).reshape(b, l, n)
    i, q = _snd_rotate(rfp, zc, frame0, freq_error)
    i, q = i.reshape(b, l * n), q.reshape(b, l * n)
    ip = jnp.concatenate([i[:, :1], i[:, :-1]], axis=-1)
    qp = jnp.concatenate([q[:, :1], q[:, :-1]], axis=-1)
    dphi = jnp.arctan2(ip * q - i * qp, i * ip + q * qp)
    audio = dphi * (rfp.plan.fs / (2.0 * np.pi * rfp.snd_dev))
    # overlap-save, not one giant padded transform: the 8193-tap audio
    # LPF over a megasample stream pays ~1.5x pow2 padding as a single
    # fir_same_fft; fir_stream blocks it at ~1.14x (exact same linear
    # convolution, float-reassociated)
    return fir_stream(audio, rfp.aud_lpf)


def sound_on_rf(rfp: RFPlan, rf, frame0, audio, phi0=0.0):
    """Add the FM sound carrier treating the BATCH as one contiguous
    broadcast (the chunked-video transmitter).

    ``rf_modulate(audio=...)`` integrates the deviation per batch item —
    right for independent stills, but a video chunk's frames are
    consecutive broadcast time: per-item integration would restart the
    carrier phase (and the stream filters' warm-up) at every frame
    boundary, a frame-rate buzz.  Here the ZOH, the deviation cumsum and
    the carrier synthesis all run over the joined (B*L*N*r) stream;
    ``phi0`` (radians) is the deviation phase accumulated BEFORE this
    chunk — the host computes it from the full audio track's f64 prefix
    sum, so any chunking reconstructs the same continuous phase law
    (frame/video.py).  The carrier ramp itself needs no state: it is the
    closed-form half-integer-cycles row law, keyed on the absolute row
    via ``frame0``.

    ``audio``: (B, L*N) in [-1, 1] at the composite rate, consecutive
    frames of one stream.
    """
    b, l, n_rf = rf.shape
    # Deliberately the PLAIN RF-rate integral.  A ZOH-telescoped variant
    # (composite-rate cumsum + (T_c, r) broadcast expansion) measured
    # 3.4 ms FASTER standalone but cost the fused rf-sound matrix row
    # ~15 Mpix/s (round-5 whole-row interleaved bisect, 101.6 -> 86.4):
    # the repeat+cumsum chain fuses into the row's giant elementwise
    # graph where the expansion's materialized intermediate does not.
    # In-context fusion decides, not the standalone stage time.
    a_rf = jnp.repeat(
        jnp.asarray(audio, jnp.float32).reshape(1, b * l * rfp.row_samples),
        rfp.r, axis=-1,
    )
    dphi = (TWO_PI * rfp.snd_dev / rfp.fs_rf) * a_rf
    phi_dev = jnp.cumsum(dphi, axis=-1) + jnp.asarray(phi0, jnp.float32)
    ramp = jnp.asarray(rfp.snd_ramp, jnp.float32)
    phi = jnp.broadcast_to(ramp, (b, l, n_rf)).reshape(1, b * l * n_rf)
    phi = phi + phi_dev
    sign = _row_sign(rfp, frame0, b, l)[:, :, None]
    snd = jnp.cos(phi).reshape(b, l, n_rf) * sign
    return rf + rfp.snd_amp * snd


def _sound_disc(rfp: RFPlan, rf, frame0):
    """Joined-chunk FM sound discriminator: RF (B, L, N*r) -> the
    instantaneous audio (1, B*L*N) BEFORE the audio low-pass.

    Shared core of :func:`sound_from_rf` / :func:`sound_from_rf_halo`:
    composed sound-takeoff conv decimated to the composite rate, carrier
    derotation, exact phase-difference discriminator over the joined
    stream."""
    b, l, n_rf = rf.shape
    n = rfp.row_samples
    zc = conv_decim_stream(
        rf.reshape(1, b * l * n_rf), rfp.snd_dem_taps(), rfp.r
    ).reshape(b, l, n)
    i, q = _snd_rotate(rfp, zc, frame0, 0.0)
    i, q = i.reshape(1, b * l * n), q.reshape(1, b * l * n)
    ip = jnp.concatenate([i[:, :1], i[:, :-1]], axis=-1)
    qp = jnp.concatenate([q[:, :1], q[:, :-1]], axis=-1)
    dphi = jnp.arctan2(ip * q - i * qp, i * ip + q * qp)
    return dphi * (rfp.plan.fs / (2.0 * np.pi * rfp.snd_dev))


def sound_from_rf(rfp: RFPlan, rf, frame0=0):
    """Contiguous-batch sound takeoff: RF (B, L, N*r) -> audio (B, L*N).

    The receive mirror of :func:`sound_on_rf`: every stream filter (sound
    band-pass, I/Q low-pass, audio low-pass) runs over the joined chunk
    stream, so frame boundaries inside a chunk see their true neighbors
    and only the chunk edges carry filter warm-up — which the video
    runner hides under its one-frame overlap fetch.
    """
    b, l, n_rf = rf.shape
    audio = _sound_disc(rfp, rf, frame0)
    # overlap-save (see rf_demodulate_sound's note on the same stage)
    return fir_stream(audio, rfp.aud_lpf).reshape(b, l * rfp.row_samples)


def sound_from_rf_halo(rfp: RFPlan, rf, frame0=0, halo: int = 1,
                       head_dead=None, tail_dead=None):
    """Sound takeoff on a frame-halo-extended chunk (B+2*halo, L, N*r) ->
    audio (B, L*N) for the OWN frames only — the sharded hop's receive side
    (parallel/sharded.py::make_sharded_rf_sound_pipeline).

    The first/last ``halo`` frames are neighbor context: the stream
    filters see them (so own-frame audio within filter reach of a device
    boundary is computed from its TRUE broadcast-time neighborhood), and
    the returned audio crops them.

    ``head_dead`` / ``tail_dead`` (traced bools): the GLOBAL first/last
    device's halo frames carry no signal (zeros — there is no broadcast
    before the batch), and a dead carrier's discriminated phase is
    meaningless noise near the halo/own boundary (the takeoff conv's
    non-causal taps leak own signal into the halo, whose angle is O(1)
    garbage at tiny magnitude).  Zeroing the discriminator output over
    the dead halo before the audio low-pass reproduces EXACTLY what the
    unsharded chunk's 'same'-conv zero padding supplies past the
    stream ends — bit-honest global edges, seamless interior ones.
    """
    b_ext, l, n_rf = rf.shape
    n = rfp.row_samples
    b = b_ext - 2 * halo
    audio = _sound_disc(rfp, rf, frame0)                  # (1, b_ext*l*n)
    if head_dead is not None or tail_dead is not None:
        pos = jnp.arange(b_ext * l * n, dtype=jnp.int32)[None, :]
        keep = jnp.ones_like(audio, dtype=bool)
        if head_dead is not None:
            # "< halo*l*n + 1": the unsharded chunk's discriminator
            # edge-holds its first sample (prev == current -> dphi = 0
            # exactly); the halo path's first own sample instead reads the
            # dead halo's leakage tail as predecessor — mask it to the
            # same exact zero (measured: the one sample was the whole
            # 1.3e-4 equivalence residual at the global stream start)
            keep &= ~(head_dead & (pos < halo * l * n + 1))
        if tail_dead is not None:
            keep &= ~(tail_dead & (pos >= (halo + b) * l * n))
        audio = jnp.where(keep, audio, 0.0)
    out = fir_stream(audio, rfp.aud_lpf).reshape(b_ext, l * n)
    return out[halo : halo + b]


def rf_roundtrip(rfp: RFPlan, comp, frame0=0, audio=None):
    """modulate -> demodulate (the RF-transparency test surface).

    Returns the recovered composite, or ``(composite, audio)`` when an
    audio stream is transmitted."""
    rf = rf_modulate(rfp, comp, frame0, audio)
    out = rf_demodulate(rfp, rf, frame0)
    if audio is None:
        return out
    return out, rf_demodulate_sound(rfp, rf, frame0)


# --- public-entry jit (one compiled program per call; utils/jitwrap) ---
# Every entry point with complex intermediates from dsp/stream.py (or a
# c2c FFT) is self-jitting off-CPU; rf_roundtrip/rf_ghost/rf_dropout/
# recover_carrier_phase/sound_on_rf are real-elementwise or pure callers
# of wrapped functions and stay plain.
from color_modem_tpu.utils.jitwrap import plan_jit as _plan_jit

rf_modulate = _plan_jit(rf_modulate, static=("df",))
rf_demodulate = _plan_jit(
    rf_demodulate,
    static=("detection", "phase_error", "doc", "agc", "freq_error"),
)
rf_demodulate_sound = _plan_jit(rf_demodulate_sound, static=("freq_error",))
sound_from_rf = _plan_jit(sound_from_rf)
sound_from_rf_halo = _plan_jit(sound_from_rf_halo, static=("halo",))
rf_cochannel = _plan_jit(rf_cochannel, static=("offset_num", "offset_den"))
rf_retune = _plan_jit(rf_retune, static=("df",))
recover_carrier_frequency = _plan_jit(
    recover_carrier_frequency, static=("search",)
)
