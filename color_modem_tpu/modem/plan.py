"""ModemPlan — everything derived from (StandardConfig, line width) at build time.

The reference re-designs SciPy filters inside its modem constructors
(SURVEY.md C8 [MEM-M]).  Here all filter taps, phase ramps, and scalar
constants are derived **once** on the host into a plain NumPy bundle that the
JAX pipeline closes over as compile-time constants.

The frozen golden oracle (:mod:`color_modem_tpu.golden`) consumes the same
plan: taps are *data* derived from spec constants, so sharing them keeps the
golden comparison about the pipeline math (phase laws, vectorization,
stencils, sharding) rather than about two filter designs — the deliberate
tradeoff recorded in SURVEY.md §7.3 item 2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from color_modem_tpu.dsp import design
from color_modem_tpu.dsp.nco import sample_phase_ramp
from color_modem_tpu.standards.base import FmParams, QamParams, StandardConfig

#: SECAM quadrature-mix LPF cutoff.  Must pass enough FM baseband for the
#: discriminator to track the instantaneous frequency (excursion ~0.5 MHz
#: + significant sidebands) while rejecting mixing products and noise.
#: Swept empirically: 1.4 MHz is the round-trip optimum on both smooth
#: scenes (+1.2 dB over the previous 2.0 MHz) and saturated color bars
#: (+0.6 dB); below ~1.2 MHz sideband truncation starts distorting
#: saturated transitions.
SECAM_MIX_LPF = 1.4e6
#: SECAM decode-side blanking reconstruction margin, samples (A.4: the real
#: signal carries the undeviated rest carrier through blanking; the
#: active-only composite's hard edges put a luma-step + carrier-cut
#: transient through the long decode filters that cost ~2.5 dB round-trip).
#: The decoder extends each line by M samples per side — held luma pedestal
#: (estimated from the edge samples) plus, on the left, the rest carrier
#: whose phase is known by modem convention (the per-line FM integral
#: starts at phase 2*pi*f0*0.5/fs at sample 0).  Swept 16-256: plateau
#: from ~32, 48 is robust across fixtures.
SECAM_MARGIN = 48
#: samples averaged for the blanking luma pedestal estimate (~8.5 carrier
#: cycles: the carrier averages out of the mean)
SECAM_LUMA_EST = 27
#: Half-width of the SECAM chroma takeoff / luma-notch band around bell_f0.
SECAM_TAKEOFF_HALFWIDTH = 2.0e6
SECAM_BAND_TRANSITION = 0.4e6


@dataclasses.dataclass(frozen=True, eq=False)
class ModemPlan:
    """Host-side constant bundle for one (standard, line-width) pair.

    All arrays are NumPy float64 taps / float32 ramps; the JAX pipeline casts
    on capture.  ``eq=False`` keeps the object hashable by identity so it can
    be a ``jax.jit`` static argument.
    """

    cfg: StandardConfig
    n_samples: int
    fs: float
    rgb_to_ycc: np.ndarray
    ycc_to_rgb: np.ndarray

    # --- QAM family (NTSC / PAL / NIIR); None for FM standards ------------
    ramp: Optional[np.ndarray] = None          # (N,) within-line phase, rad
    theta: float = 0.0                         # carrier phase offset, rad
    c1_lpf: Optional[np.ndarray] = None
    c2_lpf: Optional[np.ndarray] = None
    chroma_bpf: Optional[np.ndarray] = None
    comb_sel_lpf: Optional[np.ndarray] = None  # adaptive-comb energy smoother

    # --- SECAM FM family; None for QAM standards ---------------------------
    comp_lpf: Optional[np.ndarray] = None      # baseband D'R/D'B LPF
    preemph: Optional[np.ndarray] = None       # A(f) FIR
    deemph: Optional[np.ndarray] = None        # 1/A(f) FIR
    anticloche: Optional[np.ndarray] = None    # G(f) FIR, carrier-band masked
    bell_takeoff: Optional[np.ndarray] = None  # cloche * band mask FIR
    luma_notch: Optional[np.ndarray] = None    # chroma-band BPF for Y = c - BPF(c)
    mix_lpf: Optional[np.ndarray] = None       # post-quadrature-mix LPF
    diff: Optional[np.ndarray] = None          # FIR differentiator
    demod_lpf: Optional[np.ndarray] = None     # final component LPF
    f_center: float = 0.0                      # quadrature mix frequency
    # decode-side blanking reconstruction (SECAM_MARGIN comment):
    fm_margin: int = 0                         # M, samples per side
    fm_luma_est: int = 0                       # K, pedestal-estimate samples
    fm_margin_carrier: Optional[np.ndarray] = None  # (2, M): [B, R] parity
    mix_ramp_ext: Optional[np.ndarray] = None  # (N + 2M,) mix ramp from -M
    # carrier phase base 2*pi*frac(fc*(n+0.5)/fs): the MIDPOINT-rule FM
    # integral phi[n] = 2*pi/fs*(sum_{k<=n} f[k] - f[n]/2) splits as
    # base[n] + 2*pi/fs*(cumsum(f_inst - fc) - (f_inst[n] - fc)/2), so the
    # on-device float32 cumsum only ever sees the small deviation term
    # (|sum| < ~250 rad) instead of the 3e9-magnitude raw integral.
    # Midpoint (not inclusive-rectangle) because the decoder's SYMMETRIC
    # derivative then reads the instantaneous frequency at exactly sample n:
    # the rectangle rule put f[n] a half-sample early, measured as a +13.3
    # deg/MHz linear phase error on the demodulated components (-5 dB on
    # 1 MHz chroma detail).
    fm_carrier_ramp: Optional[np.ndarray] = None


#: the sample rate the default tap counts were tuned at (every standard's
#: 720-sample active line) — tap counts scale as fs/REF_FS so each filter
#: keeps its TIME span (transition width in Hz, tail coverage in us)
#: across line widths.  At 720 the factor is exactly 1: plans there are
#: bit-identical to the pre-scaling ones.  Without this the 1440-sample
#: "quality" configuration was WORSE than 720 (same taps at 2x fs = half
#: the covered time span: the 1.9 us de-emphasis tail and the relatively
#: 2x-sharper transitions all degrade; measured SECAM notch 31.8 dB at
#: 1440 vs 35.1 at 720 before scaling).
REF_FS = 13.5e6


def _odd(x: float) -> int:
    v = max(3, int(round(x)))
    return v if v % 2 == 1 else v + 1


def make_plan(
    cfg: StandardConfig,
    n_samples: int,
    *,
    ntaps: int = 129,
    bell_ntaps: int = 193,
    diff_ntaps: int = 31,
    emph_ntaps: int = 257,
) -> ModemPlan:
    fs = cfg.sample_rate(n_samples)
    k = fs / REF_FS  # tap-count scale (REF_FS comment)
    ntaps = _odd(ntaps * k)
    bell_ntaps = _odd(bell_ntaps * k)
    diff_ntaps = _odd(diff_ntaps * k)
    emph_ntaps = _odd(emph_ntaps * k)
    margin = int(round(SECAM_MARGIN * k))
    luma_est = max(3, int(round(SECAM_LUMA_EST * k)))
    common = dict(
        cfg=cfg,
        n_samples=n_samples,
        fs=fs,
        rgb_to_ycc=cfg.rgb_to_ycc_np(),
        ycc_to_rgb=cfg.ycc_to_rgb_np(),
    )
    ch = cfg.chroma
    if isinstance(ch, QamParams):
        if fs < 2.5 * ch.fsc:
            raise ValueError(
                f"{cfg.name}: fs={fs/1e6:.2f} MHz < 2.5*fsc; use a wider line"
            )
        return ModemPlan(
            ramp=sample_phase_ramp(ch.fsc, fs, n_samples),
            theta=float(np.deg2rad(ch.phase_offset_deg)),
            c1_lpf=design.lowpass_taps(fs, ch.c1_bandwidth, ntaps),
            c2_lpf=design.lowpass_taps(fs, ch.c2_bandwidth, ntaps),
            chroma_bpf=design.bandpass_taps(
                fs, ch.fsc - ch.chroma_band, ch.fsc + ch.chroma_band, ntaps
            ),
            # adaptive comb (separate.comb 'combA'): the up/down difference
            # energies are smoothed to ~0.5 MHz before blending, so the
            # soft switch follows picture structure, not carrier ripple
            comb_sel_lpf=design.lowpass_taps(fs, 0.5e6, 63),
            **common,
        )
    assert isinstance(ch, FmParams)
    f_center = 0.5 * (ch.f0r + ch.f0b)
    band_lo = ch.bell_f0 - SECAM_TAKEOFF_HALFWIDTH
    band_hi = ch.bell_f0 + SECAM_TAKEOFF_HALFWIDTH
    if fs < 2.0 * (band_hi + SECAM_BAND_TRANSITION):
        raise ValueError(
            f"secam: fs={fs/1e6:.2f} MHz too low for the chroma band; "
            "use a wider line (e.g. 720+ samples)"
        )

    def band_mask(f):
        return design.raised_cosine_bandpass_response(
            f, band_lo, band_hi, SECAM_BAND_TRANSITION
        )

    def anticloche_resp(f):
        return (
            design.secam_anticloche_response(
                f, ch.bell_f0, ch.bell_m0, ch.bell_k_num, ch.bell_k_den
            )
            * band_mask(f)
        )

    def takeoff_resp(f):
        return (
            design.secam_cloche_response(
                f, ch.bell_f0, ch.bell_m0, ch.bell_k_num, ch.bell_k_den
            )
            * band_mask(f)
        )

    return ModemPlan(
        comp_lpf=design.lowpass_taps(fs, ch.component_bandwidth, ntaps),
        # the de-emphasis pole at f1=85 kHz has a ~1.9 us exponential tail
        # (~75 samples at 13.5 MHz) — these two need the longer window
        preemph=design.freq_sampled_taps(
            fs, lambda f: design.secam_preemph_response(f, ch.preemph_f1), emph_ntaps
        ),
        deemph=design.freq_sampled_taps(
            fs, lambda f: design.secam_deemph_response(f, ch.preemph_f1), emph_ntaps
        ),
        anticloche=design.freq_sampled_taps(fs, anticloche_resp, bell_ntaps),
        bell_takeoff=design.freq_sampled_taps(fs, takeoff_resp, bell_ntaps),
        luma_notch=design.freq_sampled_taps(fs, band_mask, bell_ntaps),
        mix_lpf=design.lowpass_taps(fs, SECAM_MIX_LPF, ntaps),
        diff=design.differentiator_taps(fs, diff_ntaps),
        demod_lpf=design.lowpass_taps(fs, ch.demod_lpf, ntaps),
        f_center=f_center,
        fm_margin=margin,
        fm_luma_est=luma_est,
        # left blanking carrier per line parity (B even / R odd gline):
        # amplitude = the anti-cloche floor M0 (its gain at the rest
        # frequency, F(f0)=0), phase per the sample-0 convention
        fm_margin_carrier=np.stack([
            ch.bell_m0 * np.cos(
                2.0 * np.pi * f0 / fs
                * (np.arange(-margin, 0, dtype=np.float64) + 0.5)
            )
            for f0 in (ch.f0b, ch.f0r)
        ]),
        mix_ramp_ext=2.0 * np.pi * np.mod(
            f_center / fs
            * np.arange(-margin, n_samples + margin,
                        dtype=np.float64),
            1.0,
        ),
        # 2*pi*frac(fc*(n+0.5)/fs) — see the field comment (midpoint rule)
        fm_carrier_ramp=2.0
        * np.pi
        * np.mod(f_center / fs * (np.arange(n_samples) + 0.5), 1.0),
        **common,
    )
