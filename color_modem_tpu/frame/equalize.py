"""Ghost-cancellation equalizer from a transmitted reference line.

Real broadcasters fight multipath with a Ghost Cancellation Reference
(ITU-R BT.1124): a known broadband chirp in the vertical interval; the
receiver compares what arrived against what was sent, estimates the channel,
and applies an inverse FIR.  This module is that receiver path for the
:func:`frame.channel.impair` channel (ghost, chroma gain/phase — any linear
distortion), the natural companion of ``raster``'s burst-locked decoding.

Beyond the reference's scope (it has no channel model at all); estimation
is frequency-domain ridge regression on the DFT grid, computed ON DEVICE so
a video pipeline can re-estimate per chunk without host round trips, and
the equalizer applies via FFT convolution (traced taps).

    gcr  = gcr_record(plan)                     # what was transmitted (3, N)
    taps = design_equalizer(plan, rx_gcr)       # rx_gcr: same, received
    out  = decode(apply_equalizer(comp, taps))

Two estimation modes by record shape: a single ``(N,)`` line is estimated
with zero-padded (linear) FFTs — fine for short ghosts, but the line's
first ``d`` samples lack a predecessor, biasing the estimate once the
delay is a noticeable fraction of the line.  A ``(k>=2, N)`` record of
IDENTICAL lines (``gcr_record``) is the cyclic-prefix trick: the first
line settles the channel, so the remaining period is an exact circular
convolution and the estimate is unbiased for delays up to a full line
(BT.1124 ghosts reach +45 us ~ 600 samples at 13.5 MHz).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.modem.plan import ModemPlan


def gcr_line(plan: ModemPlan, samples: int | None = None) -> np.ndarray:
    """BT.1124-style reference line: a raised-cosine-windowed linear chirp
    sweeping ~0.05-0.45 fs, on a mid-gray pedestal, swing within [0, 1].

    Host NumPy on purpose: the transmitted reference is config-time data
    (like FIR taps), identical on every device.
    """
    n = samples if samples is not None else plan.n_samples
    t = np.arange(n, dtype=np.float64)
    # sweep nearly DC..Nyquist: every bin the channel can distort needs
    # reference energy, or the estimator's identity prior leaves a residual
    f0, f1 = 0.005, 0.495  # cycles/sample at the ends of the sweep
    phase = 2.0 * np.pi * (f0 * t + (f1 - f0) * t * t / (2.0 * (n - 1)))
    w = np.ones(n)
    edge = max(8, n // 32)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)
    w[:edge], w[-edge:] = ramp, ramp[::-1]
    return (0.5 + 0.45 * w * np.sin(phase)).astype(np.float32)


def gcr_record(plan: ModemPlan, lines: int = 3,
               samples: int | None = None) -> np.ndarray:
    """(lines, N) cyclic-prefix GCR record: one prefix line + a chirp
    spanning the remaining ``(lines-1)·N``-sample analysis period.

    The prefix equals the period's LAST line, so after it the channel is
    settled (for delays up to one line) and the received period is an exact
    CIRCULAR convolution — :func:`design_equalizer` estimates it without
    edge bias.  The chirp must span the whole period in one sweep: a
    period built from repeated identical lines only has energy in every
    k-th bin, and the estimator's identity prior would fill the silent
    bins, halving the estimated echoes (measured).

    ``samples``: row width override (default ``plan.n_samples``) — e.g.
    ``raster.n_total`` when the record must ride rastered-width rows
    through the RF layer.  :func:`design_equalizer` rebuilds the
    reference from the received row width, so the two stay consistent
    automatically.
    """
    if lines < 2:
        raise ValueError("a cyclic record needs a prefix + >= 1 line")
    n = plan.n_samples if samples is None else int(samples)
    x = gcr_line(plan, (lines - 1) * n)
    return np.concatenate([x[-n:], x]).reshape(lines, n)


def gcr_record_guarded(plan: ModemPlan, lines: int = 3,
                       samples: int | None = None) -> np.ndarray:
    """(lines+1, N) cyclic GCR record with a POSTFIX guard line (the
    period's first line repeated).

    :func:`gcr_record`'s prefix settles the channel going IN to the
    analysis period, which suffices for causal channels (echoes).  A
    channel with lookahead — any acausal FIR, notably the RF hop's
    centered receiver filters (frame/rf.py: ~0.2 lines of half-span at
    the default geometry) — also contaminates the period's END with the
    record's edge transient.  The guard restores cyclic consistency on
    the forward side: transmit THIS, then hand :func:`design_equalizer`
    the received ``[:lines]`` (it drops the prefix itself; the guard
    line is simply never looked at)."""
    rec = gcr_record(plan, lines, samples)
    return np.concatenate([rec, rec[1:2]])


def ntaps_for_delay(plan: ModemPlan, ghost_delay_us: float,
                    echoes: int = 3, base: int = 129) -> int:
    """Equalizer length whose half-span reaches ``echoes`` correction taps
    of a ghost at ``ghost_delay_us`` (the inverse of ``1 + g z^-d`` has
    geometrically decaying echoes at d, 2d, 3d, ...), with margin so the
    edge taper's flat region (60% of the half-span at the tukey alpha
    used) still covers the last one.  The default 129 taps
    reach only ~64 samples (~4.6 us at 13.5 MHz); longer ghosts need this.
    The half-span is capped just under one line: that is the cyclic
    record's alias-free reach (and far beyond BT.1124's +45 us).
    """
    d = int(np.ceil(ghost_delay_us * 1e-6 * plan.fs))
    half = max((base - 1) // 2, int(np.ceil(echoes * max(d, 1) / 0.6)))
    half = min(half, plan.n_samples - 1)
    return 2 * half + 1


def design_equalizer(
    plan: ModemPlan,
    received: jax.Array,
    ntaps: int = 129,
    reg: float = 1e-3,
    pivot: float = 0.0,
) -> jax.Array:
    """Received GCR -> (ntaps,) inverse-channel FIR (on device).

    ``received``: ``(N,)`` single line (zero-padded linear estimate — edge
    transient biases it once the delay is a noticeable fraction of the
    line) or ``(k>=2, N)`` from :func:`gcr_record` (cyclic estimate over
    the settled last two lines — unbiased for delays up to one line).

    The correction's reach is ``(ntaps-1)//2`` samples of delay: echoes
    beyond the half-span are silently uncorrectable — size with
    :func:`ntaps_for_delay` when the expected ghost delay is known.

    Frequency-domain ridge regression with an identity prior: the raw
    estimate ``H_hat = R S* / (|S|^2 + reg·ps)`` is reliable only where the
    reference carries energy, so it is blended toward the identity channel
    by the per-bin confidence ``W = |S|^2 / (|S|^2 + reg·ps)`` —
    ``H = W·H_hat/W + (1-W)·1`` — before the zero-forcing inverse
    ``E = H* / (|H|^2 + reg)``.  Without the prior, bins outside the chirp
    sweep (notably luma low frequencies) estimate to zero and the
    "equalizer" turns into a bandpass that destroys the picture.  The
    impulse response is windowed to ``ntaps`` around zero delay (circular
    wrap carries any anticausal part); ``reg`` trades ghost suppression
    against noise enhancement exactly like a hardware GCR canceller.

    ``pivot``: the video level around which the channel is LINEAR.  A
    composite-domain channel (channel.impair) is linear in the composite
    itself — pivot 0, the default.  A channel acting at RF (frame/rf.py
    rf_ghost) is linear in the MODULATED envelope, i.e. in ``v - v*``
    where ``v* = ENV_BLANK/(ENV_BLANK - ENV_WHITE)`` is the zero-carrier
    video level (= ``RFPlan.video_zero``): an RF echo of gain g and
    carrier phase phi demodulates to ``v* + (1 + g cos(phi) z^-d)(v -
    v*)`` — a linear ghost about v* plus the affine constant it induces.
    Estimating without the pivot folds that constant into the DC bin and
    the "equalizer" mis-scales the picture's luma (measured: 15.6 dB
    ghosted -> 11.7 dB "equalized"); with it, the same record recovers
    cleanly.  Use the SAME pivot in :func:`apply_equalizer`.
    """
    if ntaps % 2 != 1:
        raise ValueError(f"ntaps must be odd, got {ntaps}")
    if received.ndim == 2:
        if received.shape[0] < 2:
            raise ValueError(
                "a cyclic GCR record needs >= 2 lines (gcr_record)"
            )
        # drop the prefix line: the rest saw the settled channel, so it is
        # the reference period circularly convolved with the channel
        r = received[1:].reshape(-1).astype(jnp.float32) - pivot
        s = jnp.asarray(
            gcr_line(plan, (received.shape[0] - 1) * received.shape[-1]),
            jnp.float32,
        ) - pivot
        nfft = s.shape[-1]  # exact circular convolution — no padding
    else:
        r = received.astype(jnp.float32) - pivot
        s = jnp.asarray(
            gcr_line(plan, received.shape[-1]), jnp.float32
        ) - pivot
        nfft = int(2 ** np.ceil(np.log2(s.shape[-1] + ntaps)))
    if ntaps > nfft - 1:
        raise ValueError(
            f"ntaps {ntaps} exceeds the record's {nfft}-sample period"
        )
    # real-DFT matmuls (dsp.rdft), complex-free: the estimation lengths are
    # short and non-pow2 (cyclic period 2N)
    from color_modem_tpu.dsp.rdft import irdft, rdft

    pad = nfft - s.shape[-1]
    sr, si = rdft(jnp.pad(s, (0, pad)))
    rr, ri = rdft(jnp.pad(r, (0, nfft - r.shape[-1])))
    ps2 = sr * sr + si * si
    ps = jnp.mean(ps2)
    den = ps2 + reg * ps
    w = ps2 / den
    # H = R S* / den + (1 - w)
    hr = (rr * sr + ri * si) / den + (1.0 - w)
    hi = (ri * sr - rr * si) / den
    ph2 = hr * hr + hi * hi
    d2 = ph2 + reg * jnp.mean(ph2)
    e = irdft(hr / d2, -hi / d2, nfft)
    half = (ntaps - 1) // 2
    taps = jnp.concatenate([e[-half:], e[: half + 1]])
    # flat-middle Tukey taper: truncating the impulse response cold would
    # ring, but a full cosine window would distort the near-in taps
    from color_modem_tpu.dsp.design import tukey

    return taps * jnp.asarray(tukey(ntaps, alpha=0.4), jnp.float32)


def apply_equalizer(comp: jax.Array, taps: jax.Array,
                    pivot: float = 0.0) -> jax.Array:
    """Filter a (..., L, N) composite with (possibly traced) equalizer taps.

    Runs on the concatenated line stream — the same time axis the multipath
    ghost rides (channel.impair) — so corrections cross line boundaries like
    the distortion does.

    ``pivot``: equalize about this video level (see
    :func:`design_equalizer` — RF-layer channels are linear about the
    zero-carrier level, not about 0): ``out = pivot + e * (comp -
    pivot)``.  Must match the design-time pivot.

    FFT convolution on device: the taps are traced data (estimated from the
    signal), ruling out the host-built Toeplitz-matmul path, and a direct
    ``lax.conv`` does ~1351 multiply-adds per sample at this tap count.
    One length-2^k rfft over the whole stream is traced-taps-capable and
    costs O(log n) per sample.
    """
    lead, (l, n) = comp.shape[:-2], comp.shape[-2:]
    ntaps = taps.shape[-1]
    stream = comp.reshape(lead + (l * n,)) - pivot
    nfft = int(2 ** np.ceil(np.log2(l * n + ntaps)))
    y = jnp.fft.irfft(
        jnp.fft.rfft(stream, n=nfft) * jnp.fft.rfft(taps, n=nfft), n=nfft
    )
    half = (ntaps - 1) // 2
    # np.convolve-'same' centering with zero-padded edges, matching
    # dsp.apply.fir_same_conv
    out = y[..., half : half + l * n].reshape(lead + (l, n)) + pivot
    return out.astype(comp.dtype)
