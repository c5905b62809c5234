"""FIR design from the published responses (windowed sinc, frequency sampling).

The rules are the classic ones the program also follows, so that both sides
filter with the same taps: Hann-windowed sinc low- and band-passes, and
frequency-sampled FIRs of the SECAM transfer functions (BT.470: pre-emphasis
A(f), anti-cloche G(f), cloche, and a band-limited differentiator), centred
for a delay-free 'same' convolution and Tukey-windowed.
"""

from __future__ import annotations

import numpy as np

#: Grid of the frequency-sampled designs.
DESIGN_NFFT = 8192


def odd(x: float) -> int:
    v = max(3, int(round(x)))
    return v if v % 2 == 1 else v + 1


def lowpass(fs: float, cutoff: float, ntaps: int) -> np.ndarray:
    """Hann-windowed sinc low-pass with unity DC gain."""
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = 2.0 * cutoff / fs * np.sinc(2.0 * cutoff / fs * m)
    h *= np.hanning(ntaps)
    return h / np.sum(h)


def bandpass(fs: float, f_lo: float, f_hi: float, ntaps: int) -> np.ndarray:
    """Difference of two windowed sincs, unity gain at the band centre."""
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = (2.0 * f_hi / fs * np.sinc(2.0 * f_hi / fs * m)
         - 2.0 * f_lo / fs * np.sinc(2.0 * f_lo / fs * m))
    h *= np.hanning(ntaps)
    w = 2.0 * np.pi * 0.5 * (f_lo + f_hi) / fs
    return h / np.abs(np.sum(h * np.exp(-1j * w * np.arange(ntaps))))


def tukey(ntaps: int, alpha: float = 0.7) -> np.ndarray:
    x = np.abs(np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0)
    x /= (ntaps - 1) / 2.0
    w = np.ones(ntaps)
    edge = x > alpha
    w[edge] = 0.5 * (1.0 + np.cos(np.pi * (x[edge] - alpha) / (1.0 - alpha)))
    return w


def freq_sampled(fs: float, response, ntaps: int) -> np.ndarray:
    """FIR of a Hermitian response sampled on a dense rfft grid, centred."""
    nfft = DESIGN_NFFT
    while nfft < 4 * ntaps:
        nfft *= 2
    h_full = np.fft.irfft(
        np.asarray(response(np.fft.rfftfreq(nfft, d=1.0 / fs)), np.complex128),
        n=nfft,
    )
    half = (ntaps - 1) // 2
    return np.concatenate([h_full[-half:], h_full[: half + 1]]) * tukey(ntaps)


def differentiator(fs: float, ntaps: int, taper_start: float = 0.65):
    """j*w per sample, raised-cosine taper from ``taper_start`` of Nyquist."""

    def resp(f):
        f_nyq = fs / 2.0
        f0 = taper_start * f_nyq
        ramp = np.clip((f - f0) / (f_nyq - f0), 0.0, 1.0)
        taper = np.where(f > f0, 0.5 * (1.0 + np.cos(np.pi * ramp)), 1.0)
        return 1j * (2.0 * np.pi * f / fs) * taper

    return freq_sampled(fs, resp, ntaps)


def preemph_response(f, f1: float):
    """BT.470 SECAM video pre-emphasis A(f) = (1 + jf/f1) / (1 + jf/3f1)."""
    return (1.0 + 1j * f / f1) / (1.0 + 1j * f / (3.0 * f1))


def deemph_response(f, f1: float):
    return (1.0 + 1j * f / (3.0 * f1)) / (1.0 + 1j * f / f1)


def _bell_F(f, f0: float):
    f = np.asarray(f, dtype=np.float64)
    fsafe = np.where(np.abs(f) < 1.0, 1.0, f)
    return np.where(np.abs(f) < 1.0, -1e9, fsafe / f0 - f0 / fsafe)


def anticloche_response(f, f0, m0, k_num, k_den):
    """BT.470 HF pre-emphasis G(f) = M0 (1 + j k_num F) / (1 + j k_den F)."""
    F = _bell_F(f, f0)
    return m0 * (1.0 + 1j * k_num * F) / (1.0 + 1j * k_den * F)


def cloche_response(f, f0, m0, k_num, k_den):
    F = _bell_F(f, f0)
    return (1.0 + 1j * k_den * F) / (1.0 + 1j * k_num * F)


def band_mask(f, f_lo, f_hi, transition):
    """0/1 band-pass mask with raised-cosine edges."""
    f = np.abs(np.asarray(f, dtype=np.float64))

    def edge(x):
        return 0.5 * (1.0 - np.cos(np.pi * np.clip(x, 0.0, 1.0)))

    return (edge((f - (f_lo - transition)) / transition)
            * (1.0 - edge((f - f_hi) / transition)))
