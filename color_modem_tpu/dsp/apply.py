"""On-device FIR application — batched 'same' linear convolution in jnp.

The reference applies SciPy IIR filters per scanline inside a Python loop
(SURVEY.md §3.1 hot loop).  Here one call filters every line of every frame
at once: the input is ``(..., N)`` and the convolution runs along the last
(sample) axis, the contiguous minor axis.

Three equivalent paths (K3), all exact linear convolutions with zero-padded
edges and compensated group delay (they match the golden oracle's
``np.convolve(mode='same')`` to float32 tolerance):

* ``matmul`` (default) — the FIR as a banded Toeplitz ``(N, N)`` matrix,
  applied as ``(lines, N) @ (N, N)``: one dense matrix product per filter,
  at N/T times the multiply-adds of the taps themselves (about 6x for 129
  taps on 720-sample lines).  The matrix is built once per (taps, N) pair
  on the host and cached.  Whether a direct banded FIR beats it on the GPU
  is an open question (ROADMAP).
* ``conv`` — direct ``lax.conv_general_dilated``.
* ``fft``  — rfft/irfft per line; the asymptotic path for much longer
  lines/taps.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

_DEFAULT_METHOD = "matmul"

#: Precision of the Toeplitz FIR products: full float32.  Measured on an
#: NVIDIA H100 (400 W limit) at the phase-2/3 sizes of chip_smoke.py: golden
#: parity 129.4-150.7 dB on the composite and 141.8-150.3 dB on the decoded
#: RGB (bound 60 dB), card-vs-CPU within every chip_smoke tolerance.  The
#: card's default (and ``HIGH``) is single-pass TF32: 75.6-104 dB, and it
#: failed card-vs-CPU parity (SECAM composite 1.2e-3, adaptive-comb
#: decisions flipping).  Three bf16 passes (``BF16_BF16_F32_X3``, XLA's
#: Triton GEMM) read 108.9-138.3 dB at 0.45-0.75x the time, but one full
#: smoke run with it died of CUDA_ERROR_ILLEGAL_ADDRESS (ROADMAP).  The CPU
#: computes float32 exactly at every setting.
FIR_PRECISION = lax.Precision.HIGHEST


def set_default_method(method: str) -> None:
    """Override the global FIR path ('matmul' | 'conv' | 'fft')."""
    global _DEFAULT_METHOD
    if method not in ("matmul", "conv", "fft"):
        raise ValueError(method)
    _DEFAULT_METHOD = method


@lru_cache(maxsize=64)
def _toeplitz_cached(taps_bytes: bytes, t: int, n: int) -> np.ndarray:
    taps = np.frombuffer(taps_bytes, dtype=np.float64)
    half = (t - 1) // 2
    mat = np.zeros((n, n), dtype=np.float64)
    # out[j] = sum_k taps[k] * x[j + half - k]  (np.convolve 'same')
    for k in range(t):
        d = half - k  # x index offset
        col = np.arange(max(0, -d), min(n, n - d))
        mat[col + d, col] = taps[k]
    return np.ascontiguousarray(mat.astype(np.float32))


def toeplitz_same(taps, n: int) -> np.ndarray:
    """(N, N) matrix M with  x @ M == np.convolve(x, taps, 'same')."""
    taps = np.asarray(taps, dtype=np.float64)
    return _toeplitz_cached(taps.tobytes(), len(taps), n)


@lru_cache(maxsize=64)
def _toeplitz_held_cached(taps_bytes: bytes, t: int, n: int) -> np.ndarray:
    taps = np.frombuffer(taps_bytes, dtype=np.float64)
    half = (t - 1) // 2
    mat = np.zeros((n, n), dtype=np.float64)
    j = np.arange(n)
    # out[j] = sum_k taps[k] * x[clip(j + half - k, 0, n-1)]
    for k in range(t):
        src = np.clip(j + half - k, 0, n - 1)
        np.add.at(mat, (src, j), taps[k])
    return np.ascontiguousarray(mat.astype(np.float32))


def toeplitz_same_held(taps, n: int) -> np.ndarray:
    """(N, N) matrix M with ``x @ M`` = held-edge 'same' convolution.

    Like :func:`toeplitz_same` but the out-of-range taps read the EDGE
    sample instead of zero (``np.pad(mode='edge')`` folded into the
    matrix — same matmul cost).
    """
    taps = np.asarray(taps, dtype=np.float64)
    return _toeplitz_held_cached(taps.tobytes(), len(taps), n)


def fir_same_held(x: jax.Array, taps, method: str | None = None) -> jax.Array:
    """Held-edge variant of :func:`fir_same` (edge-replicate padding).

    For BASEBAND signals this is the boundary rule that matches physical
    receivers: the analog signal continues through blanking, so the active
    line's neighborhood is ~its edge value, not zero.  Zero-padded edges
    put a full-scale step at both line ends — through SECAM's 257-tap
    de-emphasis (1.9 us exponential tail) that step smeared ~60 samples of
    garbage into each line edge and capped the whole standard's round-trip
    accuracy (measured: FM chain 54 dB in the line interior, 28 dB with
    the edge columns included).  Carrier-band filters keep the zero rule
    (holding one sample of a carrier would extend a DC, not a carrier).
    """
    method = method or _DEFAULT_METHOD
    if method == "matmul":
        mat = jnp.asarray(toeplitz_same_held(taps, x.shape[-1]))
        return jnp.matmul(x, mat, precision=FIR_PRECISION)
    t = len(np.asarray(taps))
    h = (t - 1) // 2
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(h, h)], mode="edge")
    return fir_same(xp, taps, method)[..., h : h + x.shape[-1]]


def fir_same(x: jax.Array, taps, method: str | None = None) -> jax.Array:
    """Linear convolution along the last axis, 'same' length, zero-pad edges.

    ``x``: (..., N) float array.  ``taps``: (T,) with odd T (host-designed).
    Matches ``np.convolve(line, taps, mode='same')`` per line.
    """
    method = method or _DEFAULT_METHOD
    if method == "matmul":
        mat = jnp.asarray(toeplitz_same(taps, x.shape[-1]))
        return jnp.matmul(x, mat, precision=FIR_PRECISION)
    if method == "fft":
        return fir_same_fft(x, taps)
    return fir_same_conv(x, taps)


def fir_same_conv(x: jax.Array, taps) -> jax.Array:
    """Direct-convolution path via ``lax.conv_general_dilated``."""
    taps = jnp.asarray(taps, dtype=x.dtype)
    (t,) = taps.shape
    lead = x.shape[:-1]
    n = x.shape[-1]
    lhs = x.reshape((-1, 1, n))
    # np.convolve flips the kernel; conv_general_dilated correlates, so flip.
    rhs = taps[::-1].reshape((1, 1, t))
    pad_lo = (t - 1) // 2
    pad_hi = t - 1 - pad_lo
    out = lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding=[(pad_lo, pad_hi)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        # full float32: cuDNN's float32 convolution on the H100 read 134 dB
        # against float64 np.convolve at 129 taps (7680x720 lines), the
        # same at every precision setting; stated so no device may
        # substitute a reduced-precision unit
        precision=lax.Precision.HIGHEST,
    )
    return out.reshape(lead + (n,))


def fir_same_fft(x: jax.Array, taps) -> jax.Array:
    """FFT-based equivalent of :func:`fir_same` (one rfft per line)."""
    taps = np.asarray(taps)
    (t,) = taps.shape
    n = x.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + t - 1)))
    # Center-compensated kernel spectrum, precomputed on host.
    kern = np.zeros(nfft)
    kern[:t] = taps
    K = np.fft.rfft(kern)  # delay (t-1)/2 baked in; crop below compensates
    X = jnp.fft.rfft(x, n=nfft, axis=-1)
    y = jnp.fft.irfft(X * jnp.asarray(K), n=nfft, axis=-1)
    lo = (t - 1) // 2
    return y[..., lo : lo + n].astype(x.dtype)
