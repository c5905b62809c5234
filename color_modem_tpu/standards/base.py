"""Frozen per-standard configuration dataclasses (SURVEY.md §1 L0, §5.6).

The reference scatters its constants through the modem modules
(``color_modem/ntsc.py`` etc., unverified — SURVEY.md §0.2); here they are a
first-class config layer.  All numeric constants come from the broadcast
standards themselves (ITU-R BT.470 / BT.1700) as collected in SURVEY.md
Appendix A, so they are citable independently of the reference's code.

Design notes
------------
* Configs are **hashable frozen dataclasses** holding only Python scalars and
  tuples, so they can be closed over by ``jax.jit`` or passed as static
  arguments without retracing hazards.
* The subcarrier phase law is stored as an exact **rational** number of
  subcarrier cycles per line, ``cpl = cpl_num / cpl_den`` (SURVEY.md K1).
  This lets the NCO compute the line-start phase with exact int32 modular
  arithmetic for arbitrarily large global line indices — float32 would lose
  the phase after ~1e5 lines, and the device path computes in float32.
* Colorimetry matrices are stored as nested tuples; accessors return NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np

Mat3 = Tuple[Tuple[float, float, float], ...]


def _mat(rows) -> Mat3:
    return tuple(tuple(float(v) for v in row) for row in rows)


@dataclasses.dataclass(frozen=True)
class QamParams:
    """Quadrature-amplitude chroma parameters (NTSC / PAL / NIIR family).

    The composite chroma of one line is
    ``c1_lpf * sin(phi + phase_offset) + s_l * c2_lpf * cos(phi + phase_offset)``
    where ``phi`` is the subcarrier NCO phase and ``s_l`` the per-line V-switch
    sign (PAL) or +1 (NTSC).  SURVEY.md Appendix A.2/A.3.
    """

    fsc: float                 # subcarrier frequency, Hz
    c1_bandwidth: float        # Hz — encode LPF + demod LPF for component 1
    c2_bandwidth: float        # Hz — component 2 (NTSC Q is narrower)
    phase_offset_deg: float    # NTSC: 33.0, PAL: 0.0
    v_switch: bool             # PAL: c2 (V) sign alternates per line
    chroma_band: float         # Hz — half-width of the chroma BPF around fsc
    # NIIR / SECAM IV extension (SURVEY.md A.5): alternate lines carry an
    # unmodulated reference carrier used by the decoder to normalize
    # differential gain/phase.  None disables it (plain QAM).
    reference_amplitude: float | None = None


@dataclasses.dataclass(frozen=True)
class FmParams:
    """SECAM frequency-modulated chroma parameters (SURVEY.md Appendix A.4)."""

    f0r: float                 # D'R rest frequency: 282*fh = 4.40625 MHz
    f0b: float                 # D'B rest frequency: 272*fh = 4.25 MHz
    dev_r: float               # Hz per unit D'R (sign convention documented
    dev_b: float               # in modem/secam.py)
    component_bandwidth: float # Hz — baseband LPF on D'R / D'B before FM
    preemph_f1: float          # LF video pre-emphasis corner: 85 kHz
    bell_f0: float             # anti-cloche / cloche center: 4.286 MHz
    bell_m0: float             # anti-cloche floor gain: 0.115
    bell_k_num: float          # G(f) = M0 (1 + j*k_num*F) / (1 + j*k_den*F)
    bell_k_den: float          # with F = f/f0 - f0/f; spec: 16 and 1.26
    demod_lpf: float           # Hz — post-discriminator LPF cutoff


ChromaParams = Union[QamParams, FmParams]


@dataclasses.dataclass(frozen=True)
class StandardConfig:
    """Complete description of one analog color standard.

    ``cpl_num / cpl_den`` is the exact rational fsc/fh used by the NCO phase
    law; for FM standards it is unused (SECAM restarts phase per line).
    """

    name: str
    fh: float                  # line frequency, Hz
    total_lines: int           # lines per frame incl. blanking (525 / 625)
    active_lines: int          # visible lines (480 / 576)
    t_active: float            # seconds spanned by one image row of N samples
    cpl_num: int               # subcarrier cycles per line, exact rational
    cpl_den: int
    rgb_to_ycc: Mat3           # rows: Y, C1, C2  (C1/C2 = I/Q, U/V, Dr/Db)
    ycc_to_rgb: Mat3           # exact inverse of rgb_to_ycc
    chroma: ChromaParams
    luma_bandwidth: float | None = None  # optional encode-side luma LPF, Hz

    # ---- derived helpers -------------------------------------------------
    def sample_rate(self, samples: int) -> float:
        """Sample rate implied by mapping ``samples`` px onto the active line."""
        return samples / self.t_active

    def rgb_to_ycc_np(self) -> np.ndarray:
        return np.asarray(self.rgb_to_ycc, dtype=np.float64)

    def ycc_to_rgb_np(self) -> np.ndarray:
        return np.asarray(self.ycc_to_rgb, dtype=np.float64)

    @property
    def is_fm(self) -> bool:
        return isinstance(self.chroma, FmParams)


# --- colorimetry construction (SURVEY.md Appendix A, K11) -----------------

#: BT.470 luma weights.
LUMA_ROW = (0.299, 0.587, 0.114)


def make_matrices(c1_row, c2_row) -> tuple[Mat3, Mat3]:
    """Build (forward, inverse) RGB<->(Y,C1,C2) matrices from the chroma rows.

    The inverse is computed numerically at config time so the pair is exact to
    float64 — the reference hard-codes published rounded inverses [MEM-M];
    computing ours avoids a systematic round-trip bias.
    """
    fwd = np.array([LUMA_ROW, c1_row, c2_row], dtype=np.float64)
    inv = np.linalg.inv(fwd)
    return _mat(fwd), _mat(inv)


def diff_row(channel: str, scale: float) -> tuple[float, float, float]:
    """Row for ``scale * (channel - Y)`` with channel in {'R','B'}."""
    e = {"R": (1.0, 0.0, 0.0), "B": (0.0, 0.0, 1.0)}[channel]
    return tuple(scale * (e[i] - LUMA_ROW[i]) for i in range(3))
