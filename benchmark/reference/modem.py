"""Float64 encode and decode of whole frames, vectorised over lines.

The semantics are those of a per-scanline analog modem: each line is
filtered on its own ('same' linear convolution with zero edges, or held
edges for SECAM baseband), the subcarrier phase is an exact function of the
absolute line number, and the cross-line decoders (comb, delay line, SECAM
pairing) read reflected neighbours at the frame edges.  Convolutions are
taken through float64 FFTs of every line at once, which is exact to about
1e-15 and fast enough to check thousands of lines after a run.

Arrays are channels-first: RGB ``(F, 3, L, N)``, composite ``(F, L, N)``.
Absolute line ``g = (frame0 + f) * total_lines + l``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.reference import design

TWO_PI = 2.0 * np.pi
#: Decoders this reference implements, per chroma kind.
QAM_DECODERS = ("notch", "comb2", "comb3", "delayline", "avg")
FM_DECODERS = ("notch", "avg", "interp")


@dataclass
class Plan:
    """Taps and constants for one configuration, from its file alone."""

    cfg: dict
    n: int
    fs: float
    fwd: np.ndarray
    inv: np.ndarray
    taps: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)

    @property
    def chroma(self) -> dict:
        return self.cfg["signal"]["chroma"]

    @property
    def total_lines(self) -> int:
        return int(self.cfg["signal"]["total_lines"])


def make_plan(cfg: dict) -> Plan:
    sig, des = cfg["signal"], cfg["design"]
    n = int(cfg["samples"])
    fs = n / float(sig["t_active"])
    k = fs / float(des["ref_fs"])  # tap counts keep their time span
    fwd = np.array([sig["luma_row"], sig["c1_row"], sig["c2_row"]], np.float64)
    plan = Plan(cfg=cfg, n=n, fs=fs, fwd=fwd, inv=np.linalg.inv(fwd))
    ch = sig["chroma"]
    nt = design.odd(des["ntaps"] * k)
    if ch["kind"] == "qam":
        fsc = sig["cpl_num"] / sig["cpl_den"] * sig["fh"]
        plan.taps = {
            "c1_lpf": design.lowpass(fs, ch["c1_bandwidth"], nt),
            "c2_lpf": design.lowpass(fs, ch["c2_bandwidth"], nt),
            "chroma_bpf": design.bandpass(
                fs, fsc - ch["chroma_band"], fsc + ch["chroma_band"], nt),
        }
        plan.extra = {
            "ramp": TWO_PI * np.mod(fsc / fs * np.arange(n, dtype=np.float64), 1.0),
            "theta": float(np.deg2rad(ch["phase_offset_deg"])),
        }
        return plan
    if ch["kind"] != "fm":
        raise ValueError(f"unknown chroma kind {ch['kind']!r}")
    bell_nt = design.odd(des["bell_ntaps"] * k)
    emph_nt = design.odd(des["emph_ntaps"] * k)
    diff_nt = design.odd(des["diff_ntaps"] * k)
    margin = int(round(des["fm_margin"] * k))
    lo = ch["bell_f0"] - des["takeoff_halfwidth"]
    hi = ch["bell_f0"] + des["takeoff_halfwidth"]
    tr = des["band_transition"]
    bell = (ch["bell_f0"], ch["bell_m0"], ch["bell_k_num"], ch["bell_k_den"])
    f_center = 0.5 * (ch["f0r"] + ch["f0b"])
    plan.taps = {
        "comp_lpf": design.lowpass(fs, ch["component_bandwidth"], nt),
        "preemph": design.freq_sampled(
            fs, lambda f: design.preemph_response(f, ch["preemph_f1"]), emph_nt),
        "deemph": design.freq_sampled(
            fs, lambda f: design.deemph_response(f, ch["preemph_f1"]), emph_nt),
        "anticloche": design.freq_sampled(
            fs, lambda f: design.anticloche_response(f, *bell)
            * design.band_mask(f, lo, hi, tr), bell_nt),
        "bell_takeoff": design.freq_sampled(
            fs, lambda f: design.cloche_response(f, *bell)
            * design.band_mask(f, lo, hi, tr), bell_nt),
        "luma_notch": design.freq_sampled(
            fs, lambda f: design.band_mask(f, lo, hi, tr), bell_nt),
        "mix_lpf": design.lowpass(fs, des["mix_lpf"], nt),
        "diff": design.differentiator(fs, diff_nt),
        "demod_lpf": design.lowpass(fs, ch["demod_lpf"], nt),
    }
    plan.extra = {
        "f_center": f_center,
        "margin": margin,
        "luma_est": max(3, int(round(des["fm_luma_est"] * k))),
        # rest carrier in the left blanking margin, per line parity [B, R]
        "margin_carrier": np.stack([
            ch["bell_m0"] * np.cos(
                TWO_PI * f0 / fs * (np.arange(-margin, 0, dtype=np.float64) + 0.5))
            for f0 in (ch["f0b"], ch["f0r"])
        ]),
        "mix_ramp": TWO_PI * np.mod(
            f_center / fs * np.arange(-margin, n + margin, dtype=np.float64), 1.0),
    }
    return plan


# --- primitives ---------------------------------------------------------------


def conv_same(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """``np.convolve(line, taps, 'same')`` for every line (last axis)."""
    t, n = len(taps), x.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(n + t - 1)))
    y = np.fft.irfft(np.fft.rfft(x, nfft, axis=-1) * np.fft.rfft(taps, nfft),
                     nfft, axis=-1)
    lo = (t - 1) // 2
    return y[..., lo: lo + n]


def conv_same_held(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """'same' convolution whose out-of-line taps read the edge sample."""
    h = (len(taps) - 1) // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(h, h)], mode="edge")
    return conv_same(xp, taps)[..., h: h + x.shape[-1]]


def _reflect_rows(x: np.ndarray, shift: int) -> np.ndarray:
    """Row l takes row l+shift, reflected at the frame edges (axis -2)."""
    n = x.shape[-2]
    idx = np.arange(n) + shift
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return x[..., idx, :]


def _neighbor_rows(x: np.ndarray) -> np.ndarray:
    """Opposite-parity partner: the previous row, the next for row 0."""
    idx = np.arange(x.shape[-2]) - 1
    idx[0] = 1
    return x[..., idx, :]


def glines(plan: Plan, frame0: int, n_frames: int, n_lines: int) -> np.ndarray:
    f = np.arange(n_frames, dtype=np.int64) + int(frame0)
    return f[:, None] * plan.total_lines + np.arange(n_lines, dtype=np.int64)


def _qam_phase(plan: Plan, g: np.ndarray) -> np.ndarray:
    sig = plan.cfg["signal"]
    num, den = int(sig["cpl_num"]), int(sig["cpl_den"])
    phi0 = TWO_PI * ((num % den) * (g % den) % den) / den
    return phi0[..., None] + plan.extra["ramp"] + plan.extra["theta"]


def _v_sign(plan: Plan, g: np.ndarray) -> np.ndarray:
    if not plan.chroma["v_switch"]:
        return np.ones(g.shape)
    return np.where(g % 2 == 0, 1.0, -1.0)


def _f0_dev(plan: Plan, g: np.ndarray):
    ch = plan.chroma
    r = g % 2 == 1  # odd absolute lines carry D'R
    return (np.where(r, ch["f0r"], ch["f0b"])[..., None],
            np.where(r, ch["dev_r"], ch["dev_b"])[..., None])


# --- encode / decode ----------------------------------------------------------


def encode(plan: Plan, rgb: np.ndarray, frame0: int) -> np.ndarray:
    """(F, 3, L, N) RGB in [0, 1] -> (F, L, N) composite."""
    rgb = np.asarray(rgb, np.float64)
    ycc = np.einsum("dc,fcln->fdln", plan.fwd, rgb)
    y, c1, c2 = ycc[:, 0], ycc[:, 1], ycc[:, 2]
    g = glines(plan, frame0, rgb.shape[0], rgb.shape[2])
    tp = plan.taps
    if plan.chroma["kind"] == "qam":
        phi = _qam_phase(plan, g)
        s = _v_sign(plan, g)[..., None]
        return (y + conv_same(c1, tp["c1_lpf"]) * np.sin(phi)
                + s * conv_same(c2, tp["c2_lpf"]) * np.cos(phi))
    d = np.where((g % 2 == 1)[..., None], c1, c2)
    d = conv_same_held(conv_same_held(d, tp["comp_lpf"]), tp["preemph"])
    f0, dev = _f0_dev(plan, g)
    f_inst = f0 + dev * d
    # midpoint rule: phi[n] is the phase at exactly sample n
    phi = TWO_PI * (np.cumsum(f_inst, axis=-1) - 0.5 * f_inst) / plan.fs
    return y + conv_same(np.cos(phi), tp["anticloche"])


def decode(plan: Plan, comp: np.ndarray, frame0: int, decoder: str) -> np.ndarray:
    """(F, L, N) composite -> (F, 3, L, N) RGB clamped to [0, 1]."""
    comp = np.asarray(comp, np.float64)
    g = glines(plan, frame0, comp.shape[0], comp.shape[1])
    if plan.chroma["kind"] == "qam":
        ycc = _decode_qam(plan, comp, g, decoder)
    else:
        ycc = _decode_fm(plan, comp, g, decoder)
    return np.clip(np.einsum("cd,fdln->fcln", plan.inv, ycc), 0.0, 1.0)


def _decode_qam(plan, comp, g, decoder):
    if decoder not in QAM_DECODERS:
        raise ValueError(f"reference has no QAM decoder {decoder!r}")
    tp = plan.taps
    sig = plan.cfg["signal"]
    # comb spacing: the line step at which the chroma phase is nearest 180 deg
    p = min((1, 2), key=lambda q: abs((q * sig["cpl_num"] / sig["cpl_den"]) % 1.0 - 0.5))
    if decoder == "comb2":
        stencil = (comp - _reflect_rows(comp, -p)) / 2.0
    elif decoder == "comb3":
        stencil = (2.0 * comp - _reflect_rows(comp, -p) - _reflect_rows(comp, p)) / 4.0
    else:
        stencil = comp
    band = conv_same(stencil, tp["chroma_bpf"])
    phi = _qam_phase(plan, g)
    s = _v_sign(plan, g)[..., None]
    c1 = conv_same(2.0 * band * np.sin(phi), tp["c1_lpf"])
    c2 = s * conv_same(2.0 * band * np.cos(phi), tp["c2_lpf"])
    if decoder in ("delayline", "avg"):
        c1 = 0.5 * (c1 + _neighbor_rows(c1))
        c2 = 0.5 * (c2 + _neighbor_rows(c2))
    return np.stack([comp - band, c1, c2], axis=1)


def _decode_fm(plan, comp, g, decoder):
    if decoder not in FM_DECODERS:
        raise ValueError(f"reference has no FM decoder {decoder!r}")
    tp, ex = plan.taps, plan.extra
    m, k, n = ex["margin"], ex["luma_est"], comp.shape[-1]
    r = g % 2 == 1
    # blanking rebuilt around the active line: the luma pedestal on both
    # sides and the undeviated rest carrier on the left
    left = comp[..., :k].mean(-1, keepdims=True) + ex["margin_carrier"][r.astype(int)]
    right = np.repeat(comp[..., -k:].mean(-1, keepdims=True), m, axis=-1)
    ext = np.concatenate([left, comp, right], axis=-1)
    luma = (ext - conv_same(ext, tp["luma_notch"]))[..., m: m + n]
    takeoff = conv_same(ext, tp["bell_takeoff"])
    i = conv_same(2.0 * takeoff * np.cos(ex["mix_ramp"]), tp["mix_lpf"])
    q = conv_same(-2.0 * takeoff * np.sin(ex["mix_ramp"]), tp["mix_lpf"])
    di, dq = conv_same(i, tp["diff"]), conv_same(q, tp["diff"])
    a2 = np.maximum(i * i + q * q, 1e-9)  # the limiter: amplitude cancels
    f_inst = ex["f_center"] + (i * dq - q * di) / (TWO_PI * a2) * plan.fs
    f0, dev = _f0_dev(plan, g)
    v = conv_same(conv_same((f_inst - f0) / dev, tp["deemph"]), tp["demod_lpf"])
    v = v[..., m: m + n]
    if decoder == "interp":
        other = 0.5 * (_reflect_rows(v, -1) + _reflect_rows(v, 1))
    else:
        other = _neighbor_rows(v)
    rr = r[..., None]
    dr, db = np.where(rr, v, other), np.where(rr, other, v)
    if decoder == "avg":
        dr, db = 0.5 * (dr + _neighbor_rows(dr)), 0.5 * (db + _neighbor_rows(db))
    return np.stack([luma, dr, db], axis=1)
