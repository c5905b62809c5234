"""The work each stage of the modem needs, counted from the algorithm.

These counts are the yardstick of the roofline shares.  They follow the
signal chain as the configuration states it -- tap counts from its
``design`` block, the frame shape, the chroma kind and the decoder -- and
never what an implementation happens to execute: a Toeplitz GEMM does
``2 * N`` multiply-adds per output sample where a ``T``-tap FIR needs
``2 * T``, and a direct or FFT filter would do yet another amount; the count
here is the same for all of them.

Counted, per output sample of a line unless stated:

* each FIR: ``2 * taps`` (one multiply and one add per tap), over the
  samples it is applied to (SECAM's receiver filters the line extended by
  its blanking margins, ``N + 2 * margin``);
* the 3x3 colour matrix: 18 per pixel;
* elementwise arithmetic: the comb stencil, the subcarrier mixing, the FM
  phase integral and the quadrature discriminator, as listed below.
  Transcendental functions (sin, cos) count 0: they run on the special
  function units, outside the float32 FMA peak.

Bytes are the stage's input plus its output in float32: RGB ``3 * 4`` bytes
per pixel, composite 4 bytes per sample.
"""

from __future__ import annotations


def _taps(config: dict) -> dict:
    """Tap counts, scaled with the sample rate so each filter keeps its span."""
    des, sig = config["design"], config["signal"]
    fs = config["samples"] / sig["t_active"]
    k = fs / des["ref_fs"]

    def odd(x):
        v = max(3, int(round(x)))
        return v if v % 2 else v + 1

    return {
        "fir": odd(des["ntaps"] * k),
        "bell": odd(des["bell_ntaps"] * k),
        "emph": odd(des["emph_ntaps"] * k),
        "diff": odd(des["diff_ntaps"] * k),
        "margin": int(round(des["fm_margin"] * k)),
    }


def flops_per_line(config: dict, stage: str) -> int:
    """Essential float operations of one line through ``stage``."""
    n = int(config["samples"])
    t = _taps(config)
    kind = config["signal"]["chroma"]["kind"]
    colour = 18 * n
    if kind == "qam" and stage == "encode":
        # two chroma low-passes; mixing c1*sin + s*c2*cos + y and the phase
        return colour + 2 * (2 * t["fir"]) * n + 6 * n
    if kind == "qam" and stage == "decode":
        stencil = {"comb2": 2, "comb3": 4}.get(config["decoder"], 0)
        average = 4 if config["decoder"] in ("delayline", "avg") else 0
        # band-pass, luma = comp - band, two product detectors (2 each),
        # two low-passes, the V-switch sign
        return (colour + (stencil + 2 * t["fir"] + 1 + 4 + 2 * (2 * t["fir"])
                          + 1 + average) * n)
    if kind == "fm" and stage == "encode":
        # held low-pass and pre-emphasis; f0 + dev*d (2), scaling (1), the
        # midpoint integral (3), base phase (1); anti-cloche; + luma (1)
        return (colour + (2 * t["fir"] + 2 * t["emph"] + 7
                          + 2 * t["bell"] + 1) * n)
    if kind == "fm" and stage == "decode":
        ext = n + 2 * t["margin"]
        pairing = {"interp": 2, "avg": 4}.get(config["decoder"], 0)
        per_ext = (
            2 * t["bell"] + 1          # luma notch, luma = ext - band
            + 2 * t["bell"]            # bell take-off
            + 4                        # quadrature mix to the band centre
            + 2 * (2 * t["fir"])       # I and Q low-passes
            + 2 * (2 * t["diff"])      # dI, dQ
            + 10                       # I*dQ - Q*dI over 2*pi*(I^2 + Q^2)
            + 2                        # (f - f0) / dev
            + 2 * t["emph"]            # de-emphasis
            + 2 * t["fir"]             # component low-pass
        )
        return colour + per_ext * ext + pairing * n
    raise ValueError(f"no count for {kind} {stage}")


def stage_work(config: dict, stage: str, frames: int) -> tuple[int, int]:
    """(flops, bytes) of one call of ``stage`` on ``frames`` frames."""
    lines, n = int(config["lines"]), int(config["samples"])
    px = frames * lines * n
    rgb_b, comp_b = 12 * px, 4 * px
    return frames * lines * flops_per_line(config, stage), rgb_b + comp_b
