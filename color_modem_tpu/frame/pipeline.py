"""Batched frame pipeline: RGB <-> composite <-> RGB under jit (K12).

The reference's image layer loops Python-side over scanlines (SURVEY.md §3.1
hot loop); here a whole ``(frames, lines, samples)`` batch is one traced
computation — the line loop is gone, frames and lines are just array axes,
and XLA fuses the chain (matrix -> LPF -> NCO mix -> add) into a few
HBM passes.

Layer split:

* ``encode_block`` / ``decode_block`` — pure functions on blocks + absolute
  line indices.  Everything above (jit wrappers here, shard_map wrappers in
  parallel/sharded.py, per-line compat in compat/) composes these.
* ``make_pipeline`` — jitted single-device convenience closures.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp.colorimetry import apply_mat3, clamp01
from color_modem_tpu.dsp.nco import global_line_index
from color_modem_tpu.standards.decoders import allowed_decoders
from color_modem_tpu.modem import niir, qam
from color_modem_tpu.modem import secam as secam_mod
from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.separate.comb import separate
from color_modem_tpu.separate.delayline import average_with_neighbor
from color_modem_tpu.standards.base import QamParams


def check_decoder(plan: ModemPlan, decoder: str) -> None:
    allowed = allowed_decoders(plan.cfg)
    if decoder not in allowed:
        raise ValueError(
            f"{plan.cfg.name} supports decoders {allowed}, got {decoder!r}"
        )


def encode_block(
    plan: ModemPlan, rgb: jax.Array, gline: jax.Array
) -> jax.Array:
    """(..., 3, L, N) RGB in [0,1] + (..., L) absolute lines -> (..., L, N)."""
    ycc = apply_mat3(plan.rgb_to_ycc, rgb.astype(jnp.float32))
    if plan.cfg.is_fm:
        return secam_mod.encode(plan, ycc, gline)
    return qam.encode(plan, ycc, gline)


def decode_block(
    plan: ModemPlan,
    comp: jax.Array,
    gline: jax.Array,
    decoder: str = "notch",
    phase_err: jax.Array | None = None,
    chroma_gain: jax.Array | None = None,
) -> jax.Array:
    """(..., L, N) composite -> (..., 3, L, N) RGB, clamped to [0,1].

    ``phase_err``: optional per-line subcarrier phase error (..., L) in rad
    (e.g. measured from the color burst — frame.raster.decode_burst_locked).
    A carrier phase error d rotates the demodulated (c1, s*c2) pair by d
    (s = per-line V-switch sign); the correction counter-rotates before
    delay-line averaging / NIIR normalization.

    ``chroma_gain``: optional per-line chroma gain CORRECTION (..., L),
    multiplying the demodulated (c1, c2) — the ACC / color-killer hook
    (frame.raster.decode_burst_locked: spec burst amplitude over the
    measured one, or 0 to kill chroma).  QAM standards only, like
    ``phase_err`` (SECAM's FM chroma is amplitude-immune by design and
    has no burst to key on).
    """
    check_decoder(plan, decoder)
    comp = comp.astype(jnp.float32)
    if plan.cfg.is_fm:
        pairing = "interp" if decoder == "interp" else "copy"
        ycc = secam_mod.decode(plan, comp, gline, pairing)
        if decoder == "avg":
            # chroma-averaging wrapper on the assembled Dr/Db planes
            # (standards/decoders.py FM_DECODERS note)
            ycc = jnp.concatenate(
                [
                    ycc[..., :1, :, :],
                    average_with_neighbor(ycc[..., 1:, :, :]),
                ],
                axis=-3,
            )
    else:
        luma, chroma_band = separate(plan, comp, decoder)
        c1, c2 = qam.demodulate_carrier(plan, chroma_band, gline)
        p: QamParams = plan.cfg.chroma
        if phase_err is not None:
            d = phase_err[..., None].astype(jnp.float32)
            s = qam.v_sign(plan, gline)[..., None]
            cd, sd = jnp.cos(d), jnp.sin(d)
            c1, c2 = cd * c1 + s * sd * c2, -s * sd * c1 + cd * c2
        if chroma_gain is not None:
            g = chroma_gain[..., None].astype(jnp.float32)
            c1, c2 = g * c1, g * c2
        if decoder in ("delayline", "avg") and p.reference_amplitude is None:
            c1 = average_with_neighbor(c1)
            c2 = average_with_neighbor(c2)
        if p.reference_amplitude is not None:
            c1, c2 = niir.normalize(plan, c1, c2, gline)
            if decoder == "avg":
                # NIIR averaging must follow normalization: raw demod
                # alternates chroma and reference measurements per line
                c1 = average_with_neighbor(c1)
                c2 = average_with_neighbor(c2)
        ycc = jnp.stack([luma, c1, c2], axis=-3)
    return clamp01(apply_mat3(plan.ycc_to_rgb, ycc))


def roundtrip_block(
    plan: ModemPlan,
    rgb: jax.Array,
    gline: jax.Array,
    decoder: str = "notch",
) -> jax.Array:
    comp = encode_block(plan, rgb, gline)
    return decode_block(plan, comp, gline, decoder)


def frame_line_index(plan: ModemPlan, frame0, n_frames: int, n_lines: int):
    """(B, L) absolute line index array for a frame batch starting at frame0."""
    return global_line_index(frame0, n_frames, n_lines, plan.cfg.total_lines)


def make_pipeline(plan: ModemPlan, decoder: str = "notch",
                  raster: bool = False):
    """Jitted single-device closures over a fixed plan.

    Returns ``(encode, decode, roundtrip)``, each taking a ``(B, ...)`` batch
    and a scalar ``frame0`` (the index of the first frame, which drives the
    NTSC 4-field / PAL 8-field phase sequence across batches).
    ``raster``: emit/consume full rastered lines with sync + color burst in
    the blanking interval (SURVEY.md A.1 — optional, default off); the
    decoder strips the blanking before demodulation.
    """
    check_decoder(plan, decoder)
    rp = None
    if raster:
        from color_modem_tpu.frame.raster import (
            add_raster,
            make_raster,
            strip_raster,
        )

        rp = make_raster(plan)

    @partial(jax.jit, static_argnames=())
    def encode(rgb, frame0=0):
        b, _, l, _ = rgb.shape
        g = frame_line_index(plan, frame0, b, l)
        comp = encode_block(plan, rgb, g)
        if rp is not None:
            comp = add_raster(plan, rp, comp, g)
        return comp

    @jax.jit
    def decode(comp, frame0=0):
        b, l = comp.shape[0], comp.shape[1]
        g = frame_line_index(plan, frame0, b, l)
        if rp is not None:
            comp = strip_raster(rp, comp)
        return decode_block(plan, comp, g, decoder)

    @jax.jit
    def roundtrip(rgb, frame0=0):
        # raster is deliberately skipped here: strip(add(x)) == x exactly,
        # so the round trip is identical and cheaper without it
        b, _, l, _ = rgb.shape
        g = frame_line_index(plan, frame0, b, l)
        return roundtrip_block(plan, rgb, g, decoder)

    return encode, decode, roundtrip
