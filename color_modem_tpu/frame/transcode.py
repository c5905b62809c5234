"""Standards conversion: decode one standard's composite, encode another's.

The classic broadcast operation (the reason machines like the ACE converter
existed): NTSC tape to PAL transmitter and back.  Decode with the source
standard's best decoder, vertically resample the active raster between line
counts (480 <-> 576) with the same anti-aliased windowed-sinc matmul used
for width resampling, and re-encode with the destination's phase law.

Temporal rate conversion (29.97 <-> 25 Hz) is deliberately out of scope:
frames map one-to-one by index (a held-frame converter).  Motion-compensated
rate conversion is a video-processing problem, not a modem one; the seam to
add it is between the decode and encode halves below.

    conv = make_transcoder(plan_ntsc, plan_pal)
    pal_composite = conv(ntsc_composite, frame0)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp.colorimetry import clamp01
from color_modem_tpu.dsp.resample import resample_width
from color_modem_tpu.frame.pipeline import (
    decode_block,
    encode_block,
    frame_line_index,
)
from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.standards.decoders import allowed_decoders


def resample_lines(x: jax.Array, l_out: int) -> jax.Array:
    """(..., L, N) -> (..., l_out, N): anti-aliased vertical resampling
    (the width resampler applied along the line axis)."""
    return jnp.swapaxes(
        resample_width(jnp.swapaxes(x, -1, -2), l_out), -1, -2
    )


def best_decoder(plan: ModemPlan) -> str:
    """Converter-grade decoder choice: the best LINE-LOCAL option the
    registry offers (comb3 > delayline > notch; the temporal comb3d needs
    a frame sequence and is left to explicit callers)."""
    offered = allowed_decoders(plan.cfg)
    for d in ("comb3", "delayline", "notch"):
        if d in offered:
            return d
    return offered[0]


def transcode_block(
    plan_src: ModemPlan,
    plan_dst: ModemPlan,
    comp: jax.Array,
    g_src: jax.Array,
    g_dst: jax.Array,
    decoder: str | None = None,
) -> jax.Array:
    """(..., L_src, N_src) source composite -> (..., L_dst, N_dst)."""
    rgb = decode_block(
        plan_src, comp, g_src, decoder or best_decoder(plan_src)
    )
    rgb = resample_lines(rgb, g_dst.shape[-1])  # g_dst defines the raster
    if plan_dst.n_samples != plan_src.n_samples:
        rgb = resample_width(rgb, plan_dst.n_samples)
    # the resample's sinc ringing overshoots [0, 1]; the encoder's input
    # contract (and any real converter's video clamp) is [0, 1]
    return encode_block(plan_dst, clamp01(rgb), g_dst)


def make_transcoder(
    plan_src: ModemPlan,
    plan_dst: ModemPlan,
    decoder: str | None = None,
):
    """Jitted ``(comp_src (B, L, N), frame0) -> comp_dst`` closure.

    Frames map one-to-one: frame ``frame0+i`` of the source drives frame
    ``frame0+i`` of the destination's phase sequence (held-frame rate
    conversion, module doc).
    """

    @jax.jit
    def transcode(comp, frame0=0):
        b, l = comp.shape[0], comp.shape[-2]
        g_src = frame_line_index(plan_src, frame0, b, l)
        l_dst = round(
            l * plan_dst.cfg.active_lines / plan_src.cfg.active_lines
        )
        g_dst = frame_line_index(plan_dst, frame0, b, l_dst)
        return transcode_block(
            plan_src, plan_dst, comp, g_src, g_dst, decoder
        )

    return transcode


def make_interlaced_transcoder(
    plan_src: ModemPlan,
    plan_dst: ModemPlan,
    decoder: str | None = None,
):
    """Field-sequential converter: (2B, L/2, N) source fields ->
    (2B, L'/2, N) destination fields.

    Composes the interlaced pipelines: decode source fields (weaving the
    frame), resample the woven raster, re-split with the destination's
    field line numbering.  Field RATE conversion (50 <-> 59.94) is
    held-frame like the progressive path: field pairs map one-to-one by
    frame index.
    """
    from color_modem_tpu.frame.interlace import make_interlaced_pipeline

    _, dec_src, _ = make_interlaced_pipeline(
        plan_src, decoder or best_decoder(plan_src)
    )
    enc_dst, _, _ = make_interlaced_pipeline(plan_dst, "notch")

    @jax.jit
    def transcode(comp_fields, frame0=0):
        rgb = dec_src(comp_fields, frame0)
        # even line count: the destination raster splits back into fields
        l_dst = 2 * round(
            rgb.shape[-2] * plan_dst.cfg.active_lines
            / plan_src.cfg.active_lines / 2
        )
        rgb = resample_lines(rgb, l_dst)
        if plan_dst.n_samples != plan_src.n_samples:
            rgb = resample_width(rgb, plan_dst.n_samples)
        return enc_dst(clamp01(rgb), frame0)

    return transcode
