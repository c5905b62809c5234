"""S-Video (separate Y/C) transmission path.

Composite video's signature artifacts — cross-color (luma detail decoded as
rainbow chroma) and cross-luminance (chroma carrier crawling as luma dots) —
exist because Y and modulated chroma share one wire.  S-Video keeps them on
two wires; simulating both paths side by side isolates exactly the artifacts
the separation stage (notch/comb/delay-line) exists to fight, which is the
reference library's core use case one step further.

The encode reuses the full composite encoder and splits exactly:
``composite == Y + C`` to float32 rounding (bit-exact on the QAM/FM paths;
NIIR's reference-line select can fuse with ~1e-8 rounding differences), so
the C plane carries precisely the modulated-chroma signal (including NIIR's
reference-carrier lines).  The
decoder is the ideal S-Video receiver: luma passes through untouched, chroma
demodulates straight off the clean carrier — no separation stage, no
decoder-variant choice to make.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp.colorimetry import apply_mat3, clamp01
from color_modem_tpu.frame.pipeline import encode_block, frame_line_index
from color_modem_tpu.modem import niir, qam
from color_modem_tpu.modem import secam as secam_mod
from color_modem_tpu.modem.plan import ModemPlan


def encode_yc(
    plan: ModemPlan, rgb: jax.Array, gline: jax.Array
) -> jax.Array:
    """(..., 3, L, N) RGB -> (..., 2, L, N) stacked (Y, C) planes.

    ``Y + C`` equals the composite encoder's output exactly (same kernels,
    same phase law); Y is the matrix luma before any filtering.
    """
    ycc = apply_mat3(plan.rgb_to_ycc, rgb.astype(jnp.float32))
    y = ycc[..., 0, :, :]
    comp = encode_block(plan, rgb, gline)
    return jnp.stack([y, comp - y], axis=-3)


def decode_yc(
    plan: ModemPlan, yc: jax.Array, gline: jax.Array
) -> jax.Array:
    """(..., 2, L, N) (Y, C) planes -> (..., 3, L, N) RGB in [0, 1]."""
    y = yc[..., 0, :, :]
    c = yc[..., 1, :, :]
    if plan.cfg.is_fm:
        # ideal receiver: interpolated pairing (modem/secam.
        # pair_components_interp), the best assembly the framework offers
        _, v = secam_mod.demodulate_lines(plan, c, gline)
        c1, c2 = secam_mod.pair_components_interp(v, gline)
    else:
        c1, c2 = qam.demodulate_carrier(plan, c, gline)
        if plan.cfg.chroma.reference_amplitude is not None:
            c1, c2 = niir.normalize(plan, c1, c2, gline)
    ycc = jnp.stack([y, c1, c2], axis=-3)
    return clamp01(apply_mat3(plan.ycc_to_rgb, ycc))


def make_svideo_pipeline(plan: ModemPlan):
    """Jitted (encode, decode, roundtrip) closures, mirroring
    frame.pipeline.make_pipeline but over (B, 2, L, N) Y/C signals."""

    @jax.jit
    def encode(rgb, frame0=0):
        g = frame_line_index(plan, frame0, rgb.shape[0], rgb.shape[-2])
        return encode_yc(plan, rgb, g)

    @jax.jit
    def decode(yc, frame0=0):
        g = frame_line_index(plan, frame0, yc.shape[0], yc.shape[-2])
        return decode_yc(plan, yc, g)

    @jax.jit
    def roundtrip(rgb, frame0=0):
        g = frame_line_index(plan, frame0, rgb.shape[0], rgb.shape[-2])
        return decode_yc(plan, encode_yc(plan, rgb, g), g)

    return encode, decode, roundtrip
