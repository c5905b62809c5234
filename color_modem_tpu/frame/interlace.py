"""2:1 interlaced-field pipeline (beyond the reference's still-image scope).

The reference processes progressive stills, using ``frame``/``line`` only as
phase indices (SURVEY.md §2.1 C7 [MEM-M]).  Real 525/60 and 625/50 signals
are interlaced: each frame is transmitted as two fields — the even image
rows first, then the odd rows — and every analog line-number-driven effect
(subcarrier phase progression, PAL V-switch, SECAM Dr/Db alternation, comb
spacing) follows the TRANSMITTED line order, not the spatial row order.

This layer needs no new modem math, because ``encode_block``/``decode_block``
take an arbitrary absolute-line-index map (``gline``) per row:

* a frame ``(B, 3, L, N)`` splits into field blocks ``(2B, 3, L/2, N)``,
  each field a contiguous run of transmitted lines;
* field ``p`` of frame ``f`` gets ``g = f*total_lines + p*field_offset + r``
  with ``field_offset = (total_lines+1)//2`` (NTSC 263, PAL/SECAM 313):
  active lines carry integer line numbers — the famous half line sits in
  vertical blanking, shifting the field's *vertical position*, not its line
  numbering.  With NTSC's half-integer cycles/line, any odd field offset
  lands the second field's carrier in antiphase, reproducing the real
  4-field (PAL: 8-field) sequence;
* line combs/delay-line decoders then comb adjacent TRANSMITTED lines
  (spatially 2 rows apart in the woven frame) — exactly what 1H delay-line
  hardware does, including its halved-per-field vertical chroma resolution.

The temporal ``comb3d`` decoder combs SAME-PARITY fields: adjacent
field-sequential batch entries are half a frame apart (wrong phase law), but
regrouping the batch parity-major — ``(2, B, L/2, N)``, parity leading —
puts each field's true temporal neighbor (same parity, ``pt`` frames away,
carrier in antiphase) at the frame stencil's axis -3, and the stencil's
generic leading dims keep the two parity groups independent.  Vertical
half-line field displacement is not rendered (the frame layer models active
lines only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from color_modem_tpu.frame.pipeline import (
    check_decoder,
    decode_block,
    encode_block,
)
from color_modem_tpu.modem.plan import ModemPlan


def field_offset(plan: ModemPlan) -> int:
    """Absolute-line-number offset of field 2's first active row."""
    return (plan.cfg.total_lines + 1) // 2


def split_fields(frames: jax.Array) -> jax.Array:
    """(B, ..., L, N) -> (2B, ..., L/2, N), field-sequential (top field
    first, matching transmission order).  L must be even."""
    l = frames.shape[-2]
    if l % 2 != 0:
        raise ValueError(f"interlacing needs an even line count, got {l}")
    pair = jnp.stack(
        [frames[..., 0::2, :], frames[..., 1::2, :]], axis=1
    )  # (B, 2, ..., L/2, N)
    return pair.reshape((-1,) + pair.shape[2:])


def weave_fields(fields: jax.Array) -> jax.Array:
    """Inverse of :func:`split_fields`: (2B, ..., L/2, N) -> (B, ..., L, N)."""
    b2 = fields.shape[0]
    if b2 % 2 != 0:
        raise ValueError(f"field-sequential batch must be even, got {b2}")
    pair = fields.reshape((b2 // 2, 2) + fields.shape[1:])
    # rows interleave: out[..., 2r+p, :] = pair[:, p, ..., r, :]
    pair = jnp.moveaxis(pair, 1, -2)  # (B, ..., L/2, 2, N)
    return pair.reshape(pair.shape[:-3] + (-1, pair.shape[-1]))


def field_line_index(plan: ModemPlan, frame0, n_frames: int, n_rows: int):
    """(2B, L/2) absolute line indices for a field-sequential batch.

    Block ``2f+p`` (field ``p`` of frame ``frame0+f``) row ``r`` maps to
    ``(frame0+f)*total_lines + p*field_offset + r``.
    """
    off = field_offset(plan)
    f = jnp.arange(n_frames, dtype=jnp.int32)
    p = jnp.arange(2, dtype=jnp.int32)
    r = jnp.arange(n_rows, dtype=jnp.int32)
    g = (
        (jnp.asarray(frame0, jnp.int32) + f[:, None, None])
        * plan.cfg.total_lines
        + p[None, :, None] * off
        + r[None, None, :]
    )
    return g.reshape(2 * n_frames, n_rows)


def make_interlaced_pipeline(
    plan: ModemPlan, decoder: str = "notch",
    raster: bool = False,
):
    """Jitted interlaced closures: RGB frames <-> field-sequential composite.

    ``encode(rgb (B,3,L,N), frame0) -> (2B, L/2, N)`` composite fields in
    transmission order; ``decode`` weaves the two decoded fields back into
    frames; ``roundtrip`` composes both.  ``comb3d`` decodes parity-major
    (same-parity temporal combing, module doc) and needs a frame batch of
    at least ``2 * temporal_comb_spacing`` frames.

    ``raster``: sync + burst in each line's blanking interval, driven by
    the same per-field line-index maps (vertical blanking / equalizing
    pulses are not modeled, as in the progressive raster path).
    """
    check_decoder(plan, decoder)
    temporal = decoder in ("comb3d", "comb3dA")
    rp = None
    if raster:
        from color_modem_tpu.frame.raster import (
            add_raster,
            make_raster,
            strip_raster,
        )

        rp = make_raster(plan)

    def _decode_core(comp_fields, g):
        b2, rows = comp_fields.shape[0], comp_fields.shape[-2]
        n = comp_fields.shape[-1]
        if temporal:
            # parity-major regroup: axis -3 becomes "same-parity frames"
            cp = comp_fields.reshape(b2 // 2, 2, rows, n).transpose(1, 0, 2, 3)
            gp = g.reshape(b2 // 2, 2, rows).transpose(1, 0, 2)
            out = decode_block(plan, cp, gp, decoder)
            out = out.transpose(1, 0, 2, 3, 4).reshape(b2, 3, rows, n)
        else:
            out = decode_block(plan, comp_fields, g, decoder)
        return weave_fields(out)

    def _decode_fields(comp_fields, frame0):
        if rp is not None:
            comp_fields = strip_raster(rp, comp_fields)
        g = field_line_index(
            plan, frame0, comp_fields.shape[0] // 2, comp_fields.shape[-2]
        )
        return _decode_core(comp_fields, g)

    @jax.jit
    def encode(rgb, frame0=0):
        fields = split_fields(rgb)
        g = field_line_index(plan, frame0, rgb.shape[0], fields.shape[-2])
        comp = encode_block(plan, fields, g)
        if rp is not None:
            comp = add_raster(plan, rp, comp, g)
        return comp

    @jax.jit
    def decode(comp_fields, frame0=0):
        return _decode_fields(comp_fields, frame0)

    @jax.jit
    def roundtrip(rgb, frame0=0):
        # raster deliberately skipped: strip(add(x)) == x exactly, so the
        # round trip is identical and cheaper without it (as in pipeline.py)
        fields = split_fields(rgb)
        g = field_line_index(plan, frame0, rgb.shape[0], fields.shape[-2])
        return _decode_core(encode_block(plan, fields, g), g)

    return encode, decode, roundtrip
