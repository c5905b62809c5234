"""Sharded frame pipeline: DP over frames x CP over line blocks (SURVEY.md §5.7).

Wraps the pure block functions from frame/pipeline.py in ``jax.shard_map``
over a ``(frame, lineblk)`` mesh:

* encode is line-local — no collectives at all;
* decode extends each line block with its stencil halo (ring ``ppermute``,
  parallel/halo.py), runs the *unchanged* block decoder on the extended
  block, and crops — so the sharded output is bit-identical to the
  unsharded pipeline (tests/test_sharding.py), which is the only reliable
  detector for halo off-by-ones (SURVEY.md §7.3 item 3).

Each device recomputes the halo lines' demodulation locally (a few lines of
redundant VPU work) instead of exchanging post-demod state — one ppermute
pair per decode, no second round-trip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from color_modem_tpu.frame.pipeline import (
    check_decoder,
    decode_block,
    encode_block,
)
from color_modem_tpu.standards.decoders import comb_spacing, temporal_comb_spacing
from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.parallel.halo import (
    crop_halo,
    halo_extend,
    halo_extend_frames,
    halo_extend_lines,
)
from color_modem_tpu.parallel.mesh import FRAME_AXIS, LINE_AXIS


def required_halo(plan: ModemPlan, decoder: str) -> int:
    """LINE-stencil depth of the decode path: comb spacing for every
    line-comb variant (fixed and adaptive), else the 1-line
    pairing/averaging shift (SECAM pairing, NIIR normalize, delay-line).

    FM/NIIR 'avg' CHAINS two 1-line stencils — pairing (SECAM) or
    reference normalization (NIIR), then neighbor averaging — so its
    composed reach is 2 lines."""
    if decoder in ("comb2", "comb3", "combA", "comb3dA"):
        return comb_spacing(plan.cfg)
    if decoder == "avg" and (
        plan.cfg.is_fm
        or getattr(plan.cfg.chroma, "reference_amplitude", None) is not None
    ):
        return 2
    return 1


def halo_edge_rule(plan: ModemPlan, decoder: str) -> str:
    """Global-edge substitution rule PAIRED with :func:`required_halo` —
    one fact about a decoder, stated once: the chained 1-line prev-stencils
    of FM/NIIR 'avg' need 'copy' (see halo_extend docstring for the index
    algebra), every single stencil uses 'reflect'.  Both rules are
    bit-identical to the unsharded pipeline's boundary treatment."""
    if decoder == "avg" and required_halo(plan, decoder) == 2:
        return "copy"
    return "reflect"


def _block_gline(plan: ModemPlan, frame0, b_blk: int, l_blk: int):
    """Absolute line indices for this device's (frame, line) block."""
    foff = lax.axis_index(FRAME_AXIS) * b_blk
    loff = lax.axis_index(LINE_AXIS) * l_blk
    b = jnp.asarray(frame0, jnp.int32) + foff + jnp.arange(b_blk, dtype=jnp.int32)
    l = loff + jnp.arange(l_blk, dtype=jnp.int32)
    return b[:, None] * jnp.int32(plan.cfg.total_lines) + l[None, :]


def _ext_frame_offsets(b_blk: int, pt: int):
    """Frame offsets (block-start relative) of a frame-halo-extended block:
    the ONE place the temporal edge rule lives for locally computed gline.

    The halo frames' indices are pure arithmetic of the mesh position — no
    need to ppermute them like the composite data: interior halos are the
    contiguous neighbor frames; the global first/last blocks substitute the
    in-block frames an odd multiple of ``pt`` away, mirroring
    halo_extend_frames / stencil.prev_reflect_frames.
    """
    nf = lax.axis_size(FRAME_AXIS)
    idx = lax.axis_index(FRAME_AXIS)
    foff = idx * b_blk
    e = jnp.arange(b_blk + 2 * pt, dtype=jnp.int32)
    f = foff + e - pt                                   # interior/default
    f = jnp.where((idx == 0) & (e < pt), foff + e + pt, f)
    f = jnp.where(
        (idx == nf - 1) & (e >= b_blk + pt), foff + e - 3 * pt, f
    )
    return f


def _block_gline_frames_ext(plan: ModemPlan, frame0, b_blk: int, l_blk: int,
                            pt: int):
    """gline for a frame-halo-extended block, computed locally
    (frame-index arithmetic in :func:`_ext_frame_offsets`)."""
    b = jnp.asarray(frame0, jnp.int32) + _ext_frame_offsets(b_blk, pt)
    loff = lax.axis_index(LINE_AXIS) * l_blk
    l = loff + jnp.arange(l_blk, dtype=jnp.int32)
    return b[:, None] * jnp.int32(plan.cfg.total_lines) + l[None, :]


def make_sharded_pipeline(
    plan: ModemPlan, mesh: Mesh, decoder: str = "notch"
):
    """Returns jitted (encode, decode, roundtrip) over the mesh.

    encode: (B, 3, L, N) -> (B, L, N); decode: (B, L, N) -> (B, 3, L, N);
    B must divide the frame axis, L the lineblk axis (use
    parallel.mesh.pad_to_multiple when it doesn't).
    """
    check_decoder(plan, decoder)
    h = required_halo(plan, decoder)
    comp_spec = P(FRAME_AXIS, LINE_AXIS, None)
    rgb_spec = P(FRAME_AXIS, None, LINE_AXIS, None)
    scalar = P()

    def _encode_blk(rgb_blk, frame0):
        b_blk, _, l_blk, _ = rgb_blk.shape
        g = _block_gline(plan, frame0, b_blk, l_blk)
        return encode_block(plan, rgb_blk, g)

    def _decode_blk(comp_blk, frame0):
        b_blk, l_blk, _ = comp_blk.shape
        g = _block_gline(plan, frame0, b_blk, l_blk)
        if decoder in ("comb3d", "comb3dA"):
            # the temporal comb's stencil crosses the FRAME (data-parallel)
            # axis: exchange frame halos on the frame ring, decode the
            # extended block, crop the halo frames.  gline for the halo
            # frames is computed locally (pure arithmetic of the mesh
            # position — no collective needed).  comb3dA's spatial half
            # additionally needs the usual LINE halos: extend both axes,
            # crop both.
            pt = temporal_comb_spacing(plan.cfg)
            cext = halo_extend_frames(comp_blk, pt, FRAME_AXIS)
            gext = _block_gline_frames_ext(plan, frame0, b_blk, l_blk, pt)
            if decoder == "comb3dA":
                cext = halo_extend(cext, h, LINE_AXIS)
                gext = halo_extend_lines(gext, h, LINE_AXIS)
            rgb = decode_block(plan, cext, gext, decoder)
            rgb = rgb[pt : pt + b_blk]
            return crop_halo(rgb, h) if decoder == "comb3dA" else rgb
        edge = halo_edge_rule(plan, decoder)
        cext = halo_extend(comp_blk, h, LINE_AXIS, edge)
        gext = halo_extend_lines(g, h, LINE_AXIS, edge)
        rgb = decode_block(plan, cext, gext, decoder)
        return crop_halo(rgb, h)

    enc_sm = jax.shard_map(
        _encode_blk,
        mesh=mesh,
        in_specs=(rgb_spec, scalar),
        out_specs=comp_spec,
    )
    dec_sm = jax.shard_map(
        _decode_blk,
        mesh=mesh,
        in_specs=(comp_spec, scalar),
        out_specs=rgb_spec,
    )

    @jax.jit
    def encode(rgb, frame0=0):
        return enc_sm(rgb, jnp.asarray(frame0, jnp.int32))

    @jax.jit
    def decode(comp, frame0=0):
        return dec_sm(comp, jnp.asarray(frame0, jnp.int32))

    @jax.jit
    def roundtrip(rgb, frame0=0):
        f0 = jnp.asarray(frame0, jnp.int32)
        return dec_sm(enc_sm(rgb, f0), f0)

    return encode, decode, roundtrip


# --- sharded 2:1 interlaced pipeline ---------------------------------------


def _field_gline(plan: ModemPlan, frame0, b_blk: int, rows_blk: int):
    """(2*b_blk, rows_blk) absolute line indices for this device's
    field-sequential block (frame.interlace.field_line_index, offset by the
    mesh position: frames along FRAME_AXIS, field ROWS along LINE_AXIS)."""
    off = (plan.cfg.total_lines + 1) // 2  # interlace.field_offset
    foff = lax.axis_index(FRAME_AXIS) * b_blk
    roff = lax.axis_index(LINE_AXIS) * rows_blk
    f = jnp.asarray(frame0, jnp.int32) + foff + jnp.arange(b_blk, dtype=jnp.int32)
    p = jnp.arange(2, dtype=jnp.int32)
    r = roff + jnp.arange(rows_blk, dtype=jnp.int32)
    g = (
        f[:, None, None] * jnp.int32(plan.cfg.total_lines)
        + p[None, :, None] * off
        + r[None, None, :]
    )
    return g.reshape(2 * b_blk, rows_blk)


def _field_gline_frames_ext(plan: ModemPlan, frame0, b_blk: int,
                            rows_blk: int, pt: int):
    """(2, b_blk + 2*pt, rows_blk) gline for the parity-major frame-halo-
    extended block: frame-index arithmetic shared with the progressive path
    via :func:`_ext_frame_offsets`, line part from the field parity and row
    offset."""
    f = jnp.asarray(frame0, jnp.int32) + _ext_frame_offsets(b_blk, pt)
    off = (plan.cfg.total_lines + 1) // 2
    roff = lax.axis_index(LINE_AXIS) * rows_blk
    p = jnp.arange(2, dtype=jnp.int32)
    r = roff + jnp.arange(rows_blk, dtype=jnp.int32)
    return (
        f[None, :, None] * jnp.int32(plan.cfg.total_lines)
        + p[:, None, None] * off
        + r[None, None, :]
    )


def make_sharded_interlaced_pipeline(
    plan: ModemPlan, mesh: Mesh, decoder: str = "notch"
):
    """Sharded 2:1 interlaced pipeline (frame.interlace over the mesh).

    Same contract as :func:`frame.interlace.make_interlaced_pipeline` —
    ``encode (B,3,L,N) -> (2B, L/2, N)`` field-sequential composite,
    ``decode`` weaves back — sharded DP over frames x CP over field-row
    blocks.  Both the field split and the weave are device-local: a device
    owning spatial lines ``[jL_b, (j+1)L_b)`` owns field rows
    ``[jL_b/2, (j+1)L_b/2)`` of BOTH parities, which are contiguous runs of
    the global field-row axis, so the composite shards ``(frame, lineblk)``
    with no relayout.  Line combs comb transmitted-adjacent lines =
    field-row neighbors, so the usual row-axis ring halos apply unchanged;
    ``comb3d``/``comb3dA`` regroup parity-major per device (each device
    holds both fields of its frames) and exchange frame halos around the DP
    ring per parity group.

    Needs ``B`` divisible by the frame axis (``>= 2*spacing`` frames per
    device for the temporal combs), ``L`` even and ``L/2`` divisible by the
    line axis with ``>=`` halo+1 rows per block.
    """
    from color_modem_tpu.frame.interlace import split_fields, weave_fields
    from color_modem_tpu.standards.decoders import temporal_comb_spacing

    check_decoder(plan, decoder)
    h = required_halo(plan, decoder)
    comp_spec = P(FRAME_AXIS, LINE_AXIS, None)
    rgb_spec = P(FRAME_AXIS, None, LINE_AXIS, None)
    scalar = P()

    def _encode_blk(rgb_blk, frame0):
        b_blk, _, l_blk, _ = rgb_blk.shape
        fields = split_fields(rgb_blk)  # (2b, 3, l_blk/2, N)
        g = _field_gline(plan, frame0, b_blk, l_blk // 2)
        return encode_block(plan, fields, g)

    def _decode_blk(comp_blk, frame0):
        b2, rows_blk, n = comp_blk.shape
        b_blk = b2 // 2
        if decoder in ("comb3d", "comb3dA"):
            pt = temporal_comb_spacing(plan.cfg)
            # parity-major regroup (device-local: both fields of each of
            # this device's frames are here), then frame halos per parity
            cp = comp_blk.reshape(b_blk, 2, rows_blk, n).transpose(1, 0, 2, 3)
            cext = halo_extend_frames(cp, pt, FRAME_AXIS)
            gext = _field_gline_frames_ext(plan, frame0, b_blk, rows_blk, pt)
            if decoder == "comb3dA":
                cext = halo_extend(cext, h, LINE_AXIS)
                gext = halo_extend_lines(gext, h, LINE_AXIS)
            out = decode_block(plan, cext, gext, decoder)
            out = out[:, pt : pt + b_blk]  # (2, b, 3, rows', n)
            if decoder == "comb3dA":
                out = crop_halo(out, h)
            out = out.transpose(1, 0, 2, 3, 4).reshape(b2, 3, rows_blk, n)
            return weave_fields(out)
        g = _field_gline(plan, frame0, b_blk, rows_blk)
        edge = halo_edge_rule(plan, decoder)
        cext = halo_extend(comp_blk, h, LINE_AXIS, edge)
        gext = halo_extend_lines(g, h, LINE_AXIS, edge)
        out = crop_halo(decode_block(plan, cext, gext, decoder), h)
        return weave_fields(out)

    enc_sm = jax.shard_map(
        _encode_blk, mesh=mesh, in_specs=(rgb_spec, scalar),
        out_specs=comp_spec,
    )
    dec_sm = jax.shard_map(
        _decode_blk, mesh=mesh, in_specs=(comp_spec, scalar),
        out_specs=rgb_spec,
    )

    @jax.jit
    def encode(rgb, frame0=0):
        return enc_sm(rgb, jnp.asarray(frame0, jnp.int32))

    @jax.jit
    def decode(comp, frame0=0):
        return dec_sm(comp, jnp.asarray(frame0, jnp.int32))

    @jax.jit
    def roundtrip(rgb, frame0=0):
        f0 = jnp.asarray(frame0, jnp.int32)
        return dec_sm(enc_sm(rgb, f0), f0)

    return encode, decode, roundtrip


# --- sharded D2-MAC pipeline ------------------------------------------------


def make_sharded_mac_pipeline(plan, mesh: Mesh):
    """Jitted (encode, decode, roundtrip) for the MAC family over the mesh.

    MAC (modem/mac.py) needs no QAM/FM machinery: encode is line-local and
    decode's only cross-line dependency is the ±1-line neighbor average of
    the line-sequential chroma — halo 1, reflect edges, the same ring
    ppermute as every other decoder here.  ``plan`` is a
    modem.mac_plan.MacPlan; shapes are (B, 3, L, W) <-> (B, L, 1296).
    """
    from color_modem_tpu.modem import mac

    h = 1
    sig_spec = P(FRAME_AXIS, LINE_AXIS, None)
    rgb_spec = P(FRAME_AXIS, None, LINE_AXIS, None)
    scalar = P()

    def _gline(frame0, b_blk: int, l_blk: int):
        foff = lax.axis_index(FRAME_AXIS) * b_blk
        loff = lax.axis_index(LINE_AXIS) * l_blk
        b = (jnp.asarray(frame0, jnp.int32) + foff
             + jnp.arange(b_blk, dtype=jnp.int32))
        l = loff + jnp.arange(l_blk, dtype=jnp.int32)
        return b[:, None] * jnp.int32(plan.cfg.total_lines) + l[None, :]

    def _encode_blk(rgb_blk, frame0):
        b_blk, _, l_blk, _ = rgb_blk.shape
        return mac.encode(plan, rgb_blk, _gline(frame0, b_blk, l_blk))

    def _decode_blk(sig_blk, frame0):
        b_blk, l_blk, _ = sig_blk.shape
        g = _gline(frame0, b_blk, l_blk)
        sext = halo_extend(sig_blk, h, LINE_AXIS)
        gext = halo_extend_lines(g, h, LINE_AXIS)
        return crop_halo(mac.decode(plan, sext, gext), h)

    enc_sm = jax.shard_map(
        _encode_blk, mesh=mesh, in_specs=(rgb_spec, scalar),
        out_specs=sig_spec,
    )
    dec_sm = jax.shard_map(
        _decode_blk, mesh=mesh, in_specs=(sig_spec, scalar),
        out_specs=rgb_spec,
    )

    @jax.jit
    def encode(rgb, frame0=0):
        return enc_sm(rgb, jnp.asarray(frame0, jnp.int32))

    @jax.jit
    def decode(sig, frame0=0):
        return dec_sm(sig, jnp.asarray(frame0, jnp.int32))

    @jax.jit
    def roundtrip(rgb, frame0=0):
        f0 = jnp.asarray(frame0, jnp.int32)
        return dec_sm(enc_sm(rgb, f0), f0)

    return encode, decode, roundtrip


def make_sharded_palplus_pipeline(
    plan: ModemPlan, mesh: Mesh, decoder: str = "comb3",
    helper_gain: float = 1.0,
):
    """Jitted (encode, decode, roundtrip) for PALplus over the mesh —
    **data-parallel over frames only**.

    Sharding decision, recorded like mesh.py's Ulysses/TP notes: the
    PALplus vertical filter bank (frame/palplus.py) is a GLOBAL linear
    map along the line axis — the letterbox resample and the helper's
    modulated decimation each touch every line of the frame, so a
    line-block sharding would turn the (L, 3L/4) resample matmuls into
    all_gathers of the whole luma plane per stage.  At this workload's
    sizes (L <= 1152) a whole frame is far below one device's memory,
    so frames shard (zero steady-state collectives) and lines do not.
    The lineblk mesh axis is accepted but must be 1 for PALplus.
    """
    from color_modem_tpu.frame.palplus import (
        PalPlusGeometry,
        decode_palplus,
        encode_palplus,
    )

    PalPlusGeometry(plan.cfg.active_lines)  # validate the standard's raster
    if mesh.shape.get(LINE_AXIS, 1) != 1:
        raise ValueError(
            "PALplus shards frames only (vertical filter bank is global "
            f"along lines) — build the mesh with {LINE_AXIS}=1, got "
            f"{mesh.shape}"
        )
    comp_spec = P(FRAME_AXIS, None, None)
    rgb_spec = P(FRAME_AXIS, None, None, None)
    scalar = P()

    def _gline(frame0, b_blk: int, l_full: int):
        foff = lax.axis_index(FRAME_AXIS) * b_blk
        b = (jnp.asarray(frame0, jnp.int32) + foff
             + jnp.arange(b_blk, dtype=jnp.int32))
        l = jnp.arange(l_full, dtype=jnp.int32)
        return b[:, None] * jnp.int32(plan.cfg.total_lines) + l[None, :]

    def _encode_blk(rgb_blk, frame0):
        g = _gline(frame0, rgb_blk.shape[0], rgb_blk.shape[-2])
        return encode_palplus(plan, rgb_blk, g, helper_gain)

    def _decode_blk(comp_blk, frame0):
        g = _gline(frame0, comp_blk.shape[0], comp_blk.shape[-2])
        return decode_palplus(
            plan, comp_blk, g, decoder, helper_gain
        )

    enc_sm = jax.shard_map(
        _encode_blk, mesh=mesh, in_specs=(rgb_spec, scalar),
        out_specs=comp_spec,
    )
    dec_sm = jax.shard_map(
        _decode_blk, mesh=mesh, in_specs=(comp_spec, scalar),
        out_specs=rgb_spec,
    )

    @jax.jit
    def encode(rgb, frame0=0):
        return enc_sm(rgb, jnp.asarray(frame0, jnp.int32))

    @jax.jit
    def decode(comp, frame0=0):
        return dec_sm(comp, jnp.asarray(frame0, jnp.int32))

    @jax.jit
    def roundtrip(rgb, frame0=0):
        f0 = jnp.asarray(frame0, jnp.int32)
        return dec_sm(enc_sm(rgb, f0), f0)

    return encode, decode, roundtrip


# --- sharded transmission hop (RF / satellite) ------------------------------


def make_sharded_hop_pipeline(plan, mesh: Mesh, hop, decoder: str = "notch"):
    """encode -> frame-local transmission hop -> decode over the mesh.

    The RF/satellite hops (frame/rf.py, frame/satellite.py) consume each
    frame's rows JOINED into one contiguous broadcast-time stream, so they
    cannot split the line axis: the hop stage shards the BATCH over the
    whole flattened device grid (frames are independent) — every device
    processes whole frames, none idles, and the spec change at the stage
    boundary makes XLA insert the line-axis all-gather before the hop and
    the re-partition after (the honest price of a frame-global channel
    stage: ~2 MB per frame each way).  When the batch
    does not divide the device count, the hop falls back to FRAME-axis
    sharding (line-group devices then replicate the hop compute).  The
    composite encode/decode stages keep their full (frame, lineblk)
    sharding and ring halos throughout.

    ``hop(comp, frame0) -> comp`` must be frame-local (batch items
    independent) and keyed on the ABSOLUTE frame index, e.g.
    ``lambda c, f0: rf_roundtrip(rfp, c, f0)`` or
    ``lambda c, f0: fm_demodulate(sp, fm_modulate(sp, c))``.  Sharded
    output matches the unsharded enc->hop->dec chain to float tolerance,
    NOT bit: the hop's stream-FFT fp schedule depends on the per-device
    batch shape (measured 7.3e-7 on the RF chain, 4.6e-4 on satellite's
    phase-sensitive FM integral — tests/test_sharding.py).
    """
    import math

    enc, dec, _ = make_sharded_pipeline(plan, mesh, decoder)
    scalar = P()
    n_line = int(mesh.devices.shape[1])
    total = int(math.prod(mesh.devices.shape))

    def _mk_hop(flat: bool):
        def _hop_blk(comp_blk, frame0):
            b_blk = comp_blk.shape[0]
            dev = lax.axis_index(FRAME_AXIS)
            if flat:
                dev = dev * n_line + lax.axis_index(LINE_AXIS)
            return hop(comp_blk, frame0 + dev * jnp.int32(b_blk))

        spec = P((FRAME_AXIS, LINE_AXIS) if flat else FRAME_AXIS,
                 None, None)
        return jax.shard_map(
            _hop_blk, mesh=mesh, in_specs=(spec, scalar),
            out_specs=spec,
        )

    hop_flat, hop_frame = _mk_hop(True), _mk_hop(False)

    @jax.jit
    def roundtrip(rgb, frame0=0):
        f0 = jnp.asarray(frame0, jnp.int32)
        comp = enc(rgb, f0)
        # static-shape branch at trace time: full-grid batch sharding
        # when the batch divides the device count, frame-axis otherwise
        hop_sm = hop_flat if rgb.shape[0] % total == 0 else hop_frame
        return dec(hop_sm(comp, f0), f0)

    return enc, dec, roundtrip


def make_sharded_hop_audio_pipeline(plan, mesh: Mesh, hop,
                                    decoder: str = "notch"):
    """:func:`make_sharded_hop_pipeline` for FRAME-LOCAL hops that carry an
    audio stream alongside the video — the satellite link with its FM
    subcarrier ladder (frame/satellite.py: per-frame circular FM, so each
    batch item's audio block is ONE PERIOD and shards with its frame; no
    cross-device state exists by construction).

    ``hop(comp_blk, aud_blk, frame0) -> (comp, aud_rx)`` must be
    frame-local in BOTH streams; audio is ``(B, K, S)`` (or ``(B, S)``,
    normalized to K=1), one block of ``S`` baseband samples per frame per
    designed subcarrier.  Returns ``roundtrip(rgb, audio, frame0) ->
    (rgb, aud_rx)``; the batch-grid sharding and the frame-axis fallback
    mirror the video-only factory.
    """
    import math

    enc, dec, _ = make_sharded_pipeline(plan, mesh, decoder)
    scalar = P()
    n_line = int(mesh.devices.shape[1])
    total = int(math.prod(mesh.devices.shape))

    def _mk_hop(flat: bool):
        def _hop_blk(comp_blk, aud_blk, frame0):
            b_blk = comp_blk.shape[0]
            dev = lax.axis_index(FRAME_AXIS)
            if flat:
                dev = dev * n_line + lax.axis_index(LINE_AXIS)
            return hop(comp_blk, aud_blk, frame0 + dev * jnp.int32(b_blk))

        ax = (FRAME_AXIS, LINE_AXIS) if flat else FRAME_AXIS
        cspec, aspec = P(ax, None, None), P(ax, None, None)
        return jax.shard_map(
            _hop_blk, mesh=mesh, in_specs=(cspec, aspec, scalar),
            out_specs=(cspec, aspec),
        )

    hop_flat, hop_frame = _mk_hop(True), _mk_hop(False)

    @jax.jit
    def roundtrip(rgb, audio, frame0=0):
        f0 = jnp.asarray(frame0, jnp.int32)
        aud = jnp.asarray(audio, jnp.float32)
        if aud.ndim == 2:
            aud = aud[:, None, :]
        comp = enc(rgb, f0)
        hop_sm = hop_flat if rgb.shape[0] % total == 0 else hop_frame
        comp, aud_rx = hop_sm(comp, aud, f0)
        return dec(comp, f0), aud_rx

    return enc, dec, roundtrip


def make_sharded_rf_sound_pipeline(plan, mesh: Mesh, rfp,
                                   decoder: str = "notch"):
    """encode -> RF hop CARRYING THE JOINED-STREAM FM SOUND -> decode, over
    the mesh: the one subsystem family whose state crosses the batch.

    The intercarrier sound carrier runs over the chunk's frames JOINED as
    one broadcast-time stream (frame/rf.py::sound_on_rf): its deviation
    integral is a cumsum ACROSS frames — exactly the batch-crossing
    sequential dependency frame-DP sharding would silently break.  The
    same prefix-phase trick that made the chunked video runner
    chunk-independent (host-f64 phi0 per chunk, frame/video.py) makes it
    shard-clean, done here with collectives instead of the host:

    * **transmit** — each device integrates its own sub-batch's deviation
      locally and seeds it with ``phi0`` = the exclusive prefix of the
      per-device deviation sums around the flat device ring: ONE
      ``all_gather`` of a scalar per device, then a masked sum (reduced
      mod 2pi, like the video runner's host prefix).  A device's phase
      therefore differs from the unsharded joined cumsum only by f32
      reassociation — a quasi-static offset the FM discriminator is
      insensitive to.
    * **receive** — the sound takeoff's stream filters (composed 8193-tap
      complex conv at RF rate + 8193-tap audio low-pass, ~8 lines of
      total warm-up) need true neighbor context at device boundaries:
      each device fetches ONE neighbor frame of RF each way around the
      same flat ring (two ``ppermute``; the video runner's "one-frame
      overlap fetch" as a collective), demodulates the extended stream
      (frame/rf.py::sound_from_rf_halo) and crops.  The global first/last
      devices get ZERO halo frames with the discriminator masked dead
      over them — reproducing the unsharded stream ends exactly.

    Video stays frame-local (``rf_modulate``/``rf_demodulate`` per-frame
    streams) and shards like :func:`make_sharded_hop_pipeline`'s flat
    path; the composite encode/decode stages keep their full
    (frame, lineblk) sharding and ring halos.  Requires the batch to
    divide the flat device count (the sound ring needs every device to
    hold the same number of consecutive frames).

    Returns ``(encode, decode, roundtrip)`` with
    ``roundtrip(rgb, audio, frame0) -> (rgb, audio_rx)``; ``audio`` is
    (B, L*N) in [-1, 1] at the composite rate, consecutive frames of one
    stream.  Sharded output matches the unsharded
    modulate -> sound_on_rf -> sound_from_rf/demodulate chain to float
    tolerance (tests/test_sharding.py measures it), not bit: the stream
    FFTs' fp schedule depends on the per-device batch shape.
    """
    import math

    from color_modem_tpu.frame.rf import (
        TWO_PI,
        rf_demodulate,
        rf_modulate,
        sound_from_rf_halo,
        sound_on_rf,
    )

    enc, dec, _ = make_sharded_pipeline(plan, mesh, decoder)
    scalar = P()
    n_line = int(mesh.devices.shape[1])
    total = int(math.prod(mesh.devices.shape))
    axes = (FRAME_AXIS, LINE_AXIS)

    def _hop_blk(comp_blk, aud_blk, frame0):
        b_blk = comp_blk.shape[0]
        dev = (lax.axis_index(FRAME_AXIS) * n_line
               + lax.axis_index(LINE_AXIS))
        f0 = frame0 + dev * jnp.int32(b_blk)
        rf = rf_modulate(rfp, comp_blk, f0)
        # transmit: per-device deviation-phase prefix around the flat ring
        local = jnp.float32(TWO_PI * rfp.snd_dev / rfp.plan.fs) * jnp.sum(
            aud_blk
        )
        totals = lax.all_gather(local, axes)                 # (total,)
        phi0 = jnp.sum(
            jnp.where(jnp.arange(total, dtype=jnp.int32) < dev, totals, 0.0)
        ) % jnp.float32(TWO_PI)
        rf = sound_on_rf(rfp, rf, f0, aud_blk, phi0)
        comp_rx = rf_demodulate(rfp, rf, f0)
        # receive: one-frame RF halo each way (zeros at the global ends)
        if total > 1:
            down = [(i, (i + 1) % total) for i in range(total)]
            up = [(i, (i - 1) % total) for i in range(total)]
            from_prev = lax.ppermute(rf[-1:], axes, down)
            from_next = lax.ppermute(rf[:1], axes, up)
        else:
            from_prev = from_next = jnp.zeros_like(rf[:1])
        zero = jnp.zeros_like(rf[:1])
        head = jnp.where(dev == 0, zero, from_prev)
        tail = jnp.where(dev == total - 1, zero, from_next)
        rf_ext = jnp.concatenate([head, rf, tail], axis=0)
        aud_rx = sound_from_rf_halo(
            rfp, rf_ext, f0 - 1, 1,
            head_dead=(dev == 0), tail_dead=(dev == total - 1),
        )
        return comp_rx, aud_rx

    spec3 = P(axes, None, None)
    spec2 = P(axes, None)
    hop_sm = jax.shard_map(
        _hop_blk, mesh=mesh, in_specs=(spec3, spec2, scalar),
        out_specs=(spec3, spec2),
    )

    @jax.jit
    def roundtrip(rgb, audio, frame0=0):
        if rgb.shape[0] % total:
            raise ValueError(
                f"batch {rgb.shape[0]} must divide the {total}-device grid "
                "— the joined-stream sound ring gives every device an "
                "equal consecutive sub-batch"
            )
        f0 = jnp.asarray(frame0, jnp.int32)
        comp = enc(rgb, f0)
        comp, aud_rx = hop_sm(comp, jnp.asarray(audio, jnp.float32), f0)
        return dec(comp, f0), aud_rx

    return enc, dec, roundtrip
