"""PALplus: 16:9 letterbox transmission with a vertical-helper signal.

The last analog-TV enhancement (ETS 300 731, broadcast 1994-2007): a 16:9
programme is transmitted as a 4:3-compatible letterbox (the picture
vertically compressed to 3/4 height, black bars above and below), and the
vertical detail lost to that compression — the "helper" — is modulated onto
the colour subcarrier *inside the black bars*, where a conventional
receiver shows (nearly) nothing and a PALplus receiver demodulates it and
reconstructs the full-resolution 16:9 picture.

Reference parity: beyond-reference (the upstream ``kFYatek/color_modem``
library has no enhanced-PAL systems; SURVEY.md §2.1, mount empty §0.1).
Signalled on air by the line-23 WSS word this framework already carries
(:mod:`color_modem_tpu.frame.wss`, EN 300 294 "16:9 letterbox centre").

Array formulation — the whole system is four linear maps plus the
QAM machinery that already exists:

* Vertical 2-band split: the letterbox picture is the anti-aliased
  ``L -> 3L/4`` windowed-sinc resample (one matmul per frame,
  :func:`frame.transcode.resample_lines`); the helper band is the residual
  ``Y - up(down(Y))``, which by construction occupies exactly the top
  quarter of the vertical spectrum ([3/8, 1/2] cycles/line).
* Critical decimation of the helper band: multiplying by ``(-1)^row``
  shifts that band to [0, 1/8] cycles/line, so the anti-aliased resample
  to ``L/4`` lines stores it losslessly — the modulated-decimation
  identity the real system's QMF vertical filter bank implements with
  hardware half-band filters.  The decoder runs the exact adjoint
  (upsample, re-multiply by ``(-1)^row``).
* Helper transport: DSB-SC on the colour subcarrier's U axis over the bar
  rows, using the same closed-form NCO phase law as the picture
  (modem/qam.carrier_phase) — product detection at the receiver is
  phase-exact with no extra state.  Horizontally band-limited so the
  upper sideband clears fs/2 (the real helper is band-limited too).
* Geometry: ``L_pic = 3L/4`` picture rows centered, ``L/8``-row bars on
  each side, ``L/4`` helper lines = exactly the helper band's critical
  rate.  (The real system uses 430 picture + 2x72 helper lines on 574
  usable; the clean power-of-two-friendly 432/72/72 split keeps every
  resample matrix exact and is within 0.5 % of the broadcast geometry.)

Deliberate simplifications, documented: no "Colorplus" motion-adaptive
chroma processing (the picture path is the framework's ordinary PAL
encode/decode at full quality), no film/camera mode switching, and the
helper rides linearly (the real system companded it against noise).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.dsp import design
from color_modem_tpu.dsp.apply import fir_same
from color_modem_tpu.dsp.colorimetry import apply_mat3, clamp01
from color_modem_tpu.frame.pipeline import (
    decode_block,
    encode_block,
    frame_line_index,
)
from color_modem_tpu.frame.transcode import resample_lines
from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.modem.qam import carrier_phase
from color_modem_tpu.standards.base import QamParams

#: helper sidebands must clear both the luma band below and fs/2 above;
#: 2 MHz double-sideband around fsc fits every QAM plan this framework
#: ships (PAL at 13.5 MHz: 4.43 + 2.0 < 6.75)
HELPER_BW_HZ = 2.0e6
#: transmitted helper excursion clip — keeps the bars within the normal
#: chroma excursion range so a conventional receiver's bars stay dark
HELPER_CLIP = 0.5


class PalPlusGeometry:
    """Row layout: ``bar`` rows, ``l_pic`` picture rows, ``bar`` rows."""

    def __init__(self, active_lines: int):
        if active_lines % 8:
            raise ValueError(
                f"PALplus needs active_lines divisible by 8, got {active_lines}"
            )
        self.l_full = active_lines
        self.l_pic = 3 * active_lines // 4
        self.bar = active_lines // 8
        self.l_helper = active_lines // 4  # == 2 * bar


def _check_plan(plan: ModemPlan, n_lines: int) -> PalPlusGeometry:
    if not isinstance(plan.cfg.chroma, QamParams):
        raise ValueError(
            "PALplus helper transport needs a QAM subcarrier; "
            f"{plan.cfg.name} is FM"
        )
    # geometry follows the FRAME actually given (tests use short frames),
    # proportioned like the full raster
    return PalPlusGeometry(n_lines)


def _row_sign(l_full: int) -> np.ndarray:
    """(-1)^row column vector — the vertical-band shift to/from baseband."""
    return np.where(np.arange(l_full) % 2 == 0, 1.0, -1.0).astype(
        np.float32
    )[:, None]


def _helper_taps(plan: ModemPlan) -> np.ndarray:
    p: QamParams = plan.cfg.chroma
    bw = min(HELPER_BW_HZ, 0.95 * (plan.fs / 2.0 - p.fsc), 0.95 * p.fsc)
    return design.lowpass_taps(plan.fs, bw, 129)


def _split_rows(geo: PalPlusGeometry, x: jax.Array):
    """(..., L, N) -> picture rows, bar rows (top then bottom stacked)."""
    pic = x[..., geo.bar : geo.bar + geo.l_pic, :]
    bars = jnp.concatenate(
        [x[..., : geo.bar, :], x[..., geo.bar + geo.l_pic :, :]], axis=-2
    )
    return pic, bars


def _split_g(geo: PalPlusGeometry, g: jax.Array):
    g_pic = g[..., geo.bar : geo.bar + geo.l_pic]
    g_bars = jnp.concatenate(
        [g[..., : geo.bar], g[..., geo.bar + geo.l_pic :]], axis=-1
    )
    return g_pic, g_bars


def helper_encode(geo: PalPlusGeometry, y_full: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Full-height luma (..., L, N) -> (letterbox Y (..., 3L/4, N),
    critically-decimated helper (..., L/4, N))."""
    down = resample_lines(y_full, geo.l_pic)
    up = resample_lines(down, geo.l_full)
    residual = y_full - up  # vertical band [3/8, 1/2) cycles/line
    shifted = jnp.asarray(_row_sign(geo.l_full)) * residual
    return down, resample_lines(shifted, geo.l_helper)


def helper_reconstruct(
    geo: PalPlusGeometry, y_pic: jax.Array, helper: jax.Array
) -> jax.Array:
    """Adjoint of :func:`helper_encode`: letterboxed picture luma +
    decoded helper lines -> full-height luma."""
    up = resample_lines(y_pic, geo.l_full)
    shifted = resample_lines(helper, geo.l_full)
    return up + jnp.asarray(_row_sign(geo.l_full)) * shifted


def encode_palplus(
    plan: ModemPlan,
    rgb: jax.Array,
    gline: jax.Array,
    helper_gain: float = 1.0,
) -> jax.Array:
    """(..., 3, L, N) full-height 16:9 RGB -> (..., L, N) letterbox
    composite with the helper in the bars.  ``gline`` covers all L rows."""
    geo = _check_plan(plan, rgb.shape[-2])
    rgb = rgb.astype(jnp.float32)
    ycc = apply_mat3(plan.rgb_to_ycc, rgb)
    _, helper = helper_encode(geo, ycc[..., 0, :, :])
    helper = fir_same(helper, _helper_taps(plan))

    rgb_pic = clamp01(resample_lines(rgb, geo.l_pic))
    g_pic, g_bars = _split_g(geo, gline)
    comp_pic = encode_block(plan, rgb_pic, g_pic)

    phi = carrier_phase(plan, g_bars)
    bars = jnp.clip(
        jnp.float32(helper_gain) * helper * jnp.sin(phi),
        -HELPER_CLIP,
        HELPER_CLIP,
    )
    return jnp.concatenate(
        [bars[..., : geo.bar, :], comp_pic, bars[..., geo.bar :, :]],
        axis=-2,
    )


def decode_palplus(
    plan: ModemPlan,
    comp: jax.Array,
    gline: jax.Array,
    decoder: str = "comb3",
    helper_gain: float = 1.0,
    use_helper: bool = True,
) -> jax.Array:
    """(..., L, N) letterbox composite -> (..., 3, L, N) reconstructed
    full-height 16:9 RGB.  ``use_helper=False`` is the conventional-TV
    control: upsample the letterbox and ignore the bars (what a 4:3 zoom
    does), isolating exactly what the helper buys."""
    geo = _check_plan(plan, comp.shape[-2])
    comp = comp.astype(jnp.float32)
    pic, bars = _split_rows(geo, comp)
    g_pic, g_bars = _split_g(geo, gline)

    rgb_pic = decode_block(plan, pic, g_pic, decoder)
    up = resample_lines(rgb_pic, geo.l_full)
    if not use_helper:
        return clamp01(up)

    phi = carrier_phase(plan, g_bars)
    helper = fir_same(2.0 * bars * jnp.sin(phi), _helper_taps(plan))
    helper = helper / jnp.float32(helper_gain)

    # resampling and the 3x3 matrices are linear and commute, so adding
    # the reconstructed helper band to the UPSAMPLED luma plane equals
    # helper_reconstruct() on the picture-rows luma
    ycc = apply_mat3(plan.rgb_to_ycc, up)
    y = ycc[..., 0, :, :] + jnp.asarray(
        _row_sign(geo.l_full)
    ) * resample_lines(helper, geo.l_full)
    ycc = jnp.stack([y, ycc[..., 1, :, :], ycc[..., 2, :, :]], axis=-3)
    return clamp01(apply_mat3(plan.ycc_to_rgb, ycc))


def make_palplus_pipeline(
    plan: ModemPlan,
    decoder: str = "comb3",
    helper_gain: float = 1.0,
    raster: bool = False,
):
    """Jitted ``(encode, decode, roundtrip)`` closures, batch-first like
    :func:`frame.pipeline.make_pipeline`.  Frame height comes from the
    input (must be divisible by 8; geometry proportions like the full
    raster).

    ``raster``: sync + burst in each line's blanking interval
    (frame/raster.py) — the bars carry normal sync/burst like the real
    PALplus raster did; ``encode`` then returns ``(..., L, n_total)``
    rows and ``decode`` strips the blanking first.  ``roundtrip`` skips
    the raster (strip(add(x)) == x exactly, as in pipeline.py)."""
    _check_plan(plan, plan.cfg.active_lines)
    rp = None
    if raster:
        from color_modem_tpu.frame.raster import (
            add_raster, make_raster, strip_raster,
        )

        rp = make_raster(plan)

    @jax.jit
    def encode(rgb, frame0=0):
        b, _, l, _ = rgb.shape
        g = frame_line_index(plan, frame0, b, l)
        comp = encode_palplus(plan, rgb, g, helper_gain)
        if rp is not None:
            comp = add_raster(plan, rp, comp, g)
        return comp

    @partial(jax.jit, static_argnames=("use_helper",))
    def decode(comp, frame0=0, use_helper=True):
        if rp is not None:
            comp = strip_raster(rp, comp)
        b, l = comp.shape[0], comp.shape[-2]
        g = frame_line_index(plan, frame0, b, l)
        return decode_palplus(
            plan, comp, g, decoder, helper_gain, use_helper
        )

    @partial(jax.jit, static_argnames=("use_helper",))
    def roundtrip(rgb, frame0=0, use_helper=True):
        b, _, l, _ = rgb.shape
        g = frame_line_index(plan, frame0, b, l)
        comp = encode_palplus(plan, rgb, g, helper_gain)
        return decode_palplus(
            plan, comp, g, decoder, helper_gain, use_helper
        )

    return encode, decode, roundtrip


# --- interlaced PALplus (625i service, VERDICT r4 item 2) -------------------


def _check_interlaced(plan: ModemPlan, n_lines: int) -> PalPlusGeometry:
    geo = _check_plan(plan, n_lines)
    if n_lines % 16:
        # bar = L/8 must be EVEN so each field carries bar/2 top and bar/2
        # bottom bar rows (the broadcast 576: bar = 72, 36 rows per field)
        raise ValueError(
            f"interlaced PALplus needs lines divisible by 16, got {n_lines}"
        )
    return geo


def encode_palplus_fields(
    plan: ModemPlan,
    rgb: jax.Array,
    frame0,
    helper_gain: float = 1.0,
) -> jax.Array:
    """(B, 3, L, N) full-height 16:9 RGB frames -> (2B, L/2, N)
    field-sequential PALplus composite.

    The vertical filter bank runs FRAME-based (the real system's Film
    Mode — PALplus processed whole frames when the source was film, which
    is exactly this framework's progressive-source model); transmission is
    field-sequential: frame row ``j`` goes to field ``j % 2``, so each
    field carries ``3L/8`` letterbox picture rows between ``bar/2``-row
    bars, and the helper lines split alternately across the field pair —
    one helper reference per FIELD (L=576: 216 picture + 72 helper lines
    per field, the broadcast 430+2x72 split scaled to the clean
    power-of-two geometry, module docstring).  Every transmitted row is
    keyed by its FIELD line index (frame/interlace.py), so the subcarrier
    phase law, V-switch and the helper's carrier all follow transmission
    order, and a conventional interlaced receiver sees a normal letterbox
    broadcast."""
    from color_modem_tpu.frame.interlace import (
        field_line_index, split_fields,
    )

    b, _, l, _ = rgb.shape
    geo = _check_interlaced(plan, l)
    rgb = rgb.astype(jnp.float32)
    ycc = apply_mat3(plan.rgb_to_ycc, rgb)
    _, helper = helper_encode(geo, ycc[..., 0, :, :])
    helper = fir_same(helper, _helper_taps(plan))
    rgb_pic = clamp01(resample_lines(rgb, geo.l_pic))

    # full-height frame-row planes: picture rows in place, helper line h on
    # its bar row (top bars carry h < bar, bottom bars h >= bar); the zero
    # rows of each plane are the other plane's rows
    n = rgb.shape[-1]
    zb = jnp.zeros(rgb.shape[:-3] + (3, geo.bar, n), jnp.float32)
    rgb_full = jnp.concatenate([zb, rgb_pic, zb], axis=-2)
    zp = jnp.zeros(helper.shape[:-2] + (geo.l_pic, n), jnp.float32)
    hlp_full = jnp.concatenate(
        [helper[..., : geo.bar, :], zp, helper[..., geo.bar :, :]], axis=-2
    )

    rgb_f = split_fields(rgb_full)                      # (2B, 3, L/2, N)
    hlp_f = split_fields(hlp_full)                      # (2B, L/2, N)
    g = field_line_index(plan, frame0, b, l // 2)
    comp = encode_block(plan, rgb_f, g)
    # the bar rows carry ONLY the helper DSB (the progressive layout,
    # encode_palplus): mask the encoded black rows out rather than trust
    # encode(black) == 0, then add the clipped helper (which is zero on
    # pic rows because hlp_full is)
    hb, pr = geo.bar // 2, geo.l_pic // 2
    row = jnp.arange(l // 2)
    is_bar = (row < hb) | (row >= hb + pr)
    phi = carrier_phase(plan, g)
    bars = jnp.clip(
        jnp.float32(helper_gain) * hlp_f * jnp.sin(phi),
        -HELPER_CLIP, HELPER_CLIP,
    )
    return jnp.where(is_bar[:, None], 0.0, comp) + bars


def decode_palplus_fields(
    plan: ModemPlan,
    comp_fields: jax.Array,
    frame0,
    decoder: str = "comb3",
    helper_gain: float = 1.0,
    use_helper: bool = True,
) -> jax.Array:
    """(2B, L/2, N) field-sequential PALplus composite -> (B, 3, L, N)
    reconstructed full-height frames (inverse of
    :func:`encode_palplus_fields`; ``use_helper=False`` is the
    conventional-receiver zoom control, as in :func:`decode_palplus`)."""
    from color_modem_tpu.frame.interlace import (
        field_line_index, weave_fields,
    )

    b2, rows, n = comp_fields.shape[0], comp_fields.shape[-2], \
        comp_fields.shape[-1]
    l = 2 * rows
    geo = _check_interlaced(plan, l)
    comp_fields = comp_fields.astype(jnp.float32)
    g = field_line_index(plan, frame0, b2 // 2, rows)
    hb, pr = geo.bar // 2, geo.l_pic // 2

    # picture: decode the pic rows ONLY (so the comb stencils reflect
    # inside the picture instead of combing helper bars), weave fields
    pic_f = comp_fields[..., hb : hb + pr, :]
    rgb_pic = weave_fields(
        decode_block(plan, pic_f, g[..., hb : hb + pr], decoder)
    )                                                   # (B, 3, 3L/4, N)
    up = resample_lines(rgb_pic, geo.l_full)
    if not use_helper:
        return clamp01(up)

    # helper: product-detect each field's bar rows, weave the field pair
    # back into the progressive helper line order (frame bar row j lives
    # in field j % 2 — exactly the weave)
    bars_f = jnp.concatenate(
        [comp_fields[..., :hb, :], comp_fields[..., hb + pr :, :]], axis=-2
    )
    g_bars = jnp.concatenate([g[..., :hb], g[..., hb + pr :]], axis=-1)
    phi = carrier_phase(plan, g_bars)
    helper_f = fir_same(2.0 * bars_f * jnp.sin(phi), _helper_taps(plan))
    helper_f = helper_f / jnp.float32(helper_gain)      # (2B, bar, N)
    helper = jnp.concatenate(
        [weave_fields(helper_f[..., :hb, :]),
         weave_fields(helper_f[..., hb:, :])], axis=-2
    )                                                   # (B, L/4, N)

    ycc = apply_mat3(plan.rgb_to_ycc, up)
    y = ycc[..., 0, :, :] + jnp.asarray(
        _row_sign(geo.l_full)
    ) * resample_lines(helper, geo.l_full)
    ycc = jnp.stack([y, ycc[..., 1, :, :], ycc[..., 2, :, :]], axis=-3)
    return clamp01(apply_mat3(plan.ycc_to_rgb, ycc))


def make_interlaced_palplus_pipeline(
    plan: ModemPlan,
    decoder: str = "comb3",
    helper_gain: float = 1.0,
    raster: bool = False,
):
    """Jitted ``(encode, decode, roundtrip)`` for the interlaced PALplus
    service: ``encode (B,3,L,N) -> (2B, L/2, N)`` field-sequential
    composite (rastered rows when ``raster``), ``decode`` reconstructs
    full-height frames.  The composition endpoint of VERDICT r4 item 2 —
    PALplus was a 625i service broadcast over terrestrial RF, and the
    field composite this returns feeds frame/rf.py like any other."""
    from color_modem_tpu.frame.interlace import field_line_index

    _check_interlaced(plan, plan.cfg.active_lines)
    rp = None
    if raster:
        from color_modem_tpu.frame.raster import (
            add_raster, make_raster, strip_raster,
        )

        rp = make_raster(plan)

    @jax.jit
    def encode(rgb, frame0=0):
        comp = encode_palplus_fields(
            plan, rgb, frame0, helper_gain
        )
        if rp is not None:
            g = field_line_index(
                plan, frame0, rgb.shape[0], rgb.shape[-2] // 2
            )
            comp = add_raster(plan, rp, comp, g)
        return comp

    @partial(jax.jit, static_argnames=("use_helper",))
    def decode(comp_fields, frame0=0, use_helper=True):
        if rp is not None:
            comp_fields = strip_raster(rp, comp_fields)
        return decode_palplus_fields(
            plan, comp_fields, frame0, decoder, helper_gain,
            use_helper,
        )

    @partial(jax.jit, static_argnames=("use_helper",))
    def roundtrip(rgb, frame0=0, use_helper=True):
        comp = encode_palplus_fields(
            plan, rgb, frame0, helper_gain
        )
        return decode_palplus_fields(
            plan, comp, frame0, decoder, helper_gain, use_helper
        )

    return encode, decode, roundtrip
