"""Golden round-trip tests (SURVEY.md §4.3 'Golden round-trip', K14).

Two kinds of bound per (standard, decoder):

* **parity**: the JAX pipeline must match the frozen float64 golden oracle to
  >= 60 dB PSNR — loose enough for any float32 backend (measured: ~150 dB on
  CPU), tight enough to catch any algorithmic divergence.
* **round-trip**: decoded-vs-input PSNR must meet the recorded threshold
  (measured values minus ~1.5 dB margin; recorded 2026-08-16 on the 64x720
  smooth_scene fixture).  chip_smoke.py holds the card to the same bounds.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from conftest import TEST_SAMPLES, get_plan
from color_modem_tpu import golden
from color_modem_tpu.frame.pipeline import make_pipeline
from color_modem_tpu.utils.metrics import psnr

# (standard, decoder) -> minimum round-trip PSNR in dB
ROUNDTRIP_BOUNDS = {
    ("ntsc", "notch"): 37.5,
    ("ntsc", "comb2"): 36.0,
    ("ntsc", "comb3"): 43.5,
    ("ntsc", "delayline"): 36.0,
    ("ntsc", "avg"): 36.0,
    ("pal", "notch"): 38.0,
    ("pal", "comb2"): 29.5,
    ("pal", "comb3"): 30.0,
    ("pal", "delayline"): 36.0,
    ("pal", "avg"): 36.0,
    # SECAM raised 2026-08-17 (round 2): held-edge baseband filters +
    # midpoint-rule FM integral + blanking-margin reconstruction took the
    # measured notch round-trip from 32.8 to 35.1 dB; 'interp' pairing
    # (both-neighbor average) measures 38.5 dB.
    ("secam", "notch"): 33.5,
    ("secam", "avg"): 31.5,
    ("secam", "interp"): 37.0,
    ("niir", "notch"): 33.0,
}

PARITY_BOUND = 60.0


@pytest.fixture(scope="module")
def batches(scene):
    return scene[None]  # (1, 3, L, N)


@pytest.mark.parametrize(
    "name,decoder", sorted(ROUNDTRIP_BOUNDS), ids=lambda v: str(v)
)
def test_roundtrip_and_parity(name, decoder, batches):
    plan = get_plan(name)
    enc, dec, _ = make_pipeline(plan, decoder)
    comp_j = np.asarray(enc(batches))
    rgb_j = np.asarray(dec(jnp.asarray(comp_j)))

    comp_g = golden.encode_frame(plan, batches[0], frame=0)
    rgb_g = golden.decode_frame(plan, comp_j[0], frame=0, decoder=decoder)

    p_enc = psnr(comp_j[0], comp_g)
    p_dec = psnr(rgb_j[0], rgb_g)
    assert p_enc >= PARITY_BOUND, f"encode parity {p_enc:.1f} dB"
    assert p_dec >= PARITY_BOUND, f"decode parity {p_dec:.1f} dB"

    p_rt = psnr(rgb_j[0], np.asarray(batches[0]))
    bound = ROUNDTRIP_BOUNDS[(name, decoder)]
    assert p_rt >= bound, f"round-trip {p_rt:.1f} dB < {bound} dB"


def _variant_pairs():
    """Every (standard, allowed decoder) pair NOT already bounded above."""
    from color_modem_tpu.standards import ALL_STANDARDS
    from color_modem_tpu.standards.decoders import allowed_decoders

    return sorted(
        (name, dec)
        for name, factory in ALL_STANDARDS.items()
        for dec in allowed_decoders(factory())
        # the temporal combs are meaningless on this single-frame fixture
        # and beyond the per-frame golden oracle — tests/test_comb3d.py
        if (name, dec) not in ROUNDTRIP_BOUNDS
        and dec not in ("comb3d", "comb3dA")
    )


@pytest.mark.parametrize("name,decoder", _variant_pairs(), ids=str)
def test_every_allowed_pair_roundtrips(name, decoder):
    """Catch-all floor: no (standard, decoder) the registry offers may
    silently rot — golden parity and a conservative round-trip bound."""
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = make_plan(ALL_STANDARDS[name](), TEST_SAMPLES)
    img = smooth_scene(32, TEST_SAMPLES, seed=11).astype(np.float32)[None]
    enc, dec, _ = make_pipeline(plan, decoder)
    comp = np.asarray(enc(jnp.asarray(img)))
    assert psnr(comp[0], golden.encode_frame(plan, img[0], frame=0)) >= 60.0
    out = np.asarray(dec(jnp.asarray(comp)))
    rgb_g = golden.decode_frame(plan, comp[0], frame=0, decoder=decoder)
    assert psnr(out[0], rgb_g) >= 60.0, "decode parity vs golden"
    p = psnr(out[0], img[0])
    assert p >= 25.0, f"{name}/{decoder}: {p:.1f} dB"


# (standard, temporal decoder) -> minimum STATIC-scene round-trip PSNR.
# Measured 2026-08-17 (41.6-43.7 dB on the 4-frame static 32x720 fixture;
# the taller 48-line fixture reads ~46 dB — edge lines weigh more here)
# minus ~1.5 dB margin.  Golden oracle: decode_sequence (multi-frame).
TEMPORAL_BOUNDS = {
    ("ntsc", "comb3d"): 40.0,
    ("ntsc", "comb3dA"): 40.0,
    ("pal", "comb3d"): 42.0,
    ("pal", "comb3dA"): 41.5,
}


@pytest.mark.parametrize(
    "name,decoder", sorted(TEMPORAL_BOUNDS), ids=lambda v: str(v)
)
def test_temporal_roundtrip_and_parity(name, decoder):
    """Temporal combs vs the multi-frame golden oracle (VERDICT r1 item 6):
    golden.decode_sequence mirrors the frame-axis stencils per-scanline, so
    the temporal decoders get the same >=60 dB parity bar as every other
    (standard, decoder) pair — plus the static-scene round-trip bound that
    is their reason to exist."""
    from color_modem_tpu.standards.decoders import temporal_comb_spacing
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = get_plan(name)
    pt = temporal_comb_spacing(plan.cfg)
    f = max(4, 2 * pt)
    one = smooth_scene(32, TEST_SAMPLES, seed=7).astype(np.float32)
    batch = np.broadcast_to(one, (f,) + one.shape).copy()
    enc, dec, _ = make_pipeline(plan, decoder)
    comp = np.asarray(enc(jnp.asarray(batch), 0))
    out = np.asarray(dec(jnp.asarray(comp), 0))
    rgb_g = golden.decode_sequence(plan, comp, frame0=0, decoder=decoder)
    p_par = psnr(out, rgb_g)
    assert p_par >= PARITY_BOUND, f"decode parity {p_par:.1f} dB"
    p_rt = psnr(out, batch)
    bound = TEMPORAL_BOUNDS[(name, decoder)]
    assert p_rt >= bound, f"round-trip {p_rt:.1f} dB < {bound} dB"


def test_secam_quality_width_1440(scene):
    """The 27 MHz / 1440-sample SECAM configuration (VERDICT r1 item 1).

    Filter tap counts scale with fs (modem/plan.REF_FS), so the wide
    configuration holds the same accuracy as 720 (without scaling it
    measured 3 dB WORSE: same taps at 2x fs halve every filter's time
    span).  Measured 2026-08-17: notch 35.0 dB, interp 38.3 dB on this
    fixture resampled to 1440 — enforce with the usual ~1.5 dB margin,
    plus golden parity at the scaled margin/tap geometry."""
    from color_modem_tpu.dsp.resample import resample_width
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import SECAM

    plan = make_plan(SECAM(), 1440)
    img = np.asarray(resample_width(jnp.asarray(scene[None]), 1440))
    for decoder, bound in (("notch", 33.5), ("interp", 37.0)):
        enc, dec, _ = make_pipeline(plan, decoder)
        comp = np.asarray(enc(jnp.asarray(img), 0))
        out = np.asarray(dec(jnp.asarray(comp), 0))
        g = golden.decode_frame(plan, comp[0], frame=0, decoder=decoder)
        assert psnr(out[0], g) >= PARITY_BOUND
        p = psnr(out[0], img[0])
        assert p >= bound, f"1440/{decoder}: {p:.1f} dB < {bound}"


def test_batched_encode_matches_per_frame(scene):
    """Frame batching must reproduce per-frame encodes with the right
    frame phase sequence (NTSC 4-field cycle etc.)."""
    plan = get_plan("ntsc")
    enc, _, _ = make_pipeline(plan, "notch")
    batch = np.stack([scene, scene[:, ::-1, :]])
    comp_b = np.asarray(enc(batch, 3))
    for b in range(2):
        comp_1 = np.asarray(enc(batch[b : b + 1], 3 + b))
        assert np.allclose(comp_b[b], comp_1[0], atol=1e-6)


def test_decoder_validation():
    plan = get_plan("secam")
    with pytest.raises(ValueError):
        make_pipeline(plan, "comb2")
    with pytest.raises(ValueError):
        make_pipeline(get_plan("ntsc"), "nonsense")


@pytest.mark.parametrize("name", ["ntsc", "pal"])
def test_adaptive_comb_beats_fixed_on_vertical_transitions(name):
    """The point of combA: a fixed comb averages ACROSS a vertical color
    transition (hue smear at the edge); the adaptive comb takes the
    matching neighbor.  On smooth content it must not regress."""
    import jax.numpy as jnp

    from color_modem_tpu.utils.testimages import smooth_scene

    plan = get_plan(name)
    # two saturated color fields stacked: one hard horizontal edge
    L = 32
    img = np.empty((1, 3, L, TEST_SAMPLES), np.float32)
    img[:, :, : L // 2] = np.asarray([0.65, 0.25, 0.25])[:, None, None]
    img[:, :, L // 2:] = np.asarray([0.25, 0.25, 0.65])[:, None, None]
    _, _, rt_f = make_pipeline(plan, "comb3")
    _, _, rt_a = make_pipeline(plan, "combA")
    p_f = psnr(np.asarray(rt_f(jnp.asarray(img), 0)), img)
    p_a = psnr(np.asarray(rt_a(jnp.asarray(img), 0)), img)
    # measured: NTSC 39.7 vs 31.0, i.e. ~+8 dB at the transition
    assert p_a > p_f + 3.0, (name, p_f, p_a)

    smooth = smooth_scene(L, TEST_SAMPLES, seed=23).astype(np.float32)[None]
    s_f = psnr(np.asarray(rt_f(jnp.asarray(smooth), 0)), smooth)
    s_a = psnr(np.asarray(rt_a(jnp.asarray(smooth), 0)), smooth)
    assert s_a > s_f - 0.5, (name, s_f, s_a)


def test_card_pattern_roundtrip():
    """The broadcast test card (utils/testimages.test_card): well-formed
    at any raster, and its multiburst band makes the comb-vs-notch gap
    directly visible (the finest gratings land where a notch decoder
    confuses luma with chroma)."""
    from color_modem_tpu.utils.testimages import test_card

    img = test_card(64, TEST_SAMPLES).astype(np.float32)
    assert img.shape == (3, 64, TEST_SAMPLES)
    assert 0.0 <= img.min() and img.max() <= 1.0
    assert test_card(480, 1440).shape == (3, 480, 1440)

    plan = get_plan("ntsc")
    _, _, rt_n = make_pipeline(plan, "notch")
    _, _, rt_c = make_pipeline(plan, "comb3")
    x = jnp.asarray(img)[None]
    p_n = psnr(np.asarray(rt_n(x, 0)), img[None])
    p_c = psnr(np.asarray(rt_c(x, 0)), img[None])
    # measured: comb3 beats notch by several dB on the card's gratings
    assert p_c > p_n + 1.0, (p_n, p_c)


def test_zone_plate_cross_color():
    """Zone plate (pure luma): the ring where horizontal frequency
    crosses the chroma band makes a notch decoder hallucinate chroma
    (cross-color rainbows); the comb suppresses most of it."""
    from color_modem_tpu.utils.testimages import zone_plate

    img = zone_plate(64, TEST_SAMPLES).astype(np.float32)
    plan = get_plan("ntsc")
    x = jnp.asarray(img)[None]

    def chroma_energy(decoder):
        _, _, rt = make_pipeline(plan, decoder)
        out = np.asarray(rt(x, 0))[0]
        # input is gray: any R-B spread is hallucinated color
        return float(np.mean((out[0] - out[2]) ** 2))

    e_notch = chroma_energy("notch")
    e_comb = chroma_energy("comb3")
    # measured 0.114 vs 0.046: the comb wins ~2.5x, not more, because the
    # plate also sweeps VERTICAL frequency — where adjacent lines
    # decorrelate, the comb hallucinates too (authentic: zone plates make
    # every separator fail somewhere, that is their job)
    assert e_notch > 2.0 * e_comb, (e_notch, e_comb)


def test_smpte_bars_pattern():
    """SMPTE engineering bars (utils/testimages.smpte_bars): well-formed,
    and the blue-only strip really is blue-only — the hue-setup property
    the strip exists for (its blue plane matches the bars band's blue
    where lit, its red/green planes are black)."""
    from color_modem_tpu.utils.testimages import smpte_bars

    img = smpte_bars(480, TEST_SAMPLES)
    assert img.shape == (3, 480, TEST_SAMPLES)
    assert 0.0 <= img.min() and img.max() <= 1.0
    b1, b2 = int(0.67 * 480), int(0.75 * 480)
    strip = img[:, b1:b2]
    assert strip[0].max() == 0.0 and strip[1].max() == 0.0
    assert strip[2].max() == 0.75
    # PLUGE band: white reference and the +4% brightness patch present
    pluge = img[:, b2:]
    assert pluge.max() == 1.0
    assert np.any(np.isclose(pluge, 0.115))


def test_secam_avg_floor_is_pairing_physics():
    """VERDICT r2 'weak' #4: is SECAM avg's ~4 dB deficit vs QAM avg FM
    physics or fixable pairing loss?  Answer (measured 2026-08-19): on a
    scene with ZERO vertical color variation — where line-sequential
    pairing loses nothing by construction — notch, avg and interp
    converge to the SAME 34.9 dB: avg's whole deficit on natural scenes
    is the vertical chroma smear its neighbor-borrowing implies (the
    standard's halved vertical chroma rate, not an implementation bug),
    and the residual ~2.7 dB to QAM on the same content is the FM-chain
    floor every SECAM decoder shares.  'interp' is already the repaired
    pairing (38.5 dB on natural scenes)."""
    import jax.numpy as jnp

    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.utils.metrics import psnr
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = get_plan("secam")
    scene = smooth_scene(64, TEST_SAMPLES, seed=1).astype(np.float32)
    flat_v = np.broadcast_to(
        scene[:, 32:33, :], scene.shape
    ).astype(np.float32).copy()
    scores = {}
    for dec in ("notch", "avg", "interp"):
        enc, de, _ = make_pipeline(plan, dec)
        out = np.asarray(de(enc(jnp.asarray(flat_v)[None], 0), 0))[0]
        scores[dec] = float(psnr(jnp.asarray(out), jnp.asarray(flat_v)))
    assert abs(scores["avg"] - scores["notch"]) < 0.1, scores
    assert abs(scores["interp"] - scores["notch"]) < 0.1, scores
    assert scores["notch"] > 33.0, scores
