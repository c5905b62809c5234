"""Sharding equivalence tests on the fake 8-device CPU mesh (SURVEY.md §4.3).

Sharded (shard_map over (frame, lineblk)) must equal unsharded — BIT-for-bit
on the QAM paths, to 1e-6 on SECAM (its larger decode matmul chain picks up
shape-dependent fp scheduling, measured <=4e-7) — the only reliable detector
for halo off-by-one errors (SURVEY.md §7.3 item 3).  Includes the
fault-injection test of §5.3: a corrupted halo must make the equivalence
check fail, proving the tests would catch a broken exchange.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from conftest import TEST_SAMPLES, get_plan
from color_modem_tpu.frame.pipeline import make_pipeline
from color_modem_tpu.parallel import (
    halo_extend,
    make_mesh,
    make_sharded_pipeline,
    required_halo,
)
from color_modem_tpu.utils.testimages import smooth_scene

L, N, B = 64, TEST_SAMPLES, 8

CASES = [
    ("ntsc", "notch"),
    ("ntsc", "comb2"),
    ("ntsc", "comb3"),
    ("pal", "comb3"),
    ("pal", "delayline"),
    ("secam", "notch"),
    ("niir", "notch"),
    # FM/NIIR chroma averaging: chained 1-line stencils -> halo 2 with the
    # 'copy' global-edge rule (parallel/halo.py)
    ("secam", "avg"),
    ("niir", "avg"),
    # interp pairing reads BOTH adjacent carrier lines: exercises the
    # next_reflect (bottom-edge) side of the halo, which nothing above does
    ("secam", "interp"),
]


@pytest.fixture(scope="module")
def batch():
    return np.stack(
        [smooth_scene(L, N, seed=s) for s in range(B)], dtype=np.float32
    )


def _meshes():
    n = len(jax.devices())
    assert n == 8, f"conftest should provide 8 cpu devices, got {n}"
    return [make_mesh(2, 4), make_mesh(4, 2), make_mesh(1, 8), make_mesh(8, 1)]


def _assert_equiv(got, want, name, msg):
    """QAM paths are BIT-identical sharded-vs-unsharded (measured); SECAM's
    decode is float-identical to ~4e-7 — the per-block shapes change XLA's
    fp scheduling inside its larger matmul chain."""
    if name == "secam":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("name,decoder", CASES, ids=str)
def test_sharded_equals_unsharded(name, decoder, batch):
    plan = get_plan(name)
    enc_u, dec_u, _ = make_pipeline(plan, decoder)
    comp_u = np.asarray(enc_u(batch, 5))
    rgb_u = np.asarray(dec_u(jnp.asarray(comp_u), 5))
    for mesh in _meshes():
        enc_s, dec_s, _ = make_sharded_pipeline(plan, mesh, decoder)
        comp_s = np.asarray(enc_s(batch, 5))
        _assert_equiv(comp_s, comp_u, name, f"encode {mesh.shape}")
        rgb_s = np.asarray(dec_s(jnp.asarray(comp_u), 5))
        _assert_equiv(rgb_s, rgb_u, name, f"decode {mesh.shape}")


def test_padded_then_cropped_equals_unsharded(batch):
    """pad_to_multiple on the line axis must not change real lines' values.

    The bottom real line's comb stencil reads the first padded line;
    reflect padding supplies exactly what the unsharded edge reflection
    reads.  (Edge padding used to desaturate the bottom line.)
    """
    from color_modem_tpu.parallel.mesh import pad_to_multiple

    plan = get_plan("ntsc")
    lines = 60  # not divisible by lineblk=8
    x = batch[:, :, :lines, :]
    _, dec_u, _ = make_pipeline(plan, "comb3")
    comp_u = np.asarray(make_pipeline(plan, "comb3")[0](x, 0))
    rgb_u = np.asarray(dec_u(jnp.asarray(comp_u), 0))
    mesh = make_mesh(1, 8)
    _, dec_s, _ = make_sharded_pipeline(plan, mesh, "comb3")
    comp_p, orig = pad_to_multiple(comp_u, axis=1, multiple=8)
    rgb_s = np.asarray(dec_s(jnp.asarray(comp_p), 0))[:, :, :orig, :]
    np.testing.assert_allclose(rgb_s, rgb_u, atol=1e-6, rtol=0)


def test_roundtrip_composes_sharded(batch):
    plan = get_plan("pal")
    mesh = make_mesh(2, 4)
    _, _, rt_s = make_sharded_pipeline(plan, mesh, "delayline")
    _, _, rt_u = make_pipeline(plan, "delayline")
    np.testing.assert_allclose(
        np.asarray(rt_s(batch)), np.asarray(rt_u(batch)), atol=1e-6
    )


def test_halo_extend_interior_and_edges():
    """Unit test of the exchange itself on a tiny array (SURVEY.md §5.8)."""
    mesh = make_mesh(1, 4)
    x = np.arange(16, dtype=np.float32).reshape(16, 1)  # 16 lines, 1 sample

    def blk(xb):
        return halo_extend(xb, 2, "lineblk")

    ext = jax.jit(
        jax.shard_map(
            blk, mesh=mesh, in_specs=P("lineblk", None),
            out_specs=P("lineblk", None),
        )
    )(x)
    ext = np.asarray(ext).reshape(4, 8)  # 4 blocks x (4 + 2*2) lines
    # block 0: reflected top [2,1], own [0..3], neighbor [4,5]
    assert ext[0].tolist() == [2, 1, 0, 1, 2, 3, 4, 5]
    # block 1: neighbor [2,3], own [4..7], neighbor [8,9]
    assert ext[1].tolist() == [2, 3, 4, 5, 6, 7, 8, 9]
    # block 3: neighbor [10,11], own [12..15], reflected bottom [14,13]
    assert ext[3].tolist() == [10, 11, 12, 13, 14, 15, 14, 13]


def test_corrupted_halo_is_detected(batch):
    """Fault injection (SURVEY.md §5.3): sabotage the halo and prove the
    equivalence test catches it."""
    plan = get_plan("ntsc")
    mesh = make_mesh(1, 8)
    _, dec_u, _ = make_pipeline(plan, "comb2")
    enc_u, _, _ = make_pipeline(plan, "comb2")
    comp = np.asarray(enc_u(batch[:1]))

    from color_modem_tpu.frame.pipeline import decode_block
    from color_modem_tpu.parallel.halo import crop_halo, halo_extend_lines
    from color_modem_tpu.parallel.sharded import _block_gline

    def bad_blk(comp_blk):
        b_blk, l_blk, _ = comp_blk.shape
        g = _block_gline(plan, 0, b_blk, l_blk)
        cext = halo_extend(comp_blk, 1, "lineblk")
        cext = cext.at[..., 0, :].mul(1.01)  # corrupt the received halo line
        gext = halo_extend_lines(g, 1, "lineblk")
        return crop_halo(decode_block(plan, cext, gext, "comb2"), 1)

    rgb_bad = jax.jit(
        jax.shard_map(
            bad_blk, mesh=mesh,
            in_specs=P(None, "lineblk", None),
            out_specs=P(None, None, "lineblk", None),
            # _block_gline reads axis_index("frame"), which marks the output
            # as varying over the (size-1) frame axis; skip the static check
            check_vma=False,
        )
    )(comp)
    rgb_ok = np.asarray(dec_u(jnp.asarray(comp)))
    assert not np.allclose(np.asarray(rgb_bad), rgb_ok, atol=1e-6)


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(3, 3)


def test_uneven_block_raises(batch):
    plan = get_plan("ntsc")
    mesh = make_mesh(1, 8)
    enc_s, _, _ = make_sharded_pipeline(plan, mesh, "notch")
    with pytest.raises(Exception):
        jax.block_until_ready(enc_s(batch[:, :, : L - 4, :]))  # 60 % 8 != 0


INTERLACED_CASES = [
    ("ntsc", "comb3"),
    ("pal", "delayline"),
    ("secam", "notch"),
    ("secam", "avg"),
    ("ntsc", "comb3d"),
    ("ntsc", "comb3dA"),
]


@pytest.mark.parametrize("name,decoder", INTERLACED_CASES, ids=str)
def test_sharded_interlaced_equals_unsharded(name, decoder, batch):
    """Sharded interlaced (fields DP over frames x CP over field-row
    blocks) vs the single-device interlaced pipeline — the two flagship
    features (interlace, sharding) composing (VERDICT r1 item 5).

    Same bit/1e-6 bar as the progressive rows; the temporal combs need
    >= 2*spacing frames per device, so they skip factorings whose frame
    blocks are too small.
    """
    from color_modem_tpu.frame.interlace import make_interlaced_pipeline
    from color_modem_tpu.parallel import make_sharded_interlaced_pipeline
    from color_modem_tpu.standards.decoders import temporal_comb_spacing

    plan = get_plan(name)
    enc_u, dec_u, _ = make_interlaced_pipeline(plan, decoder)
    comp_u = np.asarray(enc_u(batch, 5))
    rgb_u = np.asarray(dec_u(jnp.asarray(comp_u), 5))
    temporal = decoder in ("comb3d", "comb3dA")
    pt = temporal_comb_spacing(plan.cfg) if temporal else 0
    ran = 0
    for mesh in _meshes():
        fr = mesh.devices.shape[0]
        if temporal and B // fr < 2 * pt:
            continue
        enc_s, dec_s, _ = make_sharded_interlaced_pipeline(plan, mesh, decoder)
        comp_s = np.asarray(enc_s(batch, 5))
        _assert_equiv(comp_s, comp_u, name, f"interlaced encode {mesh.shape}")
        rgb_s = np.asarray(dec_s(jnp.asarray(comp_u), 5))
        _assert_equiv(rgb_s, rgb_u, name, f"interlaced decode {mesh.shape}")
        ran += 1
    assert ran >= 3, "mesh skip logic left too few factorings"


def test_sharded_rf_hop_equals_unsharded(batch):
    """Transmission hop sharding (round 3): the RF hop is frame-local on
    the JOINED row stream, so it shards DP over frames only; the spec
    change at the stage boundary makes XLA re-gather the line axis.  The
    full enc -> hop -> dec chain must stay bit-identical to unsharded on
    QAM, at both the pure-DP and the line-split mesh extremes."""
    from color_modem_tpu.frame.rf import make_rf_plan, rf_roundtrip
    from color_modem_tpu.parallel.sharded import make_sharded_hop_pipeline

    plan = get_plan("ntsc")
    rfp = make_rf_plan(plan)
    hop = lambda c, f0: rf_roundtrip(rfp, c, f0)  # noqa: E731
    enc_u, dec_u, _ = make_pipeline(plan, "comb3")
    want = np.asarray(dec_u(hop(enc_u(jnp.asarray(batch), 5), 5), 5))
    for mesh in (make_mesh(2, 4), make_mesh(1, 8)):
        _, _, rt_s = make_sharded_hop_pipeline(plan, mesh, hop, "comb3")
        got = np.asarray(rt_s(jnp.asarray(batch), 5))
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0,
                                   err_msg=str(mesh.shape))
    # non-divisible batch (4 frames on the 8-device grid): exercises the
    # hop_frame FALLBACK branch — frame-axis-only hop sharding with the
    # line-group devices replicating the hop compute (round-3 advisor
    # finding: the fallback had no coverage; every other case divides)
    small = batch[:4]
    want4 = np.asarray(dec_u(hop(enc_u(jnp.asarray(small), 5), 5), 5))
    _, _, rt_s = make_sharded_hop_pipeline(plan, make_mesh(2, 4), hop, "comb3")
    got4 = np.asarray(rt_s(jnp.asarray(small), 5))
    np.testing.assert_allclose(got4, want4, atol=2e-6, rtol=0,
                               err_msg="hop_frame fallback (batch 4 on 2x4)")


def test_sharded_rf_sound_equals_unsharded(batch):
    """The last video-only gap (VERDICT r4 item 1): the RF hop CARRYING the
    joined-stream FM sound under the DP x CP mesh.  The sound carrier's
    deviation integral crosses the batch (one cumsum over the joined
    frames, frame/rf.py::sound_on_rf) — per-device integration would
    restart the carrier at every device boundary.  The sharded factory
    seeds each device with the collective exclusive-prefix phi0 and
    halo-fetches one neighbor RF frame for the receive filters; both
    audio and video must match the unsharded joined chain.

    Measured: video 6.5e-6 (the hop FFT fp-schedule tolerance), audio
    1.6e-6 — identical across (2,4)/(1,8)/(8,1) factorings.
    """
    from color_modem_tpu.frame.rf import (
        make_rf_plan, rf_demodulate, rf_modulate, sound_from_rf,
        sound_on_rf,
    )
    from color_modem_tpu.parallel.sharded import (
        make_sharded_rf_sound_pipeline,
    )

    plan = get_plan("ntsc")
    rfp = make_rf_plan(plan)
    t = np.arange(B * L * N) / plan.fs
    audio = (0.6 * np.sin(2 * np.pi * 700.0 * t)
             + 0.3 * np.sin(2 * np.pi * 4300.0 * t)).astype(
                 np.float32).reshape(B, L * N)

    enc_u, dec_u, _ = make_pipeline(plan, "comb3")
    rf = rf_modulate(rfp, enc_u(jnp.asarray(batch), 5), 5)
    rf = sound_on_rf(rfp, rf, 5, jnp.asarray(audio), 0.0)
    aud_u = np.asarray(sound_from_rf(rfp, rf, 5))
    rgb_u = np.asarray(dec_u(rf_demodulate(rfp, rf, 5), 5))

    for mesh in (make_mesh(2, 4), make_mesh(1, 8)):
        _, _, rt = make_sharded_rf_sound_pipeline(plan, mesh, rfp, "comb3")
        rgb_s, aud_s = rt(jnp.asarray(batch), jnp.asarray(audio), 5)
        np.testing.assert_allclose(
            np.asarray(rgb_s), rgb_u, atol=2e-5, rtol=0,
            err_msg=f"video {mesh.shape}")
        np.testing.assert_allclose(
            np.asarray(aud_s), aud_u, atol=1e-5, rtol=0,
            err_msg=f"audio {mesh.shape}")


def test_sharded_satellite_audio_equals_unsharded(batch):
    """Satellite hop carrying the analog audio subcarrier ladder: the
    per-frame circular FM makes audio frame-local (each frame's block is
    ONE PERIOD), so it shards with its frame through
    make_sharded_hop_audio_pipeline — including the non-divisible-batch
    frame-axis fallback.  Video tolerance as the video-only satellite
    case (FM cumsum reassociation); audio measured 1.0e-6."""
    from color_modem_tpu.frame import satellite as sat
    from color_modem_tpu.parallel.sharded import (
        make_sharded_hop_audio_pipeline,
    )

    plan = get_plan("ntsc")
    sp = sat.make_sat_plan(plan.fs, N, audio_subs=2)
    S = L * N
    t = np.arange(S) / plan.fs

    def tone(f):  # integer cycles per frame block (the ONE-PERIOD model)
        k = round(f * S / plan.fs)
        return 0.6 * np.sin(2 * np.pi * k * t * plan.fs / S)

    audio = np.stack(
        [np.stack([tone(700.0 + 37 * b), tone(1100.0 + 41 * b)])
         for b in range(B)]
    ).astype(np.float32)

    def hop(c, a, f0):
        fm = sat.fm_modulate(sp, c, audio=a)
        return sat.fm_demodulate(sp, fm), sat.fm_demodulate_audio(sp, fm)

    enc_u, dec_u, _ = make_pipeline(plan, "comb3")
    comp_h, aud_u = hop(enc_u(jnp.asarray(batch), 5), jnp.asarray(audio), 5)
    rgb_u = np.asarray(dec_u(comp_h, 5))
    aud_u = np.asarray(aud_u)

    _, _, rt = make_sharded_hop_audio_pipeline(
        plan, make_mesh(2, 4), hop, "comb3")
    rgb_s, aud_s = rt(jnp.asarray(batch), jnp.asarray(audio), 5)
    np.testing.assert_allclose(np.asarray(rgb_s), rgb_u, atol=1e-3, rtol=0)
    np.testing.assert_allclose(np.asarray(aud_s), aud_u, atol=1e-5, rtol=0)
    # frame-axis fallback (batch 4 on the 2x4 grid)
    ch4, au4 = hop(enc_u(jnp.asarray(batch[:4]), 5), jnp.asarray(audio[:4]), 5)
    rgb_s4, aud_s4 = rt(jnp.asarray(batch[:4]), jnp.asarray(audio[:4]), 5)
    np.testing.assert_allclose(
        np.asarray(rgb_s4), np.asarray(dec_u(ch4, 5)), atol=1e-3, rtol=0,
        err_msg="fallback video")
    np.testing.assert_allclose(
        np.asarray(aud_s4), np.asarray(au4), atol=1e-5, rtol=0,
        err_msg="fallback audio")


def test_sharded_satellite_hop_equals_unsharded(batch):
    """Same gate through the satellite FM hop (frame-periodic, ignores
    frame0); looser float tolerance — the FM phase integral's megasample
    cumsum reassociates with the per-device batch shape and the
    discriminator is phase-sensitive (measured 4.6e-4 = -67 dB, far
    below every accuracy threshold in the chain)."""
    from color_modem_tpu.frame import satellite as sat
    from color_modem_tpu.parallel.sharded import make_sharded_hop_pipeline

    plan = get_plan("ntsc")
    sp = sat.make_sat_plan(plan.fs, N)
    hop = lambda c, f0: sat.fm_demodulate(sp, sat.fm_modulate(sp, c))  # noqa: E731
    enc_u, dec_u, _ = make_pipeline(plan, "comb3")
    want = np.asarray(dec_u(hop(enc_u(jnp.asarray(batch), 5), 5), 5))
    for mesh in (make_mesh(4, 2),):
        _, _, rt_s = make_sharded_hop_pipeline(plan, mesh, hop, "comb3")
        got = np.asarray(rt_s(jnp.asarray(batch), 5))
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0,
                                   err_msg=str(mesh.shape))
