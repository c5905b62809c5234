"""Smoke run of the modem's main path on the GPU, at the published sizes.

    python chip_smoke.py          # one card: phases 1-6
    python chip_smoke.py --four   # four cards: the sharded paths only

Everything runs in this one process.  The card is the only GPU user; the
process's CPU device serves the card-vs-CPU comparison.  Phases (one card):

1. device: JAX's devices, the card's name and power limit, XLA_FLAGS and
   the compile cache directory;
2. config 2: NTSC comb3 round trip on 16x3x480x720 through ``make_pipeline``;
3. configs 3 and 4: PAL delayline at 576x720, SECAM interp at 576x720 and
   at 576x1440;
4. config 5's shape on one card: ``process_video`` over 24 frames of
   1080-line synthetic video in chunks of 8, then a resume that redoes
   nothing (NTSC comb3, PAL delayline, SECAM interp);
5. the RF/VSB hop with FM mono sound and the satellite FM hop with two
   audio subcarriers, at 16x480x720, plus the frozen transmission and
   sound oracles at their test sizes;
6. the same modems, receiver DSP, hops and sound systems on the card and
   on the CPU device, compared at the stated tolerances.

Phases 2-3 check the round-trip PSNR against ``tests/test_roundtrip.py``'s
bounds and the composite and decoded RGB of one frame against the frozen
oracle (``color_modem_tpu/golden``) at >= 60 dB.  ``--four`` runs the
sharded pipelines on four cards, each compared with the unsharded pipeline
on one card.  Any failed check raises; nothing is caught and ignored.  The
last line of standard output is one JSON object naming the device, printed
only when every phase passed.  Without a GPU the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

#: Minimum round-trip PSNR (dB), from tests/test_roundtrip.py.
ROUNDTRIP_BOUNDS = {
    ("ntsc", "comb3"): 43.5,
    ("pal", "delayline"): 36.0,
    ("secam", "interp"): 37.0,
}
#: Golden-oracle parity bound (dB) on the composite and the decoded RGB.
PARITY_BOUND = 60.0
#: Chunked-video floor (dB): the catch-all round-trip floor of
#: tests/test_roundtrip.py raised to what tests/test_video.py asks of
#: its synthetic sources.
VIDEO_BOUND = 33.0

#: Phases 2-3 at their published frame geometry: (standard, decoder,
#: batch, lines, samples).
MODEM_CONFIGS = (
    ("ntsc", "comb3", 16, 480, 720),
    ("pal", "delayline", 16, 576, 720),
    ("secam", "interp", 16, 576, 720),
    ("secam", "interp", 16, 576, 1440),
)
VIDEO_CONFIGS = (("ntsc", "comb3"), ("pal", "delayline"), ("secam", "interp"))

#: Fixed output directory of the chunked-video phases (git-ignored).
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".smoke_out")


def log(label: str, msg: str) -> None:
    print(f"[{label}] {msg}", flush=True)


def card_label() -> str:
    """The cards' name and power limit as nvidia-smi reports them (one
    line per card), read by a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out


def scenes(batch: int, lines: int, samples: int, seed: int = 0) -> np.ndarray:
    """(B, 3, L, N) seeded band-limited test scenes, one seed per frame."""
    from color_modem_tpu.utils.testimages import smooth_scene

    return np.stack([
        smooth_scene(lines, samples, seed=seed + i) for i in range(batch)
    ]).astype(np.float32)


def _compile(label: str, name: str, fn, *args):
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    log(label, f"{name}: compile {time.perf_counter() - t0:.3f} s")
    return compiled


def _memory(label: str, name: str, compiled, dev) -> None:
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    stats = {f: getattr(ma, f, None) for f in fields} if ma else None
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    log(label, f"{name}: memory_analysis {stats}; peak_bytes_in_use {peak}")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# --- phase 1 ----------------------------------------------------------------


def device_phase(label: str) -> None:
    import jax

    from color_modem_tpu.utils.runtime import CACHE_ENV

    devs = jax.devices()
    log(label, f"devices {devs}; kind {devs[0].device_kind!r}; "
               f"count {len(devs)}")
    log(label, f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(label, "compile cache "
               f"{jax.config.jax_compilation_cache_dir!r} "
               f"({CACHE_ENV}={os.environ.get(CACHE_ENV)!r})")


# --- phases 2 and 3 -----------------------------------------------------------


def modem_phase(label: str, standard: str, decoder: str, batch: int,
                lines: int, samples: int, iters: int = 10) -> dict:
    """Round trip through ``make_pipeline`` at (batch, 3, lines, samples):
    compile and steady-state times, memory, round-trip PSNR, and golden
    parity of frame 0's composite and decoded RGB."""
    import jax
    import jax.numpy as jnp

    from color_modem_tpu import golden
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS
    from color_modem_tpu.utils.metrics import psnr
    from color_modem_tpu.utils.profiling import time_calls

    name = f"{standard}/{decoder} {batch}x3x{lines}x{samples}"
    dev = jax.devices()[0]
    plan = make_plan(ALL_STANDARDS[standard](), samples)
    enc, dec, rt = make_pipeline(plan, decoder)
    rgb_h = scenes(batch, lines, samples)
    rgb = jax.device_put(rgb_h, dev)
    f0 = jnp.int32(0)

    c_rt = _compile(label, f"{name} roundtrip", rt, rgb, f0)
    c_enc = _compile(label, f"{name} encode", enc, rgb, f0)
    comp = c_enc(rgb, f0)
    c_dec = _compile(label, f"{name} decode", dec, comp, f0)
    ms = 1e3 * time_calls(c_rt, rgb, f0, iters=iters)
    log(label, f"{name}: roundtrip {ms:.3f} ms/call steady state "
               f"({batch * lines * samples / ms / 1e3:.1f} Mpix/s)")
    _memory(label, name, c_rt, dev)

    out = np.asarray(c_rt(rgb, f0))
    comp_h = np.asarray(comp)
    dec_h = np.asarray(c_dec(comp, f0))
    _check(out.shape == rgb_h.shape and np.isfinite(out).all(),
           f"{name}: bad round-trip output")
    p_rt = psnr(out, rgb_h)
    p_split = psnr(out, dec_h)
    comp_g = golden.encode_frame(plan, rgb_h[0], frame=0)
    rgb_g = golden.decode_frame(plan, comp_h[0], frame=0, decoder=decoder)
    p_enc = psnr(comp_h[0], comp_g)
    p_dec = psnr(dec_h[0], rgb_g)
    bound = ROUNDTRIP_BOUNDS[(standard, decoder)]
    log(label, f"{name}: round-trip PSNR {p_rt:.2f} dB (bound {bound}); "
               f"golden parity composite {p_enc:.2f} dB, rgb {p_dec:.2f} dB "
               f"(bound {PARITY_BOUND}); roundtrip vs decode(encode) "
               f"{p_split:.2f} dB")
    _check(p_rt >= bound, f"{name}: round trip {p_rt:.2f} dB < {bound}")
    _check(p_enc >= PARITY_BOUND, f"{name}: encode parity {p_enc:.2f} dB")
    _check(p_dec >= PARITY_BOUND, f"{name}: decode parity {p_dec:.2f} dB")
    _check(p_split >= PARITY_BOUND,
           f"{name}: roundtrip differs from decode(encode): {p_split:.2f}")
    return {"ms": ms, "psnr": p_rt, "parity": (p_enc, p_dec)}


# --- phase 4 ------------------------------------------------------------------


def video_phase(label: str, standard: str, decoder: str, n_frames: int,
                chunk: int, lines: int, samples: int, out_root: str,
                mesh=None, save_outputs: bool = False) -> dict:
    """``process_video`` over device-resident synthetic frames into a
    fresh fixed directory; the manifest must complete, and a resumed run
    must redo no chunk."""
    from color_modem_tpu.frame.video import (
        process_video, synthetic_device_source,
    )
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS
    from color_modem_tpu.utils.manifest import ChunkManifest

    tag = "mesh" if mesh is not None else "one"
    name = f"video {standard}/{decoder} {n_frames}x{lines}x{samples} ({tag})"
    out_dir = os.path.join(out_root, f"{standard}_{decoder}_{tag}")
    shutil.rmtree(out_dir, ignore_errors=True)
    plan = make_plan(ALL_STANDARDS[standard](), samples)
    src = synthetic_device_source(lines, samples)
    kw = dict(decoder=decoder, chunk=chunk, lines=lines, mesh=mesh,
              save_outputs=save_outputs)
    s1 = process_video(plan, src, n_frames, out_dir, **kw)
    log(label, f"{name}: {s1['frames_processed_this_run']} frames in "
               f"{s1['seconds']} s (compile included), {s1['mpix_per_s']} "
               f"Mpix/s, min PSNR {s1['min_psnr_db']} dB (bound {VIDEO_BOUND})")
    _check(s1["frames_processed_this_run"] == n_frames,
           f"{name}: processed {s1['frames_processed_this_run']}")
    done = ChunkManifest(out_dir).summary()
    _check(done == {"chunks_done": -(-n_frames // chunk),
                    "frames_done": n_frames}, f"{name}: manifest {done}")
    _check(s1["min_psnr_db"] >= VIDEO_BOUND,
           f"{name}: min PSNR {s1['min_psnr_db']} dB")
    s2 = process_video(plan, src, n_frames, out_dir, **kw)
    log(label, f"{name}: resume processed "
               f"{s2['frames_processed_this_run']} frames")
    _check(s2["frames_processed_this_run"] == 0, f"{name}: resume redid work")
    return {"summary": s1, "out_dir": out_dir}


# --- phase 5 ------------------------------------------------------------------


def _parity_db(a, b) -> float:
    """Signal-to-difference ratio (dB) of ``a`` against reference ``b``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(float(np.var(b)) / max(err, 1e-300))


def _snr_db(ref, out) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10.0 * np.log10(np.mean(ref ** 2) / np.mean(err ** 2))


def _periodic_tone(f: float, amp: float, n_tot: int, fs: float) -> np.ndarray:
    """Integer cycles over one frame block: the satellite layer treats a
    frame as one period (frame/satellite.py)."""
    k = max(1, round(f * n_tot / fs))
    t = np.arange(n_tot) / fs
    return (amp * np.sin(2 * np.pi * (k * fs / n_tot) * t)).astype(np.float32)


def transmission_phase(label: str, batch: int, lines: int, samples: int,
                       oracle_lines: int = 16) -> None:
    """RF/VSB hop with FM mono sound (NTSC) and satellite FM hop with audio
    subcarriers (SECAM) at (batch, lines, samples), against the bounds of
    tests/test_rf.py and tests/test_satellite.py; then the frozen
    transmission and sound oracles at their test sizes (2 frames of
    ``oracle_lines`` lines), against tests/test_golden_transmission.py's
    and tests/test_golden_sound.py's bounds."""
    import jax
    import jax.numpy as jnp

    from color_modem_tpu.frame import rf, satellite as sat
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.golden import sound as gs, transmission as gt
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC, SECAM
    from color_modem_tpu.utils.metrics import psnr
    from color_modem_tpu.utils.profiling import time_calls

    name = f"ntsc {batch}x{lines}x{samples}"
    plan = make_plan(NTSC(), samples)
    enc, dec, _ = make_pipeline(plan, "comb3")
    rgb_h = scenes(batch, lines, samples)
    comp = enc(jnp.asarray(rgb_h), 0)
    comp_h = np.asarray(comp)
    direct = psnr(np.asarray(dec(comp, 0)), rgb_h)

    # RF/VSB hop with the intercarrier FM sound (joined-stream audio)
    rfp = rf.make_rf_plan(plan)
    t = np.arange(lines * samples) / plan.fs
    tone = (0.6 * np.sin(2 * np.pi * 1000 * t)
            + 0.3 * np.sin(2 * np.pi * 7000 * t)).astype(np.float32)
    audio = np.broadcast_to(tone, (batch, lines * samples)).copy()
    audio_d = jnp.asarray(audio)
    hop = jax.jit(lambda c, a: rf.rf_roundtrip(rfp, c, 0, a))
    c_hop = _compile(label, f"rf hop + FM sound {name}", hop, comp, audio_d)
    ms = 1e3 * time_calls(c_hop, comp, audio_d, iters=3, warmup=1)
    log(label, f"rf hop + FM sound {name}: {ms:.3f} ms/call steady state")
    out, aud = (np.asarray(a) for a in c_hop(comp, audio_d))
    crop = 8192  # audio low-pass transient (tests/test_rf.py)
    snr = _snr_db(audio[:, crop:-crop], aud[:, crop:-crop])
    transp = psnr(out[:, 2:-2], comp_h[:, 2:-2])
    via = psnr(np.asarray(dec(jnp.asarray(out), 0)), rgb_h)
    log(label, f"rf hop {name}: transparency {transp:.2f} dB (bound 63), "
               f"audio SNR {snr:.2f} dB (bound 55), rgb via hop {via:.2f} "
               f"dB vs direct {direct:.2f} dB (bound direct - 0.2)")
    _check(transp >= 63.0, f"rf transparency {transp:.2f} dB")
    _check(snr >= 55.0, f"rf audio SNR {snr:.2f} dB")
    _check(via >= direct - 0.2, f"rf rgb {via:.2f} vs {direct:.2f} dB")

    # satellite FM hop carrying SECAM (its historical payload), plain and
    # with two frame-periodic audio subcarriers; the picture bound of
    # tests/test_satellite.py applies to the plain hop
    splan = make_plan(SECAM(), samples)
    s_enc, s_dec, _ = make_pipeline(splan, "interp")
    s_comp = s_enc(jnp.asarray(rgb_h), 0)
    s_direct = psnr(np.asarray(s_dec(s_comp, 0)), rgb_h)
    sp0 = sat.make_sat_plan(splan.fs, samples)
    sp = sat.make_sat_plan(splan.fs, samples, audio_subs=2)
    n_tot = lines * samples
    subs = np.stack([
        _periodic_tone(1000, 0.6, n_tot, splan.fs)
        + _periodic_tone(7000, 0.3, n_tot, splan.fs),
        _periodic_tone(3000, 0.5, n_tot, splan.fs),
    ])
    subs_b = np.broadcast_to(subs, (batch,) + subs.shape).copy()

    def sat_hops(c, a):
        sig = sat.fm_modulate(sp, c, audio=a)
        return (sat.fm_demodulate(sp0, sat.fm_modulate(sp0, c)),
                sat.fm_demodulate(sp, sig), sat.fm_demodulate_audio(sp, sig))

    name = f"secam {batch}x{lines}x{samples}"
    subs_d = jnp.asarray(subs_b)
    c_sat = _compile(label, f"satellite hops {name}", jax.jit(sat_hops),
                     s_comp, subs_d)
    ms = 1e3 * time_calls(c_sat, s_comp, subs_d, iters=3, warmup=1)
    log(label, f"satellite hops {name} (plain + with audio): {ms:.3f} "
               "ms/call steady state")
    vid, vid_a, saud = c_sat(s_comp, subs_d)
    saud = np.asarray(saud)
    # the receiver is AC-coupled (tests/test_satellite.py)
    s0 = _snr_db(subs_b[:, 0] - subs[0].mean(), saud[:, 0])
    s1 = _snr_db(subs_b[:, 1] - subs[1].mean(), saud[:, 1])
    via = psnr(np.asarray(s_dec(vid, 0)), rgb_h)
    via_a = psnr(np.asarray(s_dec(vid_a, 0)), rgb_h)
    log(label, f"satellite hop {name}: rgb via hop {via:.2f} dB vs direct "
               f"{s_direct:.2f} dB (bound direct - 0.5); with audio "
               f"subcarriers: rgb {via_a:.2f} dB, audio SNR {s0:.2f} / "
               f"{s1:.2f} dB (bounds 58 / 55)")
    _check(via >= s_direct - 0.5,
           f"satellite rgb {via:.2f} vs {s_direct:.2f} dB")
    _check(s0 >= 58.0 and s1 >= 55.0, f"satellite audio {s0:.2f}/{s1:.2f}")

    # frozen oracles at their test sizes
    small = np.asarray(make_pipeline(plan, "notch")[0](
        jnp.asarray(scenes(2, oracle_lines, samples)), 0))
    rows = [
        ("rf_modulate", 54.0, rf.rf_modulate(rfp, jnp.asarray(small), 3),
         gt.rf_modulate(rfp, small, 3)),
    ]
    g_rf = gt.rf_modulate(rfp, small, 3).astype(np.float32)
    rows.append(("rf_demodulate", 42.0,
                 rf.rf_demodulate(rfp, jnp.asarray(g_rf), 3),
                 gt.rf_demodulate(rfp, g_rf, 3)))
    sp0 = sat.make_sat_plan(plan.fs, samples)
    rows.append(("fm_modulate", 60.0, sat.fm_modulate(sp0, jnp.asarray(small)),
                 gt.fm_modulate(sp0, small)))
    g_fm = gt.fm_modulate(sp0, small).astype(np.float32)
    rows.append(("fm_demodulate", 95.0,
                 sat.fm_demodulate(sp0, jnp.asarray(g_fm)),
                 gt.fm_demodulate(sp0, g_fm)))
    tt = np.arange(oracle_lines * samples) / plan.fs
    snd = np.stack([
        0.6 * np.sin(2 * np.pi * f * tt) + 0.2 * np.sin(2 * np.pi * 2.7 * f * tt)
        for f in (700.0, 1700.0)
    ]).astype(np.float32)
    rf0 = np.zeros((2, oracle_lines, rfp.n_rf), np.float32)
    rows.append(("sound_on_rf", 100.0,
                 rf.sound_on_rf(rfp, jnp.asarray(rf0), 3, jnp.asarray(snd),
                                1.234),
                 gs.sound_on_rf(rfp, rf0, 3, snd, 1.234)))
    g_snd = gs.sound_on_rf(rfp, rf0, 3, snd, 0.5).astype(np.float32)
    rows.append(("sound_from_rf", 65.0,
                 rf.sound_from_rf(rfp, jnp.asarray(g_snd), 3),
                 gs.sound_from_rf(rfp, g_snd, 3)))
    for what, bound, got, want in rows:
        p = _parity_db(got, want)
        log(label, f"golden {what} (2x{oracle_lines}x{samples}): {p:.2f} dB "
                   f"(bound {bound})")
        _check(p > bound, f"golden {what}: {p:.2f} dB <= {bound}")


# --- phase 6 ------------------------------------------------------------------

#: (standard, decoder) modem cases of the card-vs-CPU comparison.
PARITY_CASES = (("ntsc", "comb3"), ("secam", "notch"), ("pal", "delayline"),
                ("ntsc", "comb3d"), ("ntsc", "combA"), ("ntsc", "comb3dA"))


def _parity_outputs(lines: int, samples: int) -> dict:
    """Every output the card-vs-CPU comparison checks, computed on JAX's
    current default device, as host arrays."""
    import jax
    import jax.numpy as jnp

    from color_modem_tpu.frame import a2, mts, nicam, rf, satellite as sat
    from color_modem_tpu.frame.channel import impair
    from color_modem_tpu.frame.equalize import (
        apply_equalizer, design_equalizer, gcr_record,
    )
    from color_modem_tpu.frame.interlace import make_interlaced_pipeline
    from color_modem_tpu.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu.frame.raster import make_raster
    from color_modem_tpu.frame.timebase import impair_timebase, tbc_correct
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS

    # two frames: the temporal combs need a frame axis to comb along
    rgb = jnp.asarray(np.stack([scenes(1, lines, samples, seed=9)[0],
                                scenes(1, lines, samples, seed=10)[0]]))
    plans = {n: make_plan(ALL_STANDARDS[n](), samples)
             for n in ("ntsc", "pal", "secam")}
    outs = {}
    for name, decoder in PARITY_CASES:
        enc, dec, _ = make_pipeline(plans[name], decoder)
        comp = enc(rgb, 0)
        outs[f"{name}-{decoder}-comp"] = comp
        outs[f"{name}-{decoder}-rgb"] = dec(comp, 0)

    # receiver DSP: ghost + GCR equalizer, timebase error + TBC, the
    # interlaced temporal comb
    plan = plans["ntsc"]
    enc, dec, _ = make_pipeline(plan, "comb3")
    comp = enc(rgb, 0)
    ghosted = impair(plan, comp, ghost_delay_us=1.2, ghost_gain=0.3)
    rec = impair(plan, jnp.asarray(gcr_record(plan))[None],
                 ghost_delay_us=1.2, ghost_gain=0.3)[0]
    outs["equalized"] = dec(apply_equalizer(ghosted,
                                            design_equalizer(plan, rec)), 0)
    encr, decr, _ = make_pipeline(plan, "comb3", raster=True)
    shifted, _ = impair_timebase(plan, encr(rgb, 0), wobble_us=0.3)
    g = frame_line_index(plan, 0, rgb.shape[0], rgb.shape[-2])
    outs["tbc"] = decr(tbc_correct(plan, make_raster(plan), shifted, g), 0)
    outs["interlaced3d"] = make_interlaced_pipeline(plan, "comb3d")[2](rgb, 0)

    # transmission hops on a notch composite
    comp = make_pipeline(plan, "notch")[0](rgb, 0)
    rfp = rf.make_rf_plan(plan)
    sp = sat.make_sat_plan(plan.fs, samples)
    outs["tx-comp"] = comp
    outs["tx-rf"] = jax.jit(lambda c: rf.rf_roundtrip(rfp, c, 0))(comp)
    outs["tx-sat"] = jax.jit(
        lambda c: sat.fm_demodulate(sp, sat.fm_modulate(sp, c)))(comp)

    # sound systems: NICAM, A2 stereo, BTSC/MTS
    pplan = plans["pal"]
    prfp = rf.make_rf_plan(pplan)
    rf0 = jnp.zeros((1, lines, prfp.n_rf), jnp.float32)
    cap = nicam.nicam_capacity(prfp, (1, lines, prfp.n_rf))
    ta = np.arange(nicam.BLOCK * cap) / 32000.0
    nl = (0.6 * np.sin(2 * np.pi * 440 * ta)).astype(np.float32)
    nr = (0.5 * np.sin(2 * np.pi * 880 * ta)).astype(np.float32)
    gl, gr, rep, _ = nicam.nicam_from_rf(
        prfp, nicam.nicam_on_rf(prfp, rf0, nl, nr), cap)
    outs.update(nicam_l=gl, nicam_r=gr, nicam_parity=rep["parity_errors"])
    a2p = a2.make_a2_plan(prfp)
    t = np.arange(lines * samples) / pplan.fs
    aud_l = (0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32)[None]
    aud_r = (0.5 * np.sin(2 * np.pi * 2300 * t)).astype(np.float32)[None]
    # carrier 1 must transmit (the mono sum on a blanking-level picture):
    # discriminating a dead carrier sprays noise by design
    base = rf.rf_modulate(prfp, jnp.zeros((1, lines, samples), jnp.float32),
                          3, jnp.asarray(0.5 * (aud_l + aud_r)))
    l2, r2, info = a2.a2_decode(
        a2p, a2.a2_on_rf(a2p, base, 3, jnp.asarray(aud_r), "stereo"), 3)
    outs.update(a2_l=l2, a2_r=r2,
                a2_stereo=np.int32(info["mode"][0] == "stereo"))
    ml = (0.7 * np.sin(2 * np.pi * 900 * t)).astype(np.float32)[None]
    mr = (0.5 * np.sin(2 * np.pi * 2400 * t)).astype(np.float32)[None]
    menc = mts.mts_encode(pplan, jnp.asarray(ml), jnp.asarray(mr))
    dl, dr, pil = mts.mts_decode(pplan, menc)
    outs.update(mts_enc=menc, mts_l=dl, mts_r=dr, mts_pilot=pil)
    return {k: np.asarray(v) for k, v in outs.items()}


def _parity_failures(card: dict, cpu: dict) -> tuple[list[str], dict]:
    """Compare card outputs with CPU outputs at the stated tolerances;
    returns the failures and the largest difference per output.

    Composite 2e-4 and decoded RGB 2e-3 absolute: f32 products summed in
    another order on each device.  The adaptive combs (combA, comb3dA)
    switch softly where the complement energies tie, so isolated samples
    may pick another blend: under 0.1% of samples beyond 2e-3, none beyond
    0.05.  Receiver DSP 2e-3; the hops 4e-3 (FFT twiddles through 2-3
    stream transforms plus the FM discriminator's phase sensitivity).
    NICAM must be bit-transparent on both (parity errors 0, audio equal to
    the companding floor 1e-5); A2 audio 4e-3; MTS 2e-4 / 2e-3 / 1e-4.
    """
    fails = []

    def close(key, atol):
        err = float(np.max(np.abs(card[key] - cpu[key]))) if card[key].size else 0.0
        if not err <= atol:
            fails.append(f"{key}: max |card - cpu| {err:.3g} > {atol}")
        return err

    report = {}
    for name, decoder in PARITY_CASES:
        report[f"{name}-{decoder}-comp"] = close(f"{name}-{decoder}-comp", 2e-4)
        key = f"{name}-{decoder}-rgb"
        err = np.abs(card[key] - cpu[key])
        if decoder in ("combA", "comb3dA"):
            frac = float((err > 2e-3).mean())
            if not (frac < 1e-3 and err.max() < 0.05):
                fails.append(f"{key}: {frac:.5f} outliers, max {err.max():.4f}")
        elif not err.max() < 2e-3:
            fails.append(f"{key}: max {err.max():.5f}")
        report[key] = float(err.max())
    for key in ("equalized", "tbc", "interlaced3d"):
        report[key] = close(key, 2e-3)
    report["tx-comp"] = close("tx-comp", 2e-4)
    report["tx-rf"] = close("tx-rf", 4e-3)
    report["tx-sat"] = close("tx-sat", 4e-3)
    for side, d in (("card", card), ("cpu", cpu)):
        if int(d["nicam_parity"].sum()) != 0:
            fails.append(f"nicam parity errors on the {side}")
        if int(d["a2_stereo"]) != 1:
            fails.append(f"a2 stereo not identified on the {side}")
    for key, atol in (("nicam_l", 1e-5), ("nicam_r", 1e-5), ("a2_l", 4e-3),
                      ("a2_r", 4e-3), ("mts_enc", 2e-4), ("mts_l", 2e-3),
                      ("mts_r", 2e-3), ("mts_pilot", 1e-4)):
        report[key] = close(key, atol)
    return fails, report


def parity_phase(label: str, card, cpu, lines: int = 64,
                 samples: int = 720) -> dict:
    """The same computations on the card and on the CPU device."""
    import jax

    with jax.default_device(card):
        got = _parity_outputs(lines, samples)
    with jax.default_device(cpu):
        want = _parity_outputs(lines, samples)
    fails, report = _parity_failures(got, want)
    log(label, "card vs cpu max abs diff: "
               + ", ".join(f"{k} {v:.3g}" for k, v in report.items()))
    _check(not fails, "card vs cpu: " + "; ".join(fails))
    return report


# --- four cards ---------------------------------------------------------------

#: Sharded-vs-unsharded tolerance on the card (absolute, on [0, 1] RGB and
#: the composite).  cuBLAS and XLA pick their algorithms per operand shape,
#: and a device's shard has another shape than the whole batch, so the two
#: sums can differ in the last bits; the CPU suite keeps its bit-identity.
SHARD_ATOL = 1e-4
#: FM hops: the phase integral's cumsum reassociates with the per-device
#: batch shape and the discriminator is phase-sensitive
#: (tests/test_sharding.py uses 1e-3 for the satellite hop on the CPU).
SHARD_ATOL_FM = 1e-3


def _diff(label: str, tag: str, got, want, atol: float) -> None:
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    log(label, f"{tag}: max |sharded - unsharded| {err:.3g} "
               f"({'bit-identical' if err == 0.0 else f'tolerance {atol}'})")
    _check(err <= atol, f"{tag}: {err:.3g} > {atol}")


def four_phase(label: str, devices, batch: int = 16, lines: int = 480,
               pal_lines: int = 576, samples: int = 720,
               video_lines: int = 1080, n_frames: int = 24, chunk: int = 8,
               out_root: str = OUT_DIR) -> None:
    """Sharded pipelines over four devices against the unsharded pipeline
    on ``devices[0]``, all in this process."""
    import jax
    import jax.numpy as jnp

    from color_modem_tpu.frame import rf
    from color_modem_tpu.frame.interlace import make_interlaced_pipeline
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.parallel import (
        make_mesh, make_sharded_interlaced_pipeline, make_sharded_pipeline,
    )
    from color_modem_tpu.parallel.sharded import make_sharded_rf_sound_pipeline
    from color_modem_tpu.standards import ALL_STANDARDS

    one = devices[0]
    meshes = ((4, 1), (1, 4), (2, 2))
    cases = (("ntsc", "comb3", lines), ("pal", "delayline", pal_lines),
             ("secam", "interp", pal_lines), ("ntsc", "comb3dA", lines))
    for standard, decoder, n_lines in cases:
        plan = make_plan(ALL_STANDARDS[standard](), samples)
        rgb = scenes(batch, n_lines, samples, seed=40)
        with jax.default_device(one):
            enc_u, dec_u, _ = make_pipeline(plan, decoder)
            comp_u = np.asarray(enc_u(rgb, 3))
            rgb_u = np.asarray(dec_u(comp_u, 3))
        for shape in meshes:
            mesh = make_mesh(*shape, devices=devices)
            enc_s, dec_s, _ = make_sharded_pipeline(plan, mesh, decoder)
            tag = f"{standard}/{decoder} {batch}x{n_lines}x{samples} mesh {shape}"
            _diff(label, f"{tag} encode", enc_s(rgb, 3), comp_u, SHARD_ATOL)
            _diff(label, f"{tag} decode", dec_s(jnp.asarray(comp_u), 3),
                  rgb_u, SHARD_ATOL)

    plan = make_plan(ALL_STANDARDS["ntsc"](), samples)
    rgb = scenes(batch, lines, samples, seed=60)
    with jax.default_device(one):
        want = np.asarray(make_interlaced_pipeline(plan, "comb3d")[2](rgb, 3))
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(*shape, devices=devices)
        got = make_sharded_interlaced_pipeline(plan, mesh, "comb3d")[2](rgb, 3)
        _diff(label, f"interlaced ntsc/comb3d {batch}x{lines}x{samples} "
                     f"mesh {shape}", got, want, SHARD_ATOL)

    # RF hop carrying the joined-stream FM sound
    rfp = rf.make_rf_plan(plan)
    t = np.arange(batch * lines * samples) / plan.fs
    aud = (0.6 * np.sin(2 * np.pi * 700.0 * t)).astype(np.float32).reshape(
        batch, lines * samples)
    with jax.default_device(one):
        enc_u, dec_u, _ = make_pipeline(plan, "comb3")
        rf_u = rf.rf_modulate(rfp, enc_u(rgb, 3), 3)
        rf_u = rf.sound_on_rf(rfp, rf_u, 3, jnp.asarray(aud), 0.0)
        aud_want = np.asarray(rf.sound_from_rf(rfp, rf_u, 3))
        vid_want = np.asarray(dec_u(rf.rf_demodulate(rfp, rf_u, 3), 3))
    mesh = make_mesh(2, 2, devices=devices)
    _, _, rt_snd = make_sharded_rf_sound_pipeline(plan, mesh, rfp, "comb3")
    vid_got, aud_got = rt_snd(rgb, aud, 3)
    _diff(label, f"rf hop + FM sound {batch}x{lines}x{samples} mesh (2, 2) "
                 "video", vid_got, vid_want, SHARD_ATOL)
    _diff(label, f"rf hop + FM sound {batch}x{lines}x{samples} mesh (2, 2) "
                 "audio", aud_got, aud_want, SHARD_ATOL_FM)

    # chunked video over the mesh against the one-card run
    for standard, decoder in VIDEO_CONFIGS:
        with jax.default_device(one):
            ref = video_phase(label, standard, decoder, n_frames, chunk,
                              video_lines, samples, out_root,
                              save_outputs=True)
        got = video_phase(label, standard, decoder, n_frames, chunk,
                          video_lines, samples, out_root,
                          mesh=make_mesh(4, 1, devices=devices),
                          save_outputs=True)
        for start in range(0, n_frames, chunk):
            f = f"rgb_{start:06d}.npy"
            _diff(label, f"video {standard}/{decoder} {video_lines} lines "
                         f"chunk {start}",
                  np.load(os.path.join(got["out_dir"], f)),
                  np.load(os.path.join(ref["out_dir"], f)), SHARD_ATOL)


# --- entry point --------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Smoke run of the modem on the GPU (see module doc).")
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU — JAX's first device is {dev.platform} "
              f"({dev.device_kind}); this smoke runs only on the card",
              file=sys.stderr)
        return 2
    n_cards = 4 if args.four else 1
    if len(jax.devices()) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    from color_modem_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    smi = card_label()
    print(smi, flush=True)
    label = smi.splitlines()[0]
    t_all = time.perf_counter()
    device_phase(label)
    devices = jax.devices()[:n_cards]
    if args.four:
        four_phase(label, devices)
    else:
        for standard, decoder, batch, lines, samples in MODEM_CONFIGS:
            modem_phase(label, standard, decoder, batch, lines, samples)
        for standard, decoder in VIDEO_CONFIGS:
            video_phase(label, standard, decoder, 24, 8, 1080, 720, OUT_DIR)
        transmission_phase(label, 16, 480, 720)
        parity_phase(label, dev, jax.devices("cpu")[0])
    log(label, f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
