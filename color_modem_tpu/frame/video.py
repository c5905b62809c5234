"""Chunked, resumable video processing (BASELINE.json config 5; SURVEY.md
§5.3/§5.4/§5.5).

A video run is a sequence of frame chunks pushed through the (optionally
sharded) round-trip pipeline.  Each finished chunk is recorded in the output
directory's manifest with a device-computed content fingerprint and PSNR;
re-running after an interruption skips completed chunks (failure recovery =
re-running a chunk — the honest strategy recorded in SURVEY.md §5.3).  A
structured JSON summary goes to ``results/`` (§5.5).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.frame.pipeline import make_pipeline
from color_modem_tpu.modem.plan import ModemPlan
from color_modem_tpu.utils.manifest import ChunkManifest

FrameSource = Callable[[int, int], np.ndarray]  # (start, count) -> (B,3,L,N)


def synthetic_source(lines: int, samples: int) -> FrameSource:
    """Deterministic per-frame synthetic scenes (tests, bench config 5)."""
    from color_modem_tpu.utils.testimages import smooth_scene

    def src(start: int, count: int) -> np.ndarray:
        return np.stack(
            [smooth_scene(lines, samples, seed=start + i) for i in range(count)],
            dtype=np.float32,
        )

    return src


def synthetic_device_source(lines: int, samples: int, seed: int = 0) -> FrameSource:
    """Device-resident synthetic frames.

    One base scene uploads once; per-frame variants derive on device (sample
    roll + deterministic brightness modulation keyed on the absolute frame
    index, so resume reproduces them exactly).  The host source costs
    ~0.16 s/frame of numpy FFT plus a full upload per chunk, which would
    dwarf the modem compute itself.
    """
    from color_modem_tpu.utils.testimages import smooth_scene

    state = {}

    def src(start: int, count: int):
        if "base" not in state:
            state["base"] = jnp.asarray(
                smooth_scene(lines, samples, seed=seed), jnp.float32
            )

            @jax.jit
            def variants(base, idx):
                def one(g):
                    rolled = jnp.roll(base, (g * 37) % samples, axis=-1)
                    gain = 0.85 + 0.1 * jnp.cos(0.37 * g.astype(jnp.float32))
                    return jnp.clip(rolled * gain + 0.05, 0.0, 1.0)

                return jax.vmap(one)(idx)

            state["variants"] = variants
        idx = jnp.arange(start, start + count)
        return state["variants"](state["base"], idx)

    return src


def process_video(
    plan: ModemPlan,
    source: FrameSource,
    n_frames: int,
    out_dir: str,
    *,
    decoder: str = "notch",
    chunk: int = 8,
    mesh=None,
    save_outputs: bool = False,
    resume: bool = True,
    lines: int | None = None,
    channel: dict | None = None,
    interlaced: bool = False,
    nr: bool = False,
    nr_sigma: float | None = None,
    rf: bool = False,
    rf_audio: np.ndarray | None = None,
    rf_audio_bw: float = 15e3,
    satellite: bool = False,
    sat_cnr: float | None = None,
    caption_bits: np.ndarray | None = None,
    scramble: tuple[str, int] | None = None,
) -> dict:
    """Round-trip ``n_frames`` frames in chunks; returns the run summary.

    ``lines`` (frame height) goes into the resume-manifest config so a
    re-run at a different resolution refuses to mix with old chunks; when
    omitted it is probed from the source's first frame.

    ``channel``: optional impairment kwargs for :func:`frame.channel.impair`
    (noise_sigma / chroma_gain / chroma_phase_deg / ghost_delay_us /
    ghost_gain) applied between encode and decode of every chunk; noise is
    keyed on each frame's ABSOLUTE index, so resumed runs and different
    chunk sizes reproduce the identical channel realization per frame.  An extra ``"vhs": True`` key applies the VHS color-under
    playback signature (channel.vhs_playback); ``"equalize": True``
    enables per-chunk GCR ghost
    cancellation (frame.equalize): a reference line rides the same channel
    and the estimated inverse FIR is applied before decoding — all inside
    the jitted chunk step, so no extra host round trips.

    ``interlaced``: transmit each frame as two 2:1 fields
    (frame.interlace); with a ``mesh``, fields shard DP over frames x CP
    over field-row blocks (parallel.sharded.make_sharded_interlaced_pipeline
    — requires an even line count whose half divides the line axis).
    comb3d combs same-parity fields.

    ``rf``: transmit every chunk over the RF/VSB layer (frame/rf.py —
    modulate to the low-IF picture signal, synchronous detection back)
    between encode and the composite channel, inside the jitted chunk
    step.  The carrier law is keyed on the absolute leading-axis index
    (frames, or FIELDS when interlaced), so chunk size and resume points
    cannot change the output.  With a ``mesh`` the RF stream filters run
    outside the shard_map (GSPMD inserts the resharding) — functional,
    but the sharded perf path is the composite pipeline, not the hop.

    ``nr``: motion-gated temporal noise reduction on the decoded frames
    (frame.nr) inside the jitted chunk step.  Gate threshold priority:
    explicit ``nr_sigma``, else the channel's known ``noise_sigma``, else
    the auto noise-floor estimator — which mis-gates under whole-frame
    motion (frame.nr docstring), so prefer an explicit sigma.

    ``scramble``: optional ``(mode, key)`` pay-TV scrambling
    (frame/scramble.py) of the transmitted composite; the receiver
    descrambles with the key before decoding.  Composes with the
    ``rf``/``satellite`` hops (the scrambled composite rides the hop —
    the authentic Videocrypt-on-Astra configuration), with ``channel``
    impairments (they land on the scrambled signal) and with
    ``caption_bits`` (data services descramble bit-exactly like the
    picture, so the caption readout sees the descrambled composite).
    Refuses ``channel={"equalize": True}`` — the GCR equalizer locks
    onto stream continuity the scrambled signal deliberately destroys.
    Keyed on the ABSOLUTE line index, so chunk size and resume points
    cannot change the transmission.

    ``caption_bits``: optional (n_frames, n_bits) 0/1 array — frame i's
    row 0 carries cell i as an EIA-608-style data line (frame.vbi), the
    real line-21 streaming model: one caption cell per frame, keyed by
    the ABSOLUTE frame index so chunk size and resume points cannot
    change the transmission.  The receiver slices the cells off the
    received composite inside the jitted step and each finished chunk
    persists its decoded bits as ``cc_<start>.npy`` (resume-friendly,
    like the rgb outputs); frame PSNR then excludes the data row.
    Interlaced runs are field-cadenced like real line-21 (VERDICT r4
    item 3): frame i's cell rides row 0 of its FIRST field (the field-1
    caption service; field 2's line 284 carried the rarely-used CC3/CC4
    and stays picture here), keyed by the absolute frame index so
    chunking stays free; the woven data row is still frame row 0, so the
    PSNR exclusion is identical.
    """
    os.makedirs(out_dir, exist_ok=True)
    manifest = ChunkManifest(out_dir) if resume else None
    if lines is None:
        lines = int(source(0, 1).shape[2])
    config = {
        "standard": plan.cfg.name,
        "decoder": decoder,
        "samples": plan.n_samples,
        "lines": lines,
        "chunk": chunk,
        "channel": channel,
        "interlaced": interlaced,
        # sparse (cli.py convention): a new always-present key would refuse
        # to resume every run whose manifest predates the option.  The
        # sigma is part of the config: resuming with a different gate
        # threshold would mix denoise levels across chunk boundaries.
        **({"nr": True, "nr_sigma": nr_sigma} if nr else {}),
        # Sparse, noisy runs only: names the PRNG keying scheme so a manifest
        # written under the old chunk-keyed noise refuses to resume (its
        # config lacks the key) instead of silently mixing two channel
        # realizations in one output directory.
        **(
            {"noise_keying": "abs-frame"}
            if channel and float(channel.get("noise_sigma", 0.0) or 0.0) > 0.0
            else {}
        ),
        **({"scramble": scramble[0], "scramble_key": scramble[1]}
           if scramble else {}),
        **({"rf": True} if rf else {}),
        **({"rf_audio": True} if rf_audio is not None else {}),
        **({"rf_audio_bw": rf_audio_bw} if rf_audio_bw != 15e3 else {}),
        **({"satellite": True, "sat_cnr": sat_cnr} if satellite else {}),
        **({"caption": True} if caption_bits is not None else {}),
        "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh else None,
    }
    if manifest:
        manifest.check_config(config)

    if interlaced:
        if mesh is not None:
            from color_modem_tpu.parallel.sharded import (
                make_sharded_interlaced_pipeline,
            )

            enc_f, dec_f, roundtrip = make_sharded_interlaced_pipeline(
                plan, mesh, decoder
            )
        else:
            from color_modem_tpu.frame.interlace import (
                make_interlaced_pipeline,
            )

            enc_f, dec_f, roundtrip = make_interlaced_pipeline(
                plan, decoder
            )
    elif mesh is not None:
        from color_modem_tpu.parallel.sharded import make_sharded_pipeline

        enc_f, dec_f, roundtrip = make_sharded_pipeline(
            plan, mesh, decoder
        )
    else:
        enc_f, dec_f, roundtrip = make_pipeline(plan, decoder)
    cap_spec = None
    if caption_bits is not None:
        from color_modem_tpu.frame.vbi import (
            cc_spec,
            decode_data_line,
            encode_data_line,
        )

        cap_spec = cc_spec(plan)
        _cap_bits = jnp.asarray(np.asarray(caption_bits), jnp.int32)
        _base_enc = enc_f

        if interlaced:

            def enc_f(rgb, frame0):  # noqa: F811 — field-cadenced line 21
                # field-sequential blocks order [f0p0, f0p1, f1p0, ...]
                # (interlace.split_fields): the EVEN blocks are each
                # frame's FIRST field — its row 0 carries the frame's cell
                comp = _base_enc(rgb, frame0)
                b = comp.shape[0] // 2
                idx = jnp.clip(
                    jnp.asarray(frame0, jnp.int32)
                    + jnp.arange(b, dtype=jnp.int32),
                    0, _cap_bits.shape[0] - 1,
                )
                wave = encode_data_line(plan, cap_spec, _cap_bits[idx])
                return comp.at[0::2, 0, :].set(wave)

        else:

            def enc_f(rgb, frame0):  # noqa: F811 — caption-carrying variant
                comp = _base_enc(rgb, frame0)
                idx = jnp.clip(
                    jnp.asarray(frame0, jnp.int32)
                    + jnp.arange(comp.shape[0], dtype=jnp.int32),
                    0, _cap_bits.shape[0] - 1,
                )
                wave = encode_data_line(plan, cap_spec, _cap_bits[idx])
                return comp.at[:, 0, :].set(wave)

        def roundtrip(rgb, frame0, aud=None, phi0=None):  # noqa: F811 —
            # rebuilt: the library roundtrip predates the caption wrap
            # (and the channel/rf variants below overwrite this with the
            # same (out, comp, aud) shape anyway)
            comp = enc_f(rgb, frame0)
            return dec_f(comp, frame0), comp, None

    else:
        _lib_rt = roundtrip

        def roundtrip(rgb, frame0, aud=None, phi0=None):  # noqa: F811
            return _lib_rt(rgb, frame0), None, None

    _descr_f = None
    if scramble is not None:
        # Pay-TV scrambling around the whole transmission chain: scramble
        # rides inside enc_f — after the data services, which descramble
        # bit-exactly like the picture (cli.py order) — and descrambling
        # happens inside the receiver helper ``_receive`` below, so the
        # rf/satellite hops AND the composite-level impairments all land
        # on the SCRAMBLED signal (Sky's analog Videocrypt really rode
        # Astra's satellite FM; VERDICT r3 item 2).  The keyed schedule
        # is a closed-form hash of the ABSOLUTE line index
        # (frame/scramble.py), so chunking and resume are exactly
        # independent with no extra bookkeeping.
        if channel and channel.get("equalize"):
            raise ValueError(
                "scramble breaks the stream continuity the GCR equalizer "
                "needs; descramble before equalizing instead"
            )
        from color_modem_tpu.frame.scramble import (
            descramble as _descr,
            scramble as _scr,
        )

        s_mode, s_key = scramble
        _clear_enc = enc_f

        if interlaced:
            # the key schedule follows the TRANSMITTED line numbering:
            # interlaced encode emits field-sequential blocks, so key on
            # the field line map (frame/interlace.py) — the same absolute
            # line indices that drive the subcarrier phase per field
            from color_modem_tpu.frame.interlace import field_line_index

            def _scr_gline(comp, frame0):
                return field_line_index(
                    plan, frame0, comp.shape[0] // 2, comp.shape[-2]
                )
        else:
            from color_modem_tpu.frame.pipeline import frame_line_index

            def _scr_gline(comp, frame0):
                return frame_line_index(
                    plan, frame0, comp.shape[0], comp.shape[-2]
                )

        def enc_f(rgb, frame0):  # noqa: F811 — scrambled-output variant
            comp = _clear_enc(rgb, frame0)
            return _scr(plan, comp, _scr_gline(comp, frame0), s_mode, s_key)

        def _descr_f(comp, frame0):
            return _descr(
                plan, comp, _scr_gline(comp, frame0), s_mode, s_key
            )

    _base_dec = dec_f

    def _receive(comp, frame0):
        """Receiver: keyed descramble (when subscribed), then decode.

        Returns ``(decoded, comp)`` with ``comp`` as the receiver's data
        slicer sees it — descrambled, so the caption readout below works
        on the scrambled runs too (the data services descramble
        bit-exactly like the picture)."""
        if _descr_f is not None:
            comp = _descr_f(comp, frame0)
        return _base_dec(comp, frame0), comp

    if scramble is not None:

        def roundtrip(rgb, frame0, aud=None, phi0=None):  # noqa: F811
            out, comp = _receive(enc_f(rgb, frame0), frame0)
            return out, (comp if cap_spec is not None else None), None

    want_sound = rf_audio is not None
    if want_sound and not rf:
        raise ValueError("rf_audio rides the RF sound carrier — pass "
                         "rf=True")

    _rf_hop = None
    if rf:
        from color_modem_tpu.frame.rf import (
            make_rf_plan,
            rf_demodulate,
            rf_modulate,
            sound_from_rf,
            sound_on_rf,
        )

        # a wider sound channel (e.g. 50 kHz for an MTS stereo multiplex
        # riding rf_audio) widens the takeoff/audio filters like the
        # roundtrip CLI's --rf-stereo path does
        rfp = make_rf_plan(plan, audio_bw=rf_audio_bw)
        _rf_units = 2 if interlaced else 1

        def _rf_hop(comp, frame0, aud=None, phi0=None):  # noqa: F811
            # the carrier row law keys on the ABSOLUTE leading-axis index
            # (fields when interlaced): an odd frame0 would otherwise flip
            # the (-1)^row parity relative to a chunk starting at 0 and
            # make the output chunk-size dependent
            g0 = jnp.asarray(frame0, jnp.int32) * _rf_units
            rf_sig = rf_modulate(rfp, comp, g0)
            aud_rx = None
            if aud is not None:
                # the chunk's frames are consecutive broadcast time: the
                # sound carrier runs over the JOINED stream, its deviation
                # phase continued across chunks by the host-f64 prefix
                # phi0 (sound_on_rf docstring) — so chunking and resume
                # points cannot move the audio either.  Interlaced: the
                # audio arrives (frames, samples/frame); the leading axis
                # of the RF stream is FIELDS, and field-sequential order
                # IS transmission order, so the per-field slices are just
                # consecutive halves of each frame's block.
                aud = jnp.asarray(aud, jnp.float32).reshape(
                    rf_sig.shape[0], -1
                )
                rf_sig = sound_on_rf(rfp, rf_sig, g0, aud, phi0)
                aud_rx = sound_from_rf(rfp, rf_sig, g0)
            return rf_demodulate(rfp, rf_sig, g0), aud_rx

    if satellite:
        if rf:
            raise ValueError(
                "satellite (FM) and rf (VSB-AM) are different transmission "
                "layers; pick one"
            )
        from color_modem_tpu.frame import satellite as sat_mod

        sp = sat_mod.make_sat_plan(plan.fs, plan.n_samples)
        sat_sigma = (
            sat_mod.noise_sigma(sp, sat_cnr) if sat_cnr is not None else 0.0
        )
        _sat_units = 2 if interlaced else 1
        sat_base = jax.random.PRNGKey(0x5A7)

        def _rf_hop(comp, frame0, aud=None, phi0=None):  # noqa: F811 — satellite
            # the satellite layer is frame-local by design (per-frame
            # circular FM), so chunk independence is structural; noise is
            # keyed on each item's ABSOLUTE leading-axis index like the
            # composite channel noise below
            rf_sig = sat_mod.fm_modulate(sp, comp)
            if sat_sigma:
                g = (jnp.asarray(frame0, jnp.int32) * _sat_units
                     + jnp.arange(comp.shape[0], dtype=jnp.int32))
                per = jax.vmap(
                    lambda i: jax.random.normal(
                        jax.random.fold_in(sat_base, i),
                        rf_sig.shape[1:], dtype=jnp.float32,
                    )
                )(g)
                rf_sig = rf_sig + jnp.float32(sat_sigma) * per
            return sat_mod.fm_demodulate(sp, rf_sig), None

    chan_noise_sigma = 0.0
    if channel:
        from color_modem_tpu.frame.channel import impair

        channel = dict(channel)
        equalize = bool(channel.pop("equalize", False))
        vhs = bool(channel.pop("vhs", False))
        # Noise is keyed per ABSOLUTE frame index (fold_in below), not per
        # chunk: overlap frames fetched by adjacent chunks then see the
        # identical realization, so comb3d/NR results stay chunk-size
        # independent under a noisy channel too (a chunk-keyed PRNG gave
        # each chunk its own realization on the shared frames).
        chan_noise_sigma = float(channel.pop("noise_sigma", 0.0))
        noisy = chan_noise_sigma > 0.0
        noise_base = jax.random.PRNGKey(0)
        if equalize:
            from color_modem_tpu.frame.equalize import (
                apply_equalizer,
                design_equalizer,
                gcr_record,
                ntaps_for_delay,
            )

            gcr = jnp.asarray(gcr_record(plan))[None]
            eq_ntaps = ntaps_for_delay(
                plan, float(channel.get("ghost_delay_us", 0.0))
            )

        # Interlaced encode returns FIELDS on the leading axis (2 per
        # frame), so the absolute index of leading-axis slot i is
        # frame0 * units + i — keying off frame0 + i directly would make
        # field noise depend on the chunk start.
        units = 2 if interlaced else 1

        def _add_noise(comp, frame0):
            g = frame0 * units + jnp.arange(comp.shape[0], dtype=jnp.int32)
            per = jax.vmap(
                lambda i: jax.random.normal(
                    jax.random.fold_in(noise_base, i),
                    comp.shape[1:], dtype=jnp.float32,
                )
            )(g)
            return comp + jnp.float32(chan_noise_sigma) * per

        def roundtrip(rgb, frame0, aud=None, phi0=None):  # noqa: F811
            comp = enc_f(rgb, frame0)
            aud_rx = None
            if _rf_hop is not None:
                # RF transmission first; the composite-level impairments
                # below model receiver-side degradations (cli.py order)
                comp, aud_rx = _rf_hop(comp, frame0, aud, phi0)
            comp = impair(plan, comp, **channel)
            if noisy:
                comp = _add_noise(comp, frame0)
            if vhs:
                from color_modem_tpu.frame.channel import vhs_playback

                comp = vhs_playback(plan, comp)
            if equalize:
                rx = impair(plan, gcr, **channel)[0]
                if noisy:
                    # the reference record sees its own fixed realization:
                    # a separate base key (never the frame stream, so no
                    # collision) and no frame0 dependence, so the designed
                    # taps — and therefore the decoded output — are
                    # identical across chunk sizes and resumes
                    rx = rx + jnp.float32(chan_noise_sigma) * jax.random.normal(
                        jax.random.PRNGKey(1), rx.shape, dtype=jnp.float32,
                    )
                comp = apply_equalizer(
                    comp, design_equalizer(plan, rx, ntaps=eq_ntaps)
                )
            out, comp = _receive(comp, frame0)
            return out, (
                comp if cap_spec is not None else None
            ), aud_rx

    elif _rf_hop is not None:

        def roundtrip(rgb, frame0, aud=None, phi0=None):  # noqa: F811
            comp, aud_rx = _rf_hop(enc_f(rgb, frame0), frame0, aud, phi0)
            out, comp = _receive(comp, frame0)
            return out, (
                comp if cap_spec is not None else None
            ), aud_rx

    from color_modem_tpu.utils.metrics import fingerprint_hex, fingerprint_jnp

    # One fused device step per chunk: roundtrip + PSNR + manifest
    # fingerprint all on device — only two scalars cross back to the host
    # unless outputs are being saved.  PSNR masks out padded duplicate frames
    # (n_real is traced, so the tail chunk doesn't retrace).
    def _interior_mask(out, off, n_real):
        """1.0 on the chunk's real frames; 0 on overlap and padding."""
        e = jnp.arange(out.shape[0])
        return ((e >= off) & (e < off + n_real)).astype(jnp.float32)

    def _metrics(out, rgb, off, n_real):
        mask = _interior_mask(out, off, n_real)
        if cap_spec is not None:  # row 0 carries data, not picture
            out, rgb = out[:, :, 1:, :], rgb[:, :, 1:, :]
        err = jnp.mean((out - rgb) ** 2, axis=(1, 2, 3))
        mse = jnp.sum(err * mask) / jnp.maximum(
            n_real.astype(jnp.float32), 1.0
        )
        q = 10.0 * jnp.log10(1.0 / jnp.maximum(mse, 1e-20))
        fp = fingerprint_jnp(out * mask[:, None, None, None])
        return q, fp

    if nr:
        from color_modem_tpu.frame.nr import temporal_nr

        # explicit sigma wins; else known channel noise (the composite
        # sigma lower-bounds the decoded-plane sigma, so the gate errs
        # conservative); auto-estimation is the last resort and mis-gates
        # under whole-frame motion (frame.nr docstring)
        if nr_sigma is None and chan_noise_sigma > 0.0:
            nr_sigma = chan_noise_sigma

    def _roundtrip_nr(rgb, frame0, aud=None, phi0=None):
        out, comp, aud_rx = roundtrip(rgb, frame0, aud, phi0)
        return (temporal_nr(out, nr_sigma) if nr else out), comp, aud_rx

    def _rx_caption(comp):
        """Receiver: slice the caption cells off the received row 0 —
        of every frame (progressive) or of each frame's first field
        (interlaced; one decoded cell per FRAME either way)."""
        if cap_spec is None:
            return jnp.zeros((0,), jnp.int32)
        rows = comp[0::2, 0, :] if interlaced else comp[:, 0, :]
        bits, _ = decode_data_line(plan, cap_spec, rows)
        return bits

    def _aud_out(aud_rx, b):
        if aud_rx is None:
            return jnp.zeros((b, 0), jnp.float32)
        return aud_rx

    @jax.jit
    def step(rgb, frame0, off, n_real, aud=None, phi0=None):
        out, comp, aud_rx = _roundtrip_nr(rgb, frame0, aud, phi0)
        return (out,) + _metrics(out, rgb, off, n_real) + (
            _rx_caption(comp), _aud_out(aud_rx, out.shape[0]),
        )

    @jax.jit
    def step_metrics(rgb, frame0, off, n_real, aud=None, phi0=None):
        out, comp, aud_rx = _roundtrip_nr(rgb, frame0, aud, phi0)
        return _metrics(out, rgb, off, n_real) + (
            _rx_caption(comp), _aud_out(aud_rx, out.shape[0]),
        )

    # the sharded pipeline needs the frame batch to divide the mesh frame
    # axis, and the temporal comb needs >= 2*spacing frames PER DEVICE; a
    # short/partial chunk is padded with repeats of its last frame (the
    # masked PSNR above excludes the duplicates)
    frame_axis = int(mesh.devices.shape[0]) if mesh is not None else 1
    min_per_dev = 1
    overlap = 0
    if decoder in ("comb3d", "comb3dA"):
        from color_modem_tpu.standards.decoders import temporal_comb_spacing

        pt = temporal_comb_spacing(plan.cfg) or 1
        min_per_dev = 2 * pt
        # temporal continuity across chunks: sources are random-access in
        # the absolute frame index, so each chunk fetches `pt` extra frames
        # per side and the decoder's stencil sees TRUE neighbors at chunk
        # boundaries (only the video's global first/last frames substitute)
        overlap = pt
    if nr:
        # NR's 3-frame stencil needs >= 2 frames per block (a tail chunk
        # of one frame would crash) and TRUE neighbors at chunk edges —
        # without the overlap, boundary frames averaged in-chunk
        # substitutes and the result depended on the chunk size
        min_per_dev = max(min_per_dev, 2)
        overlap = max(overlap, 1)
    if want_sound:
        # the sound filters (8193-tap audio LPF at the composite rate)
        # warm up over ~6 lines: a one-frame overlap hides the chunk-edge
        # transients, so interior audio is seam-free
        overlap = max(overlap, 1)
        aud_np = np.asarray(rf_audio, np.float64).reshape(-1)
        if aud_np.size % n_frames:
            raise ValueError(
                f"rf_audio length {aud_np.size} is not a whole number of "
                f"per-frame blocks for {n_frames} frames"
            )
        _aud_item = aud_np.size // n_frames
        # deviation phase accumulated before each frame, host f64 (exact
        # to ~1e-11 rad at any video length), reduced mod 2pi — any
        # chunking reconstructs the same continuous sound-carrier law
        _frame_sums = aud_np.reshape(n_frames, _aud_item).sum(axis=1)
        _pref = np.concatenate([
            [0.0],
            np.cumsum((2.0 * np.pi * rfp.snd_dev / plan.fs) * _frame_sums),
        ])
        _phi0_all = np.mod(_pref, 2.0 * np.pi).astype(np.float32)
        _aud_f32 = aud_np.astype(np.float32).reshape(n_frames, _aud_item)

    def _pad_frames(rgb):
        b = rgb.shape[0]
        target = max(b + (-b) % frame_axis, frame_axis * min_per_dev)
        if target == b:
            return rgb, b
        return (
            jnp.concatenate([jnp.asarray(rgb), *([rgb[-1:]] * (target - b))]),
            b,
        )

    t_start = time.perf_counter()
    pixels = 0
    frames_done = 0
    psnrs = []
    pending = []

    def _resolve(pending):
        """Batched device->host fetch + manifest flush for a wave of chunks.

        A readback waits for the device, so metrics come back in one
        stacked fetch per wave instead of one per chunk; bounded waves keep
        resume granularity (the manifest records each finished wave, not
        only a fully finished run) and cap live output buffers.
        """
        nonlocal frames_done
        all_q = np.asarray(jnp.stack([p[4] for p in pending]))
        all_fp = np.asarray(jnp.stack([p[5] for p in pending]))
        all_cc = (  # one stacked fetch (chunks may be ragged: concatenate)
            np.asarray(jnp.concatenate([p[6] for p in pending]))
            if cap_spec is not None else None
        )
        all_aud = (  # one stacked fetch, flattened (chunks may be ragged)
            np.asarray(jnp.concatenate([p[7].reshape(-1) for p in pending]))
            if want_sound else None
        )
        cc_at = 0
        aud_at = 0
        for k, (start, end, off, out, _, _, cc, aud_rx) in enumerate(pending):
            q = float(all_q[k])
            psnrs.append(q)
            frames_done += end - start
            if out is not None:
                np.save(
                    os.path.join(out_dir, f"rgb_{start:06d}.npy"),
                    np.asarray(out)[off : off + (end - start)],
                )
            if all_cc is not None:
                np.save(
                    os.path.join(out_dir, f"cc_{start:06d}.npy"),
                    all_cc[cc_at + off : cc_at + off + (end - start)],
                )
                cc_at += cc.shape[0]
            if want_sound:
                a0 = aud_at + off * _aud_item
                np.save(
                    os.path.join(out_dir, f"aud_{start:06d}.npy"),
                    all_aud[a0 : a0 + (end - start) * _aud_item],
                )
                aud_at += int(np.prod(aud_rx.shape))
            if manifest:
                manifest.mark_done(
                    start, end, fp=fingerprint_hex(all_fp[k]), psnr=round(q, 2)
                )

    # saving holds each wave's full decoded frames alive — keep those waves
    # short; metric-only waves hold two scalars per chunk
    wave = 2 if save_outputs else 16
    for start in range(0, n_frames, chunk):
        end = min(start + chunk, n_frames)
        if manifest and manifest.is_done(start, end):
            continue
        lo = max(0, start - overlap)
        hi = min(n_frames, end + overlap)
        rgb, _ = _pad_frames(source(lo, hi - lo))
        off = jnp.asarray(start - lo, jnp.int32)
        n_real = jnp.asarray(end - start, jnp.int32)
        pixels += (end - start) * rgb.shape[2] * rgb.shape[3]
        aud_args = ()
        if want_sound:
            b_pad = int(rgb.shape[0])
            idx = np.arange(lo, lo + b_pad)
            aud_chunk = _aud_f32[np.clip(idx, 0, n_frames - 1)].copy()
            aud_chunk[idx >= n_frames] = 0.0  # padded frames: silence
            aud_args = (jnp.asarray(aud_chunk),
                        jnp.float32(_phi0_all[lo]))
        if save_outputs:
            out, q, fp, cc, aud_rx = step(rgb, lo, off, n_real, *aud_args)
        else:
            out, (q, fp, cc, aud_rx) = None, step_metrics(
                rgb, lo, off, n_real, *aud_args
            )
        pending.append((start, end, start - lo, out, q, fp, cc, aud_rx))
        if len(pending) >= wave:
            _resolve(pending)
            pending = []
    if pending:
        _resolve(pending)
    wall = time.perf_counter() - t_start

    summary = {
        **config,
        "n_frames": n_frames,
        "frames_processed_this_run": frames_done,
        "mpix_per_s": round(pixels / wall / 1e6, 3) if pixels else 0.0,
        "min_psnr_db": round(min(psnrs), 2) if psnrs else None,
        "seconds": round(wall, 2),
    }
    results_dir = os.path.join(out_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    with open(
        os.path.join(results_dir, f"run_{time.time_ns()}.json"), "w"
    ) as f:
        json.dump(summary, f, indent=1)
    return summary
