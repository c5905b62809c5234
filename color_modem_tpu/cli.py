"""Command-line interface (SURVEY.md §5.6): encode | decode | roundtrip | info.

The reference has no packaged CLI [MEM-L]; this one exists so the framework
is drivable end-to-end without writing code:

    python -m color_modem_tpu.cli roundtrip --standard pal --decoder delayline \
        --input in.png --output out.png --composite comp.png
    python -m color_modem_tpu.cli roundtrip --standard secam --demo
    python -m color_modem_tpu.cli info

Results are printed as one JSON object (SURVEY.md §5.5).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


STANDARD_NAMES = ["ntsc", "pal", "secam", "niir", "ntsc443", "pal_m",
                  "pal_n", "pal60"]


def _add_common(p):
    p.add_argument("--standard", default="ntsc", choices=STANDARD_NAMES)
    p.add_argument("--decoder", default="notch")
    p.add_argument("--width", type=int, default=720, help="samples per line")
    p.add_argument("--frame", type=int, default=0, help="frame index (phase sequence)")


def _add_raster(p):
    p.add_argument(
        "--raster", action="store_true",
        help="full rastered lines: sync pulse + color burst in blanking",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="color_modem_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    enc = sub.add_parser("encode", help="RGB image -> composite image")
    _add_common(enc)
    _add_raster(enc)
    enc.add_argument("--input", required=True)
    enc.add_argument("--output", required=True, help="composite PNG (grayscale)")
    enc.add_argument("--raw", help="also dump float32 composite .npy")

    dec = sub.add_parser("decode", help="float32 composite .npy -> RGB image")
    _add_common(dec)
    _add_raster(dec)
    dec.add_argument("--input", required=True, help="composite .npy from encode --raw")
    dec.add_argument("--output", required=True)

    rt = sub.add_parser("roundtrip", help="RGB -> composite -> RGB")
    _add_common(rt)
    _add_raster(rt)
    rt.add_argument("--input", help="image file; omit with --demo")
    rt.add_argument("--demo", action="store_true", help="use generated color bars")
    rt.add_argument(
        "--pattern", default="bars",
        choices=("bars", "card", "ramp", "scene", "zone", "smpte"),
        help="demo image: 75%% color bars, the broadcast test card "
        "(crosshatch + circle + bars + gray steps + multiburst), a "
        "luminance ramp, a band-limited pseudo-natural scene, a "
        "zone plate (cross-color/aliasing sweep), or SMPTE engineering "
        "bars with the blue-only strip and PLUGE band",
    )
    rt.add_argument("--lines", type=int, default=0, help="demo height (0=standard)")
    rt.add_argument("--output", help="decoded PNG")
    rt.add_argument("--composite", help="composite visualization PNG")
    rt.add_argument(
        "--noise", type=float, default=0.0,
        help="channel white-noise sigma (composite units)",
    )
    rt.add_argument(
        "--chroma-gain", type=float, default=1.0,
        help="channel differential chroma gain",
    )
    rt.add_argument(
        "--chroma-phase", type=float, default=0.0,
        help="channel differential chroma phase, degrees",
    )
    rt.add_argument(
        "--interlaced", action="store_true",
        help="transmit as two 2:1 interlaced fields (authentic line "
        "numbering; weaves decoded fields back)",
    )
    rt.add_argument(
        "--svideo", action="store_true",
        help="transmit separate Y/C planes (no shared wire: no separation "
        "stage, no cross-color; decoder choice is ignored)",
    )
    rt.add_argument(
        "--diff-gain", type=float, default=0.0,
        help="differential (luma-tracking) chroma gain error at 100%% luma",
    )
    rt.add_argument(
        "--diff-phase", type=float, default=0.0,
        help="differential (luma-tracking) chroma phase at 100%% luma, deg",
    )
    rt.add_argument(
        "--ghost-delay-us", type=float, default=0.0,
        help="multipath ghost delay, microseconds",
    )
    rt.add_argument(
        "--ghost-gain", type=float, default=0.0,
        help="multipath ghost amplitude (0 = off; negative = inverted echo)",
    )
    rt.add_argument(
        "--vhs", action="store_true",
        help="VHS color-under playback: luma to ~3 MHz, chroma to "
        "fsc±0.4 MHz with phase-locked envelope delay",
    )
    rt.add_argument(
        "--tbe-us", type=float, default=0.0,
        help="time-base error: vertical wobble amplitude, microseconds "
        "(needs --raster)",
    )
    rt.add_argument(
        "--tbe-flagging-us", type=float, default=0.0,
        help="time-base error: top-of-field flagging amplitude, us",
    )
    rt.add_argument(
        "--tbc", action="store_true",
        help="time-base-correct from the sync/burst timing before decode",
    )
    rt.add_argument(
        "--equalize", action="store_true",
        help="GCR ghost cancellation: send a reference line through the "
        "same channel, estimate it, and equalize before decoding",
    )
    rt.add_argument(
        "--burst-locked", action="store_true",
        help="decode with the burst-measured subcarrier phase (needs "
        "--raster; cancels --chroma-phase like a real receiver)",
    )
    rt.add_argument(
        "--caption", default=None, metavar="TEXT",
        help="embed TEXT as EIA-608-framed caption cells (2 chars per "
        "line-21 cell, one cell per top row), ride the full channel/RF "
        "chain, decode and parity-check at the receiver (reported in "
        "the JSON; the picture PSNR then excludes the data rows)",
    )
    rt.add_argument(
        "--teletext", default=None, metavar="ROWS",
        help="embed a WST teletext page ('|'-separated display rows, "
        "Hamming-8/4 addresses + odd-parity chars at the real 444*fh "
        "bit rate) on the top rows, ride the channel/RF chain, decode "
        "and render at the receiver (needs --width >= 1440; 625-line "
        "standards)",
    )
    rt.add_argument(
        "--pal-ident", action="store_true",
        help="PAL family only: slip the receiver's line counter by one "
        "and let the receiver recover the V-switch parity from the "
        "swinging burst before the burst-locked decode (the PAL ident "
        "flip-flop; needs --burst-locked and --raster)",
    )
    rt.add_argument(
        "--secam-ident", action="store_true",
        help="SECAM only: transmit identification lines (the 'bottles' — "
        "content-free sawtooth FM sweeps), slip the receiver's line "
        "counter by one, and let the receiver recover the Dr/Db parity "
        "from the bottles before decoding (a real SECAM receiver cannot "
        "trust its line counter; this demonstrates the recovery loop)",
    )
    rt.add_argument(
        "--scramble", default=None,
        choices=("cutrotate", "linedelay", "shuffle"),
        help="pay-TV scrambling of the composite (Videocrypt-style "
        "cut-and-rotate / Discret-style line delay / Nagravision-style "
        "line shuffle); the receiver descrambles bit-exactly with the "
        "key and the JSON also reports the pirate's (undescrambled) "
        "PSNR; composes with --raster (active region only, sync/burst "
        "in the clear), --interlaced, and the --rf/--satellite hops "
        "(no --equalize/--tbc)",
    )
    rt.add_argument(
        "--scramble-key", type=int, default=0x5EC4E7,
        help="scrambling key (any 32-bit integer)",
    )
    rt.add_argument(
        "--vir", action="store_true",
        help="insert VIR vertical-interval reference lines (EIA-516 "
        "shape: chroma reference on a 70-IRE pedestal + luminance/black "
        "references) before the channel, and decode with the VIR-"
        "measured hue/saturation corrections — the picture-level "
        "correction loop (burst-based loops can't see luma-tracking "
        "errors; QAM standards, no --raster)",
    )
    rt.add_argument(
        "--palplus", action="store_true",
        help="PALplus mode (QAM standards): treat the input as a full-"
        "height 16:9 programme, transmit it as a 4:3-compatible "
        "letterbox with the vertical-helper signal modulated into the "
        "black bars, and reconstruct full vertical resolution at the "
        "receiver; reports the PSNR with and without the helper "
        "(composes with --noise only)",
    )
    rt.add_argument(
        "--vits", action="store_true",
        help="insert vertical-interval test signals (modulated staircase "
        "+ multiburst) on the bottom rows before encoding; measures "
        "DG/DP off the received composite and the luma frequency "
        "response off the decoded picture — in-service measurement "
        "through whatever channel/RF options are active",
    )
    rt.add_argument(
        "--wss", default=None, metavar="ASPECT",
        help="embed a widescreen-signalling status line (EN 300 294 "
        "odd-weight aspect codebook, biphase at 330*fh) on the row after "
        "the caption/teletext rows; decoded aspect is reported in the "
        "JSON (625-line standards; e.g. '16:9 full (anamorphic)')",
    )
    rt.add_argument(
        "--vitc", default=None, metavar="HH:MM:SS:FF",
        help="embed a vertical-interval timecode line (SMPTE 12M-shaped "
        "90-bit word, NRZ at 115*fh with embedded sync pairs + CRC) on "
        "the row after the other data services; the decoded timecode is "
        "reported in the JSON",
    )
    rt.add_argument(
        "--acc", action="store_true",
        help="automatic chroma control: scale chroma by spec-over-"
        "measured burst amplitude (cancels --chroma-gain; needs "
        "--burst-locked)",
    )
    rt.add_argument(
        "--color-kill", type=float, default=0.0,
        help="color-killer threshold (fraction of spec burst amplitude): "
        "kill chroma on lines whose burst falls below it — clean B/W on "
        "monochrome transmissions instead of cross-color confetti "
        "(needs --burst-locked; typical 0.3-0.5)",
    )
    rt.add_argument(
        "--rf", action="store_true",
        help="transmit over the RF layer: VSB negative-AM picture at a "
        "low IF, Nyquist-flank receiver + synchronous detection "
        "(frame/rf.py) between encode and the composite channel",
    )
    rt.add_argument(
        "--satellite", action="store_true",
        help="transmit over the SATELLITE layer instead: wideband video "
        "FM at IF with CCIR-405-shaped emphasis and a quadrature "
        "discriminator (frame/satellite.py) — the other transmission "
        "physics (terrestrial --rf is VSB-AM); mutually exclusive "
        "with --rf",
    )
    rt.add_argument(
        "--sat-cnr", type=float, default=None, metavar="DB",
        help="satellite channel carrier-to-noise ratio in dB (the FM "
        "advantage is ~+12 dB of baseband SNR above CNR; threshold "
        "effects appear below ~13 dB); implies --satellite",
    )
    rt.add_argument(
        "--sat-audio", action="store_true",
        help="analog FM audio subcarrier on the satellite multiplex "
        "(mono demo tones; the way analog satellite TV carried sound); "
        "implies --satellite",
    )
    rt.add_argument(
        "--sat-stereo", action="store_true",
        help="two audio subcarriers (L/R demo tones, the Astra-pair "
        "style); implies --satellite",
    )
    rt.add_argument(
        "--sat-audio-in", default=None, metavar="IN.wav",
        help="real audio for the satellite subcarrier(s): WAV file, "
        "resampled to the composite grid (stereo files use two "
        "subcarriers); implies --satellite",
    )
    rt.add_argument(
        "--rf-noise", type=float, default=0.0,
        help="AWGN sigma added at RF (fractions of peak carrier); "
        "implies --rf",
    )
    rt.add_argument(
        "--rf-detection", default="sync", choices=["sync", "envelope"],
        help="receiver detector: coherent product detection (clean, "
        "needs carrier phase) or envelope detection (phase-immune, "
        "authentic VSB quadrature distortion); implies --rf",
    )
    rt.add_argument(
        "--rf-phase-error", type=float, default=0.0,
        help="channel carrier phase offset, degrees (wrecks blind sync "
        "detection; ignored by envelope detection; cancelled by "
        "--rf-recover)",
    )
    rt.add_argument(
        "--rf-recover", action="store_true",
        help="quasi-synchronous receiver: recover the carrier phase from "
        "the signal (the negative-AM carrier line) before sync detection",
    )
    rt.add_argument(
        "--rf-freq-error", type=float, default=0.0,
        help="transmitter mistuning, Hz (both carriers shift; rolls the "
        "sync detector's phase and slides the signal off the Nyquist "
        "flank); corrected by --rf-aft; implies --rf",
    )
    rt.add_argument(
        "--rf-aft", action="store_true",
        help="automatic fine tuning: estimate the carrier frequency "
        "offset (coarse FFT peak + fine phase slope), digitally retune "
        "the stream back onto the Nyquist flank, and recover the "
        "remaining carrier phase (implies --rf-recover); implies --rf",
    )
    rt.add_argument(
        "--rf-audio", action="store_true",
        help="transmit a 1+7 kHz two-tone test signal on the intercarrier "
        "FM sound channel and report the recovered audio SNR; implies --rf",
    )
    rt.add_argument(
        "--rf-ghost-delay-us", type=float, default=3.0,
        help="RF multipath ghost delay (used with --rf-ghost-gain)",
    )
    rt.add_argument(
        "--rf-ghost-gain", type=float, default=0.0,
        help="RF multipath ghost gain (may be negative — an inverting "
        "bounce; the carrier phase rides the delay, unlike the "
        "composite-domain --ghost-*); implies --rf",
    )
    rt.add_argument(
        "--rf-equalize", action="store_true",
        help="send a guarded GCR record through the same RF chain and "
        "equalize about the zero-carrier pivot after detection (cancels "
        "--rf-ghost-* under sync detection; authentically fails to "
        "under envelope detection); implies --rf",
    )
    rt.add_argument(
        "--rf-audio-in", default=None, metavar="IN.wav",
        help="transmit a real audio file on the FM sound channel "
        "(resampled to the composite grid; mono, or stereo with "
        "--rf-stereo); implies --rf",
    )
    rt.add_argument(
        "--audio-out", default=None, metavar="OUT.wav",
        help="write the recovered sound-channel audio as 48 kHz 16-bit "
        "PCM (mono, or L/R with --rf-stereo)",
    )
    rt.add_argument(
        "--rf-dropouts", type=float, default=0.0,
        help="tape-dropout rate: probability per line of an RF carrier "
        "loss (~8 us span); implies --rf",
    )
    rt.add_argument(
        "--rf-doc", action="store_true",
        help="dropout compensator: replace carrier-loss samples with the "
        "previous line (1H DOC); implies --rf",
    )
    rt.add_argument(
        "--rf-gain", type=float, default=1.0,
        help="channel RF gain factor (propagation loss, misaligned "
        "antenna); washes the picture out unless --rf-agc; implies --rf",
    )
    rt.add_argument(
        "--rf-agc", action="store_true",
        help="sync-tip keyed automatic gain control: normalize the "
        "detected envelope by the constant sync-tip reference (needs "
        "--raster so sync is present); implies --rf",
    )
    rt.add_argument(
        "--rf-a2", default=None, choices=("stereo", "dual"),
        help="A2/Zweikanalton two-carrier sound (the German B/G system): "
        "a second FM sound carrier 15.5 fh up carries R (stereo) or a "
        "second program (dual), with the 3.5 fh AM-ident pilot; the "
        "receiver reports the DETECTED mode and per-channel SNR; "
        "implies --rf (the other two stereo systems: --rf-stereo is "
        "MTS/BTSC, --rf-nicam is NICAM-728)",
    )
    rt.add_argument(
        "--rf-stereo", action="store_true",
        help="transmit an MTS/BTSC-style stereo pair (1 kHz left, 3 kHz "
        "right) on the sound channel; reports per-ear SNR and the pilot "
        "level; implies --rf",
    )
    rt.add_argument(
        "--rf-nicam", action="store_true",
        help="transmit a NICAM-728 digital stereo burst (companded "
        "14-bit PCM, DQPSK carrier 0.5 MHz above the FM sound carrier) "
        "on the RF channel; reports per-ear SNR, parity errors and the "
        "frame-alignment lock; implies --rf",
    )

    vid = sub.add_parser(
        "video", help="chunked, resumable synthetic-video roundtrip run"
    )
    _add_common(vid)
    vid.add_argument("--frames", type=int, default=0,
                     help="frame count (0 = the whole --input clip, or 32 "
                     "synthetic frames)")
    vid.add_argument("--lines", type=int, default=0, help="0 = standard active lines")
    vid.add_argument("--chunk", type=int, default=8)
    vid.add_argument("--out", required=True, help="output/manifest directory")
    vid.add_argument("--input", default=None, metavar="CLIP.y4m",
                     help="real video input (YUV4MPEG2, e.g. from "
                     "`ffmpeg -i clip.mp4 clip.y4m`); the clip's geometry "
                     "sets the plan width and line count")
    vid.add_argument("--output", default=None, metavar="OUT.y4m",
                     help="write the decoded frames as a C444 .y4m clip "
                     "(assembled from the per-chunk outputs after the run)")
    vid.add_argument("--caption", default=None, metavar="TEXT",
                     help="stream TEXT as line-21 caption cells, one "
                     "2-char cell per frame (padded with spaces), decoded "
                     "off the received composite and reported in the JSON")
    vid.add_argument(
        "--mesh", default="", help="FxL device mesh, e.g. 2x4 (empty = unsharded)"
    )
    vid.add_argument("--no-resume", action="store_true")
    vid.add_argument(
        "--rf", action="store_true",
        help="transmit every chunk over the RF/VSB layer (frame/rf.py) "
        "inside the jitted chunk step",
    )
    vid.add_argument(
        "--satellite", action="store_true",
        help="transmit every chunk over the FM satellite layer "
        "(frame/satellite.py) instead of --rf; noise keyed per absolute "
        "frame, so runs are chunk-size independent and resume-safe",
    )
    vid.add_argument(
        "--sat-cnr", type=float, default=None, metavar="DB",
        help="satellite carrier-to-noise ratio in dB; implies --satellite",
    )
    vid.add_argument(
        "--rf-audio-in", default=None, metavar="IN.wav",
        help="soundtrack for the RF hop: WAV resampled to one audio "
        "sample per video sample, riding the intercarrier FM sound "
        "carrier phase-continuously across frames AND chunks (the "
        "deviation phase at each chunk start comes from the full "
        "track's host-f64 prefix sum, so chunking/resume cannot move "
        "the audio); needs --rf",
    )
    vid.add_argument(
        "--rf-stereo", action="store_true",
        help="carry the soundtrack as an MTS/BTSC stereo multiplex on "
        "the sound carrier (stereo WAV via --rf-audio-in, or L/R demo "
        "tones); the receiver decodes L/R and reports per-ear SNR; "
        "implies the wider 50 kHz sound channel",
    )
    vid.add_argument(
        "--audio-out", default=None, metavar="OUT.wav",
        help="write the receiver's recovered soundtrack as 48 kHz PCM "
        "(mono, or L/R with --rf-stereo; needs --rf-audio-in or "
        "--rf-stereo)",
    )
    vid.add_argument(
        "--host-source", action="store_true",
        help="generate frames on the host (default: on device — the host "
        "path re-uploads every chunk, which dominates over a slow link)",
    )
    vid.add_argument("--noise", type=float, default=0.0,
                     help="channel white-noise sigma")
    vid.add_argument("--chroma-gain", type=float, default=1.0)
    vid.add_argument("--chroma-phase", type=float, default=0.0,
                     help="channel differential chroma phase, degrees")
    vid.add_argument("--diff-gain", type=float, default=0.0,
                     help="differential chroma gain error at 100%% luma")
    vid.add_argument("--diff-phase", type=float, default=0.0,
                     help="differential chroma phase at 100%% luma, deg")
    vid.add_argument("--ghost-delay-us", type=float, default=0.0,
                     help="multipath ghost delay, microseconds")
    vid.add_argument("--ghost-gain", type=float, default=0.0,
                     help="multipath ghost amplitude (0 = off)")
    vid.add_argument("--equalize", action="store_true",
                     help="per-chunk GCR ghost cancellation before decode")
    vid.add_argument("--vhs", action="store_true",
                     help="VHS color-under playback signature per chunk")
    vid.add_argument(
        "--scramble", default=None,
        choices=("cutrotate", "linedelay", "shuffle"),
        help="pay-TV scrambling of every transmitted frame "
        "(frame/scramble.py), descrambled with the key at the receiver; "
        "composes with --rf/--satellite (the scrambled composite rides "
        "the hop — the authentic Videocrypt-on-Astra chain), the channel "
        "impairments, --caption and --interlaced (no --equalize); keyed "
        "on the absolute line index, so chunking/resume cannot move it",
    )
    vid.add_argument("--scramble-key", type=int, default=0x5EC4E7,
                     help="scrambling key (any 32-bit integer)")
    vid.add_argument("--nr", type=float, default=None, metavar="SIGMA",
                     help="motion-gated temporal noise reduction with this "
                     "expected noise sigma (explicit by design: the "
                     "auto-estimator mis-gates under whole-frame motion)")
    vid.add_argument("--interlaced", action="store_true",
                     help="transmit frames as 2:1 interlaced fields "
                     "(single-device)")

    tc = sub.add_parser(
        "transcode",
        help="standards conversion: decode one standard's composite and "
        "re-encode another's (held-frame rate conversion)",
    )
    tc.add_argument("--from", dest="src", required=True,
                    choices=STANDARD_NAMES)
    tc.add_argument("--to", dest="dst", required=True,
                    choices=STANDARD_NAMES)
    tc.add_argument("--width", type=int, default=720)
    tc.add_argument("--input", help="image file; omit with --demo")
    tc.add_argument("--demo", action="store_true",
                    help="use generated color bars")
    tc.add_argument("--decoder", default=None,
                    help="source decoder (default: best line-local)")
    tc.add_argument("--output", help="decoded-at-destination PNG")
    tc.add_argument("--composite", help="destination composite PNG")

    mc = sub.add_parser(
        "mac",
        help="D2-MAC time-multiplexed components: round trip an image "
        "(no subcarrier, no cross-color) and ride text on the duobinary "
        "data burst (99 bits/line at 10.125 Mbaud)",
    )
    mc.add_argument("--width", type=int, default=720)
    mc.add_argument("--variant", default="d2", choices=("d2", "d"),
                    help="d2 = 10.125 Mbaud duobinary burst (cable, the "
                    "default); d = full-rate D-MAC, 20.25 Mbaud, double "
                    "the payload (204 vs 99 bits/line)")
    mc.add_argument("--lines", type=int, default=0,
                    help="demo height (0 = 576, the 625-family active count)")
    mc.add_argument("--input", help="image file; omit with --demo")
    mc.add_argument("--demo", action="store_true",
                    help="use generated color bars")
    mc.add_argument("--noise", type=float, default=0.0,
                    help="AWGN sigma on the MAC baseband signal")
    mc.add_argument("--satellite", action="store_true",
                    help="ride the FM satellite layer (frame/satellite.py) "
                    "— the channel D2-MAC was designed for; adds the "
                    "frame-synchronous energy dispersal, which the MAC "
                    "clamp period removes")
    mc.add_argument("--audio-in", default=None, metavar="IN.wav",
                    help="MAC packet sound: NICAM-companded stereo audio "
                    "in the duobinary burst (resampled to 32 kHz, fills "
                    "the frame's burst capacity); mutually exclusive "
                    "with --data")
    mc.add_argument("--audio-out", default=None, metavar="OUT.wav",
                    help="write the burst-decoded audio (with --audio-in)")
    mc.add_argument("--sat-cnr", type=float, default=None, metavar="DB",
                    help="satellite carrier-to-noise ratio in dB; implies "
                    "--satellite")
    mc.add_argument("--data", default=None, metavar="TEXT",
                    help="text payload for the data burst (UTF-8, packed "
                    "12 bytes + 3 zero bits per line)")
    mc.add_argument("--output", help="decoded RGB PNG")
    mc.add_argument("--signal", help="MAC baseband as grayscale PNG")

    ms = sub.add_parser(
        "measure",
        help="broadcast T&M loop: staircase + multiburst through a "
        "channel, report differential gain/phase and frequency response",
    )
    ms.add_argument("--standard", default="ntsc", choices=STANDARD_NAMES)
    ms.add_argument("--width", type=int, default=720)
    ms.add_argument("--lines", type=int, default=64)
    ms.add_argument("--noise", type=float, default=0.0)
    ms.add_argument("--chroma-gain", type=float, default=1.0)
    ms.add_argument("--chroma-phase", type=float, default=0.0)
    ms.add_argument("--diff-gain", type=float, default=0.0)
    ms.add_argument("--diff-phase", type=float, default=0.0)
    ms.add_argument("--ghost-delay-us", type=float, default=0.0)
    ms.add_argument("--ghost-gain", type=float, default=0.0)
    ms.add_argument("--vhs", action="store_true")
    ms.add_argument(
        "--pulse-bar", action="store_true",
        help="also run the ITU-R pulse-and-bar line: 2T K-rating and "
        "20T chrominance/luminance gain+delay inequality",
    )
    ms.add_argument(
        "--vectorscope", metavar="PNG",
        help="also render the vectorscope instrument display of 75%% "
        "bars through the same channel (green phosphor trace, graticule "
        "boxes at the exact per-standard bar targets)",
    )
    ms.add_argument(
        "--waveform", metavar="PNG",
        help="also render the waveform monitor: RASTERED 75%% bars "
        "through the same channel, every line overlaid, IRE graticule "
        "(sync -40, blanking 0, white 100)",
    )
    ms.add_argument(
        "--spectrum", metavar="PNG",
        help="also render the spectrum analyzer: full band on top, "
        "fsc±16fh zoom below where the luma/chroma comb interleave is "
        "visible tooth by tooth (fh graticule at the luma positions)",
    )

    gal = sub.add_parser(
        "gallery",
        help="render every standard x decoder to PNGs for side-by-side "
        "artifact comparison (the reference's core use case)",
    )
    gal.add_argument("--out", required=True, help="output directory")
    gal.add_argument("--input", help="image file (default: color bars)")
    gal.add_argument("--width", type=int, default=720)
    gal.add_argument("--lines", type=int, default=0, help="0 = standard lines")
    gal.add_argument(
        "--chroma-phase", type=float, default=0.0,
        help="also render each pair through this channel phase error (deg)",
    )
    gal.add_argument(
        "--animate", type=int, default=0, metavar="K",
        help="also save a K-frame dot-crawl GIF per standard (the 4/8-field "
        "chroma phase sequence, notch decoder)",
    )
    gal.add_argument(
        "--fullstack", action="store_true",
        help="also render the full-stack 'authentic broadcast' row: "
        "rastered interlaced PAL at 576x1440 with teletext/WSS/VITC/"
        "captions, Videocrypt-style scrambling, RF hop with FM + NICAM "
        "sound — the subscriber's decoded picture (the composition "
        "tests/test_fullstack.py asserts service-by-service)",
    )

    from color_modem_tpu.benchmark import add_bench_args

    bm = sub.add_parser(
        "bench",
        help="round-trip throughput benchmark on the GPU (same protocol "
        "as the root bench.py)",
    )
    add_bench_args(bm)

    sub.add_parser("info", help="list standards, decoders, devices")
    return ap


def _load_input(args):
    import numpy as np

    from color_modem_tpu.frame.image_io import load_rgb
    from color_modem_tpu.standards import ALL_STANDARDS
    from color_modem_tpu.utils.testimages import color_bars

    cfg = ALL_STANDARDS[args.standard]()
    if getattr(args, "demo", False) or not getattr(args, "input", None):
        lines = getattr(args, "lines", 0) or cfg.active_lines
        pattern = getattr(args, "pattern", "bars")
        if pattern == "card":
            from color_modem_tpu.utils.testimages import test_card

            return test_card(lines, args.width).astype(np.float32), cfg
        if pattern == "ramp":
            from color_modem_tpu.utils.testimages import gray_ramp

            return gray_ramp(lines, args.width).astype(np.float32), cfg
        if pattern == "scene":
            from color_modem_tpu.utils.testimages import smooth_scene

            return smooth_scene(lines, args.width).astype(np.float32), cfg
        if pattern == "zone":
            from color_modem_tpu.utils.testimages import zone_plate

            return zone_plate(lines, args.width).astype(np.float32), cfg
        if pattern == "smpte":
            from color_modem_tpu.utils.testimages import smpte_bars

            return smpte_bars(lines, args.width).astype(np.float32), cfg
        return color_bars(lines, args.width).astype(np.float32), cfg
    rgb = load_rgb(args.input)
    if rgb.shape[2] != args.width:
        # on-device windowed-sinc resample to the composite sample grid
        # (K12/C7) — anti-aliased, one matmul, no PIL second pass.
        # Clip the sinc ringing: the encoder's contract is RGB in [0, 1].
        from color_modem_tpu.dsp.resample import resample_width

        rgb = np.clip(np.asarray(resample_width(rgb, args.width)), 0.0, 1.0)
    return rgb.astype(np.float32), cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from color_modem_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    if args.cmd == "bench":
        # broadcast-batch frames: the temporal decoders are fine here, so
        # the comb3d guard below (still-image subcommands) does not apply
        from color_modem_tpu.benchmark import run as bench_run

        bench_run(args)
        return 0
    # quality-qualified SECAM configuration (VERDICT r1 item 1): 1440
    # samples = 27 MHz keeps the ~6.2 MHz FM sidebands inside Nyquist;
    # measured +3 dB round trip over the 720 default
    # (tests/test_roundtrip.py::test_secam_quality_width_1440).  Only
    # advise where --width actually picks the encode grid: on `decode` the
    # composite's geometry was fixed at encode time, so the note would
    # point at a knob that cannot act; `transcode` re-encodes, so it gets
    # the note when either side is SECAM.
    secam_encoding = (
        "secam" in (args.src, args.dst)
        if args.cmd == "transcode"
        else (
            getattr(args, "standard", None) == "secam"
            and args.cmd != "decode"
        )
    )
    if secam_encoding and args.width < 1440:
        print(
            "note: secam at --width %d; --width 1440 (27 MHz) is the "
            "quality-qualified configuration (~+3 dB round trip)"
            % args.width,
            file=sys.stderr,
        )
    if (getattr(args, "decoder", None) in ("comb3d", "comb3dA")
            and args.cmd != "video"):
        raise SystemExit(
            f"{args.decoder} is a temporal decoder (combs along the frame "
            "axis) — use the 'video' subcommand"
        )
    if getattr(args, "burst_locked", False):
        # validate before any compute: needs a rastered line and a standard
        # that carries a burst (SECAM identifies lines by FM instead)
        if not args.raster:
            raise SystemExit("--burst-locked requires --raster")
        if args.standard == "secam":
            raise SystemExit("secam has no color burst to lock to")
    if getattr(args, "pal_ident", False):
        if not getattr(args, "burst_locked", False):
            raise SystemExit(
                "--pal-ident is the ident stage of the burst-locked "
                "receiver: add --burst-locked (and --raster)"
            )
        from color_modem_tpu.standards import ALL_STANDARDS as _AS
        from color_modem_tpu.standards.base import QamParams as _QP

        _chroma = _AS[args.standard]().chroma
        if not (isinstance(_chroma, _QP) and _chroma.v_switch):
            raise SystemExit(
                f"{args.standard} has no swinging burst — --pal-ident is "
                "a PAL-family feature"
            )
    if (getattr(args, "acc", False)
            or getattr(args, "color_kill", 0.0) > 0.0):
        if not getattr(args, "burst_locked", False):
            raise SystemExit(
                "--acc/--color-kill are keyed on the measured burst: "
                "add --burst-locked (and --raster)"
            )
    if (getattr(args, "tbe_us", 0.0) or getattr(args, "tbe_flagging_us", 0.0)
            or getattr(args, "tbc", False)):
        # validate before any compute (compiles are the expensive part of
        # a short run): the TBC locks to the sync edge of a rastered line
        if not args.raster or getattr(args, "interlaced", False):
            raise SystemExit(
                "--tbe-us/--tbc need --raster (the TBC locks to the sync "
                "edge) and are progressive-only in the CLI"
            )

    if getattr(args, "palplus", False):
        # PALplus is its own transmission geometry (letterbox + helper
        # bars), so it short-circuits the composable roundtrip plumbing —
        # but the real service was a 625i broadcast over terrestrial RF,
        # so the transmission stack composes (VERDICT r4 item 2):
        # --interlaced (one helper reference per FIELD), --raster (sync/
        # burst on every row incl. the bars), --rf/--rf-noise (the VSB
        # hop), plus the white-noise composite channel.
        import time as _time

        t0 = _time.perf_counter()
        # Whitelist (ADVICE r2): the palplus path honors exactly these
        # flags; ANY other roundtrip flag left at a non-default value is a
        # composition the pipeline would silently ignore, so refuse it —
        # comparing against the parser's own defaults keeps the check
        # complete as new flags are added.
        honored = {
            "cmd", "standard", "decoder", "width", "frame",
            "input", "demo", "pattern", "lines", "output", "composite",
            "noise", "palplus", "interlaced", "raster", "rf", "rf_noise",
        }
        defaults = vars(build_parser().parse_args(["roundtrip", "--demo"]))
        blocked = sorted(
            "--" + k.replace("_", "-")
            for k, v in vars(args).items()
            if k not in honored and v != defaults.get(k, v)
        )
        if blocked:
            raise SystemExit(
                "--palplus composes with --interlaced/--raster/--rf/"
                "--rf-noise/--noise only; remove " + " ".join(blocked)
            )
        if args.rf_noise > 0.0 and not args.rf:
            raise SystemExit("--rf-noise needs --rf")
        import numpy as np
        import jax
        import jax.numpy as jnp

        from color_modem_tpu.frame.image_io import save_composite, save_rgb
        from color_modem_tpu.frame.palplus import (
            PalPlusGeometry,
            make_interlaced_palplus_pipeline,
            make_palplus_pipeline,
        )
        from color_modem_tpu.modem.plan import make_plan
        from color_modem_tpu.utils.metrics import psnr

        rgb, cfg = _load_input(args)
        if cfg.is_fm:
            raise SystemExit(
                "--palplus needs a QAM subcarrier for the helper; "
                f"{cfg.name} is FM"
            )
        try:
            PalPlusGeometry(rgb.shape[1])
            if args.interlaced and rgb.shape[1] % 16:
                raise ValueError(
                    "interlaced PALplus needs lines divisible by 16, "
                    f"got {rgb.shape[1]}"
                )
        except ValueError as e:
            raise SystemExit(f"--palplus: {e}")
        plan = make_plan(cfg, args.width)
        make = (make_interlaced_palplus_pipeline if args.interlaced
                else make_palplus_pipeline)
        enc, dec, _ = make(plan, args.decoder,
                           raster=args.raster)
        units = 2 if args.interlaced else 1
        comp = enc(jnp.asarray(rgb)[None], args.frame)
        if args.rf:
            from color_modem_tpu.frame.rf import (
                make_rf_plan, rf_demodulate, rf_modulate,
            )

            rf_kw = {}
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                rf_kw["row_samples"] = make_raster(plan).n_total
            rfp = make_rf_plan(plan, **rf_kw)
            # absolute leading-axis index (fields when interlaced) keys
            # the carrier row law, as in frame/video.py
            g0 = args.frame * units
            rf_sig = rf_modulate(rfp, comp, g0)
            if args.rf_noise > 0.0:
                rf_sig = rf_sig + args.rf_noise * jax.random.normal(
                    jax.random.PRNGKey(1), rf_sig.shape, jnp.float32
                )
            comp = rf_demodulate(rfp, rf_sig, g0)
        if args.noise > 0.0:
            comp = comp + args.noise * jax.random.normal(
                jax.random.PRNGKey(0), comp.shape, jnp.float32
            )
        out = np.asarray(
            jax.block_until_ready(dec(comp, args.frame, use_helper=True))
        )[0]
        out_lb = np.asarray(dec(comp, args.frame, use_helper=False))[0]
        result = {
            "cmd": "roundtrip", "standard": cfg.name, "palplus": True,
            "decoder": args.decoder,
            "psnr_db": round(psnr(out, rgb), 2),
            "psnr_without_helper_db": round(psnr(out_lb, rgb), 2),
            "lines": int(rgb.shape[1]),
        }
        for k in ("interlaced", "raster", "rf"):
            if getattr(args, k):
                result[k] = True
        if args.output:
            save_rgb(args.output, out)
            result["output"] = args.output
        if args.composite:
            save_composite(args.composite, np.asarray(comp)[0])
            result["composite"] = args.composite
        result["seconds"] = round(_time.perf_counter() - t0, 3)
        print(json.dumps(result))
        return 0

    if args.cmd == "mac":
        import numpy as np
        import jax
        import jax.numpy as jnp

        from color_modem_tpu.frame.image_io import load_rgb, save_rgb
        from color_modem_tpu.modem import mac
        from color_modem_tpu.utils.metrics import psnr
        from color_modem_tpu.utils.testimages import color_bars

        if args.demo or not args.input:
            rgb = color_bars(args.lines or 576, args.width).astype(np.float32)
        else:
            rgb = load_rgb(args.input)
            if rgb.shape[2] != args.width:
                from color_modem_tpu.dsp.resample import resample_width

                rgb = np.clip(
                    np.asarray(resample_width(rgb, args.width)), 0.0, 1.0
                ).astype(np.float32)
        n_lines = rgb.shape[1]
        plan = mac.make_mac_plan(args.width, args.variant)
        mac_cap = plan.cfg.data_symbols - len(plan.cfg.line_sync_word)
        gline = jnp.arange(n_lines)

        payload = None
        n_audio_frames = 0
        audio_ref = None
        if args.audio_in is not None:
            if args.data is not None:
                raise SystemExit("--audio-in and --data share the burst "
                                 "payload; pick one")
            from color_modem_tpu.utils.wav import read_wav, resample_linear

            wav_x, wav_rate = read_wav(args.audio_in)
            if wav_x.shape[0] < 2:
                wav_x = np.concatenate([wav_x, wav_x])
            cap_frames = mac.sound_capacity(plan, n_lines)
            n_samp = cap_frames * 32
            audio_ref = resample_linear(wav_x[:2], wav_rate, 32000.0,
                                        n_out=n_samp).astype(np.float32)
            payload, n_audio_frames = mac.pack_sound(
                plan, jnp.asarray(audio_ref[0]), jnp.asarray(audio_ref[1]),
                n_lines,
            )
        if args.data is not None:
            # whole bytes per line slot, zero-padded (d2: 12 bytes of the
            # 99-bit slot; d: 25 of the 204-bit slot)
            raw = args.data.encode("utf-8")
            per = mac_cap // 8
            n_needed = -(-len(raw) // per)
            if n_needed > n_lines:
                raise SystemExit(
                    f"--data needs {n_needed} lines, image has {n_lines}"
                )
            raw = raw.ljust(n_lines * per, b"\0")
            bits = np.unpackbits(
                np.frombuffer(raw, np.uint8).reshape(n_lines, per), axis=1
            )
            payload = jnp.asarray(
                np.pad(bits, ((0, 0), (0, mac_cap - 8 * per))), jnp.int32
            )

        sig = mac.encode(plan, jnp.asarray(rgb), gline, payload)
        if args.satellite or args.sat_cnr is not None:
            from color_modem_tpu.frame import satellite as sat_mod

            sp = sat_mod.make_sat_plan(
                plan.cfg.fs, plan.cfg.samples_per_line,
                dispersal=0.1, total_lines=plan.cfg.total_lines,
            )
            tx = sig[None]
            rx = sat_mod.sat_roundtrip(
                sp, tx, gline=gline[None],
                key=jax.random.PRNGKey(11), cnr_db=args.sat_cnr,
            )
            # transparency measured clamp-to-clamp: the dispersal ramp is
            # REMOVED by the receiver clamp (it reaches here scaled by the
            # de-emphasis DC gain — the authentic reason real receivers
            # clamp after de-emphasis), so compare both sides DC-restored
            rx_c = rx - mac.clamp_correction(plan, rx)
            tx_c = tx - mac.clamp_correction(plan, tx)
            print(
                "satellite FM hop (with energy dispersal): transparency "
                f"{float(psnr(rx_c, tx_c)):.1f} dB"
                + (f" at CNR {args.sat_cnr} dB"
                   if args.sat_cnr is not None else " (noise-free)")
            )
            sig = rx[0]
        if args.noise > 0.0:
            sig = sig + args.noise * jax.random.normal(
                jax.random.PRNGKey(0), sig.shape
            )
        out = mac.decode(plan, sig, gline)
        print(f"{plan.cfg.name} roundtrip: {n_lines}x{args.width} "
              f"psnr {float(psnr(out, jnp.clip(jnp.asarray(rgb), 0, 1))):.1f} dB"
              + (f" (awgn sigma={args.noise})" if args.noise else ""))
        sync_ok, bits = mac.decode_data(plan, sig)
        print(f"line sync: {int(jnp.sum(sync_ok))}/{n_lines} bursts")
        if args.data is not None:
            per = mac_cap // 8
            got = np.asarray(bits)[:, : 8 * per]
            text = (
                np.packbits(got.astype(np.uint8), axis=1)
                .tobytes()
                .rstrip(b"\0")
                .decode("utf-8", errors="replace")
            )
            ber = float(np.mean(got != np.asarray(payload)[:, : 8 * per]))
            print(f"data burst payload (ber {ber:.2e}): {text!r}")
        if n_audio_frames:
            left, right, rep = mac.unpack_sound(plan, bits, n_audio_frames)
            rx = np.stack([np.asarray(left), np.asarray(right)])
            err = float(np.mean((rx - audio_ref) ** 2))
            # full-scale SNR: the quantization floor of 14->10-bit
            # companding is ~60 dB; channel bit errors show up far below
            snr = 10.0 * np.log10(1.0 / max(err, 1e-12))
            print(
                f"packet sound: {n_audio_frames} NICAM frames "
                f"({n_audio_frames * 32} samples/ch at 32 kHz), "
                f"audio SNR {snr:.1f} dB, "
                f"parity errors {int(np.sum(np.asarray(rep['parity_errors'])))}"
            )
            if args.audio_out:
                from color_modem_tpu.utils.wav import write_wav

                write_wav(args.audio_out, rx, 32000)
                print(f"wrote {args.audio_out}")
        if args.output:
            save_rgb(args.output, np.asarray(out))
            print(f"wrote {args.output}")
        if args.signal:
            from color_modem_tpu.frame.image_io import save_composite

            save_composite(args.signal, np.asarray(sig), lo=0.0, hi=1.0)
            print(f"wrote {args.signal}")
        return 0

    if args.cmd == "info":
        import jax

        from color_modem_tpu.frame.rf import make_rf_plan
        from color_modem_tpu.standards import ALL_STANDARDS
        from color_modem_tpu.standards.decoders import allowed_decoders

        def _rf_info(cfg):
            from color_modem_tpu.modem.plan import make_plan as _mk_plan

            try:
                rfp = make_rf_plan(_mk_plan(cfg, 720))
            except ValueError:
                return None
            return {
                "fc_mhz": round(rfp.fc / 1e6, 3),
                "f_video_mhz": round(rfp.f_video / 1e6, 2),
                "f_vestige_mhz": round(rfp.f_vestige / 1e6, 2),
                "f_snd_mhz": round(rfp.f_snd / 1e6, 3),
                "snd_dev_khz": round(rfp.snd_dev / 1e3, 1),
                "fs_rf_mhz": round(rfp.fs_rf / 1e6, 2),
            }

        print(
            json.dumps(
                {
                    "standards": {
                        k: list(allowed_decoders(f())) for k, f in ALL_STANDARDS.items()
                    },
                    "rf_defaults": {
                        k: _rf_info(f()) for k, f in ALL_STANDARDS.items()
                    },
                    "backend": jax.default_backend(),
                    "devices": [str(d) for d in jax.devices()],
                }
            )
        )
        return 0

    import numpy as np
    import jax

    from color_modem_tpu.frame.image_io import save_composite, save_rgb
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.utils.metrics import psnr

    if args.cmd == "measure":
        import jax.numpy as jnp

        from color_modem_tpu.frame.channel import impair, vhs_playback
        from color_modem_tpu.frame.measure import (
            measure_differential,
            measure_frequency_response,
            modulated_staircase,
            multiburst,
        )
        from color_modem_tpu.frame.pipeline import frame_line_index
        from color_modem_tpu.standards import ALL_STANDARDS

        plan = make_plan(ALL_STANDARDS[args.standard](), args.width)
        enc, _, _ = make_pipeline(plan, "notch")
        kw = dict(
            noise_sigma=args.noise, chroma_gain=args.chroma_gain,
            chroma_phase_deg=args.chroma_phase, diff_gain=args.diff_gain,
            diff_phase_deg=args.diff_phase,
            ghost_delay_us=args.ghost_delay_us, ghost_gain=args.ghost_gain,
        )
        stim_counter = [0]

        def through(rgb):
            # each stimulus sees its own noise realization
            key = (jax.random.PRNGKey(stim_counter[0])
                   if args.noise > 0.0 else None)
            stim_counter[0] += 1
            comp = impair(plan, enc(jnp.asarray(rgb)[None], 0),
                          key=key, **kw)
            return vhs_playback(plan, comp) if args.vhs else comp

        g = frame_line_index(plan, 0, 1, args.lines)
        is_fm = plan.cfg.is_fm
        if is_fm:
            # SECAM (VERDICT r2 item 9): the FM chroma carrier rides the
            # composite at constant amplitude everywhere, so the raw-
            # waveform readings would rate the system's own carrier as
            # distortion.  SECAM plants measured the LUMA path off the
            # decoded picture (carrier trap included) — decode with the
            # flagship pairing and take Y; DG/DP stays QAM-only (FM
            # chroma is immune by design, frame/measure.py).
            _, dec_fm, _ = make_pipeline(plan, "interp")

            def luma_of(comp):
                rgb_out = dec_fm(comp, 0)
                return jnp.einsum(
                    "c,bcln->bln", jnp.asarray(plan.rgb_to_ycc[0],
                                               jnp.float32), rgb_out
                )

            report = {"standard": args.standard,
                      "dg": None, "dp_deg": None,
                      "note": "DG/DP omitted: SECAM FM chroma is immune "
                              "by design; luma measurements are off the "
                              "decoded picture"}
        else:
            stair = through(modulated_staircase(plan, args.lines,
                                                args.width))
            rep = measure_differential(plan, stair, g)
            report = {
                "standard": args.standard,
                "dg": round(rep["dg"], 4),
                "dp_deg": round(rep["dp_deg"], 2),
                "step_phase_deg": [round(float(v), 2)
                                   for v in rep["step_phase_deg"]],
            }
        burst = through(multiburst(plan, args.lines))
        freq = measure_frequency_response(
            plan, luma_of(burst) if is_fm else burst
        )
        report["frequency_response"] = {f"{f}MHz": round(v, 3)
                                        for f, v in freq.items()}
        if args.pulse_bar:
            from color_modem_tpu.frame.measure import (
                measure_k_rating,
                measure_pulse_bar,
                pulse_and_bar,
            )

            pb = through(pulse_and_bar(plan, args.lines))
            if is_fm:
                pbr = measure_k_rating(plan, luma_of(pb))
            else:
                pbr = measure_pulse_bar(plan, pb, g)
            report["pulse_bar"] = {k: round(v, 3) for k, v in pbr.items()}
        if args.vectorscope and is_fm:
            raise SystemExit(
                "--vectorscope is a QAM instrument (it demodulates the "
                "quadrature subcarrier); SECAM has no chroma phase plane"
            )
        if args.vectorscope:
            from color_modem_tpu.frame.measure import vectorscope_image
            from color_modem_tpu.utils.testimages import color_bars

            bars = through(color_bars(args.lines, args.width))
            img = vectorscope_image(plan, bars, g)
            save_rgb(args.vectorscope, img.transpose(2, 0, 1))
            report["vectorscope"] = args.vectorscope
        if args.waveform:
            from color_modem_tpu.frame.measure import waveform_image
            from color_modem_tpu.utils.testimages import color_bars

            enc_r, _, _ = make_pipeline(plan, "notch", raster=True)
            bars_r = impair(
                plan,
                enc_r(jnp.asarray(color_bars(args.lines, args.width))[None], 0),
                key=jax.random.PRNGKey(99) if args.noise > 0.0 else None,
                **kw,
            )
            img = waveform_image(bars_r)
            save_rgb(args.waveform, img.transpose(2, 0, 1))
            report["waveform"] = args.waveform
        if args.spectrum:
            from color_modem_tpu.frame.measure import spectrum_image
            from color_modem_tpu.utils.testimages import smooth_scene

            # a natural scene shows the interleave comb best (bars'
            # step edges smear broadband energy across the teeth);
            # RASTERED rows so the fh comb rides the true line period
            enc_s, _, _ = make_pipeline(plan, "notch", raster=True)
            comp_s = impair(
                plan,
                enc_s(jnp.asarray(
                    smooth_scene(args.lines, args.width, seed=2)
                )[None], 0),
                key=jax.random.PRNGKey(99) if args.noise > 0.0 else None,
                **kw,
            )
            img = spectrum_image(plan, comp_s)
            save_rgb(args.spectrum, img.transpose(2, 0, 1))
            report["spectrum"] = args.spectrum
        print(json.dumps(report))
        return 0

    if args.cmd == "transcode":
        import jax.numpy as jnp

        from color_modem_tpu.frame.image_io import load_rgb
        from color_modem_tpu.frame.transcode import (
            best_decoder,
            make_transcoder,
            resample_lines,
        )
        from color_modem_tpu.standards import ALL_STANDARDS
        from color_modem_tpu.utils.testimages import color_bars

        plan_s = make_plan(ALL_STANDARDS[args.src](), args.width)
        plan_d = make_plan(ALL_STANDARDS[args.dst](), args.width)
        l_src = plan_s.cfg.active_lines
        if args.input:
            rgb = load_rgb(args.input, size=(args.width, l_src))
        elif args.demo:
            rgb = color_bars(l_src, args.width).astype(np.float32)
        else:
            raise SystemExit("transcode needs --input or --demo")
        enc_s, _, _ = make_pipeline(plan_s, "notch")
        comp_s = enc_s(jnp.asarray(rgb)[None], 0)
        conv = make_transcoder(plan_s, plan_d, args.decoder)
        comp_d = conv(comp_s, 0)
        _, dec_d, _ = make_pipeline(
            plan_d, best_decoder(plan_d)
        )
        out = np.asarray(dec_d(comp_d, 0))[0]
        ref = np.asarray(resample_lines(jnp.asarray(rgb)[None],
                                        out.shape[-2]))[0]
        result = {
            "from": args.src, "to": args.dst, "width": args.width,
            "lines": [int(l_src), int(out.shape[-2])],
            "decoder": args.decoder or best_decoder(plan_s),
            "psnr_db_vs_resampled_source": round(psnr(out, ref), 2),
        }
        if args.output:
            save_rgb(args.output, out)
            result["output"] = args.output
        if args.composite:
            save_composite(args.composite, np.asarray(comp_d)[0])
            result["composite"] = args.composite
        print(json.dumps(result))
        return 0

    if args.cmd == "gallery":
        import os

        from color_modem_tpu.frame.channel import impair
        from color_modem_tpu.frame.image_io import load_rgb
        from color_modem_tpu.standards import ALL_STANDARDS
        from color_modem_tpu.standards.decoders import allowed_decoders
        from color_modem_tpu.utils.testimages import color_bars

        os.makedirs(args.out, exist_ok=True)
        report = {}
        for name, factory in ALL_STANDARDS.items():
            cfg = factory()
            lines = args.lines or cfg.active_lines
            if args.input:
                rgb = load_rgb(args.input, size=(args.width, lines))
            else:
                rgb = color_bars(lines, args.width).astype(np.float32)
            try:
                plan = make_plan(cfg, args.width)
            except ValueError as e:
                # e.g. SECAM needs >=720-sample lines; skip, don't abort
                report[f"{name}_skipped"] = str(e)
                continue
            # encode and the impaired composite are decoder-independent:
            # build them once per standard, loop only the decoders
            enc, _, _ = make_pipeline(plan, "notch")
            comp = enc(rgb[None], 0)
            save_composite(
                os.path.join(args.out, f"{name}_composite.png"),
                np.asarray(comp)[0],
            )
            bad = (
                impair(plan, comp, chroma_phase_deg=args.chroma_phase)
                if args.chroma_phase != 0.0 else None
            )
            dec_notch = None
            for decoder in allowed_decoders(cfg):
                if decoder in ("comb3d", "comb3dA"):
                    continue  # temporal: needs a frame sequence, not a still
                _, dec, _ = make_pipeline(plan, decoder)
                if decoder == "notch":
                    dec_notch = dec  # reused by --animate (compile once)
                out = np.asarray(dec(comp, 0))[0]
                tag = f"{name}_{decoder}"
                save_rgb(os.path.join(args.out, f"{tag}.png"), out)
                report[tag] = round(psnr(out, rgb), 2)
                if bad is not None:
                    out_b = np.asarray(dec(bad, 0))[0]
                    save_rgb(
                        os.path.join(args.out, f"{tag}_phase.png"), out_b
                    )
                    report[f"{tag}_phase"] = round(psnr(out_b, rgb), 2)
            # the S-Video row: same standard without the shared wire —
            # the separation artifacts in the rows above vanish
            from color_modem_tpu.frame.svideo import make_svideo_pipeline

            _, _, rt_s = make_svideo_pipeline(plan)
            out_s = np.asarray(rt_s(rgb[None], 0))[0]
            save_rgb(os.path.join(args.out, f"{name}_svideo.png"), out_s)
            report[f"{name}_svideo"] = round(psnr(out_s, rgb), 2)
            # the RF rows (core standards only): the VSB hop is transparent
            # under synchronous detection; the envelope-detected row shows
            # the authentic quadrature distortion
            if name in ("ntsc", "pal", "secam") and dec_notch is not None:
                from color_modem_tpu.frame.rf import (
                    make_rf_plan,
                    rf_demodulate,
                    rf_modulate,
                )

                rfp = make_rf_plan(plan)
                rf_sig = rf_modulate(rfp, comp, 0)
                for det in ("sync", "envelope"):
                    out_r = np.asarray(
                        dec_notch(rf_demodulate(rfp, rf_sig, 0, det), 0)
                    )[0]
                    tag = f"{name}_rf" + ("" if det == "sync" else "_envelope")
                    save_rgb(os.path.join(args.out, f"{tag}.png"), out_r)
                    report[tag] = round(psnr(out_r, rgb), 2)
                if name == "ntsc":
                    # tape-dropout rows: raw damage vs the 1H compensator
                    from color_modem_tpu.frame.rf import rf_dropout

                    hit = rf_dropout(rfp, rf_sig, 7, rate=0.1)
                    for tag, use_doc in (("ntsc_rf_dropouts", False),
                                         ("ntsc_rf_doc", True)):
                        out_r = np.asarray(dec_notch(
                            rf_demodulate(rfp, hit, 0, doc=use_doc), 0
                        ))[0]
                        save_rgb(os.path.join(args.out, f"{tag}.png"), out_r)
                        report[tag] = round(psnr(out_r, rgb), 2)
                    # RF multipath ghost vs the pivot-aware GCR canceller
                    from color_modem_tpu.frame.equalize import (
                        apply_equalizer,
                        design_equalizer,
                        gcr_record_guarded,
                    )
                    from color_modem_tpu.frame.rf import rf_ghost

                    gh = rf_demodulate(
                        rfp, rf_ghost(rfp, rf_sig, 3.0, 0.3), 0
                    )
                    out_g = np.asarray(dec_notch(gh, 0))[0]
                    save_rgb(os.path.join(args.out, "ntsc_rf_ghost.png"),
                             out_g)
                    report["ntsc_rf_ghost"] = round(psnr(out_g, rgb), 2)
                    rx_g = rf_demodulate(rfp, rf_ghost(rfp, rf_modulate(
                        rfp, gcr_record_guarded(plan)[None], 0
                    ), 3.0, 0.3), 0)[0][:3]
                    pv = rfp.video_zero
                    taps = design_equalizer(plan, rx_g, ntaps=1281,
                                            reg=1e-4, pivot=pv)
                    out_e = np.asarray(dec_notch(
                        apply_equalizer(gh, taps, pivot=pv), 0
                    ))[0]
                    save_rgb(
                        os.path.join(args.out, "ntsc_rf_ghost_eq.png"), out_e
                    )
                    report["ntsc_rf_ghost_eq"] = round(psnr(out_e, rgb), 2)
            if name == "pal":
                # conditional-access row (VERDICT r2 item 5): Videocrypt-
                # style cut-and-rotate on the AUTHENTIC rastered signal —
                # active video scrambles, sync/burst stay in the clear —
                # the pirate's screen vs the keyed subscriber's
                from color_modem_tpu.frame.pipeline import frame_line_index
                from color_modem_tpu.frame.raster import make_raster
                from color_modem_tpu.frame.scramble import (
                    descramble as _g_descr,
                    scramble as _g_scr,
                )

                enc_r, dec_r, _ = make_pipeline(
                    plan, "comb3", raster=True
                )
                comp_r = enc_r(rgb[None], 0)
                g_g = frame_line_index(plan, 0, 1, lines)
                off_g = make_raster(plan).n_blank
                scr_g = _g_scr(plan, comp_r, g_g, "cutrotate", 0x5EC4E7,
                               active_start=off_g)
                pirate_g = np.asarray(dec_r(scr_g, 0))[0]
                save_rgb(
                    os.path.join(args.out, "pal_scrambled_pirate.png"),
                    pirate_g,
                )
                report["pal_scrambled_pirate"] = round(psnr(pirate_g, rgb), 2)
                sub_g = np.asarray(dec_r(_g_descr(
                    plan, scr_g, g_g, "cutrotate", 0x5EC4E7,
                    active_start=off_g
                ), 0))[0]
                save_rgb(
                    os.path.join(args.out, "pal_descrambled.png"), sub_g
                )
                report["pal_descrambled"] = round(psnr(sub_g, rgb), 2)
            if args.animate > 0:
                from color_modem_tpu.frame.image_io import save_gif

                if dec_notch is None:  # every standard offers notch today
                    _, dec_notch, _ = make_pipeline(
                        plan, "notch"
                    )
                crawl = [
                    np.asarray(dec_notch(enc(rgb[None], i), i))[0]
                    for i in range(args.animate)
                ]
                save_gif(os.path.join(args.out, f"{name}_crawl.gif"), crawl)
        # D2-MAC row (modem/mac.py): the time-multiplexed family — no
        # subcarrier, so the composite PNG shows burst/chroma/luma segments
        # side by side instead of a frequency interleave
        from color_modem_tpu.modem import mac as mac_mod

        lines = args.lines or 576
        rgb = (load_rgb(args.input, size=(args.width, lines))
               if args.input else
               color_bars(lines, args.width).astype(np.float32))
        mplan = mac_mod.make_mac_plan(args.width)
        import jax.numpy as jnp
        g = jnp.arange(lines)
        sig = mac_mod.encode(mplan, jnp.asarray(rgb), g)
        save_composite(os.path.join(args.out, "d2mac_signal.png"),
                       np.asarray(sig), lo=0.0, hi=1.0)
        out_m = np.asarray(mac_mod.decode(mplan, sig, g))
        save_rgb(os.path.join(args.out, "d2mac.png"), out_m)
        report["d2mac"] = round(psnr(out_m, rgb), 2)
        # PALplus row (VERDICT r4 item 2): the 625i service over the full
        # authentic stack — interlaced, rastered, VSB RF hop — rendered on
        # the helper-band vertical-detail fixture (a smooth scene plus a
        # 0.42-cycles/line vertical cosine, the test fixture: that band is
        # exactly what plain letterboxing destroys), with the
        # conventional-receiver zoom beside it so the helper's purchase is
        # visible (a zone plate looked striking but holds little energy in
        # the helper band — the pair read +0.6 dB where this reads +10)
        if (args.lines or 576) % 16 == 0:
            from color_modem_tpu.frame.palplus import (
                make_interlaced_palplus_pipeline,
            )
            from color_modem_tpu.frame.raster import make_raster
            from color_modem_tpu.frame.rf import (
                make_rf_plan, rf_demodulate, rf_modulate,
            )
            from color_modem_tpu.utils.testimages import smooth_scene

            pp_lines = args.lines or 576
            pp_plan = make_plan(ALL_STANDARDS["pal"](), args.width)
            if args.input:
                rgb_pp = load_rgb(args.input, size=(args.width, pp_lines))
            else:
                vert = 0.25 * np.cos(
                    2 * np.pi * 0.42 * np.arange(pp_lines)
                )[:, None]
                rgb_pp = np.clip(
                    smooth_scene(pp_lines, args.width, seed=3)
                    + vert[None], 0.0, 1.0
                ).astype(np.float32)
            enc_pp, dec_pp, _ = make_interlaced_palplus_pipeline(
                pp_plan, "comb3", raster=True
            )
            comp_pp = enc_pp(np.asarray(rgb_pp)[None], 0)
            rfp_pp = make_rf_plan(
                pp_plan, row_samples=make_raster(pp_plan).n_total
            )
            comp_pp = rf_demodulate(
                rfp_pp, rf_modulate(rfp_pp, comp_pp, 0), 0
            )
            for tag, use_h in (("palplus", True), ("palplus_zoom", False)):
                out_pp = np.asarray(
                    dec_pp(comp_pp, 0, use_helper=use_h)
                )[0]
                save_rgb(os.path.join(args.out, f"{tag}.png"), out_pp)
                report[tag] = round(psnr(out_pp, rgb_pp), 2)
        if args.fullstack:
            # the full-stack "authentic broadcast" row (VERDICT r3 item
            # 7), rendered through the SAME one-shot roundtrip CLI the
            # test drives (tests/test_fullstack.py) so the gallery image
            # and the asserted composition can never drift apart
            import contextlib
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main([
                    "roundtrip", "--standard", "pal", "--decoder", "comb3",
                    "--demo", "--pattern", "scene", "--lines", "576",
                    "--width", "1440", "--raster", "--interlaced",
                    "--teletext", "FULL STACK|AUTHENTIC BROADCAST",
                    "--wss", "16:9 full (anamorphic)",
                    "--vitc", "01:02:03:04", "--caption", "FULL STACK",
                    "--scramble", "cutrotate", "--rf", "--rf-audio",
                    "--rf-nicam",
                    "--output",
                    os.path.join(args.out, "pal_fullstack.png"),
                ])
            if rc != 0:
                # surface the sub-roundtrip's real failure, not the
                # JSONDecodeError its missing output would cause below
                # (round-4 advisor finding; a bare assert also vanishes
                # under python -O)
                raise SystemExit(
                    f"gallery --fullstack: sub-roundtrip failed (rc={rc});"
                    f" output:\n{buf.getvalue()}"
                )
            rep_fs = json.loads(buf.getvalue().strip().splitlines()[-1])
            report["pal_fullstack"] = rep_fs["psnr_db"]
            report["pal_fullstack_pirate"] = (
                rep_fs["scramble"]["pirate_psnr_db"]
            )
            report["pal_fullstack_services"] = {
                k: rep_fs[k]["exact"]
                for k in ("caption", "teletext", "wss", "vitc")
            }
            # the satellite variant of the same stack (VERDICT r4 item 8):
            # the authentic Astra plan — Videocrypt-scrambled service-laden
            # PAL over the FM hop with two audio subcarriers
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main([
                    "roundtrip", "--standard", "pal", "--decoder", "comb3",
                    "--demo", "--pattern", "scene", "--lines", "576",
                    "--width", "1440", "--raster", "--interlaced",
                    "--teletext", "FULL STACK|VIA ASTRA",
                    "--wss", "16:9 full (anamorphic)",
                    "--vitc", "01:02:03:04", "--caption", "FULL STACK",
                    "--scramble", "cutrotate",
                    "--satellite", "--sat-stereo",
                    "--output",
                    os.path.join(args.out, "pal_fullstack_satellite.png"),
                ])
            if rc != 0:
                raise SystemExit(
                    f"gallery --fullstack satellite: sub-roundtrip failed "
                    f"(rc={rc}); output:\n{buf.getvalue()}"
                )
            rep_sat = json.loads(buf.getvalue().strip().splitlines()[-1])
            report["pal_fullstack_satellite"] = rep_sat["psnr_db"]
            report["pal_fullstack_satellite_audio"] = (
                rep_sat["satellite"].get("audio_snr_db")
            )
            report["pal_fullstack_satellite_services"] = {
                k: rep_sat[k]["exact"]
                for k in ("caption", "teletext", "wss", "vitc")
            }
        print(json.dumps({"out": args.out, "psnr_db": report}))
        return 0

    if args.cmd == "video":
        import os

        import numpy as np

        from color_modem_tpu.frame.video import (
            process_video,
            synthetic_device_source,
            synthetic_source,
        )
        from color_modem_tpu.standards import ALL_STANDARDS

        cfg = ALL_STANDARDS[args.standard]()
        fps = (30000, 1001) if cfg.total_lines == 525 else (25, 1)
        if args.input:
            from color_modem_tpu.frame.y4m import prefetch_source, y4m_source

            source, clip_n, clip_h, clip_w = y4m_source(args.input)
            # double-buffered loader: next chunk's disk read + YCbCr decode
            # overlap the device compute on the current one
            source = prefetch_source(source, clip_n)
            lines, width = clip_h, clip_w
            n_frames = min(args.frames, clip_n) if args.frames else clip_n
            plan = make_plan(cfg, width)
        else:
            lines = args.lines or cfg.active_lines
            n_frames = args.frames or 32
            plan = make_plan(cfg, args.width)
        mesh = None
        if args.mesh:
            from color_modem_tpu.parallel import init_distributed, make_mesh

            init_distributed()
            f, l = (int(v) for v in args.mesh.split("x"))
            mesh = make_mesh(f, l)
        make_src = synthetic_source if args.host_source else synthetic_device_source
        # SPARSE dict — only non-default keys: the resume manifest compares
        # channel configs by equality, so a dict that always carried every
        # key would break resume of pre-existing runs whenever a new
        # impairment option is added
        sparse = {
            "noise_sigma": (args.noise, 0.0),
            "chroma_gain": (args.chroma_gain, 1.0),
            "chroma_phase_deg": (args.chroma_phase, 0.0),
            "diff_gain": (args.diff_gain, 0.0),
            "diff_phase_deg": (args.diff_phase, 0.0),
            "ghost_delay_us": (args.ghost_delay_us, 0.0),
            "ghost_gain": (args.ghost_gain, 0.0),
            "equalize": (args.equalize, False),
            "vhs": (args.vhs, False),
        }
        channel = {k: v for k, (v, dflt) in sparse.items() if v != dflt}
        # ghost delay alone (gain 0) is a no-op knob, not a channel config
        if set(channel) == {"ghost_delay_us"}:
            channel = {}
        channel = channel or None
        cap_bits = None
        if args.caption:
            from color_modem_tpu.frame.vbi import cc_pack

            text = args.caption.ljust(2 * n_frames)[: 2 * n_frames]
            if len(args.caption) > 2 * n_frames:
                raise SystemExit(
                    f"--caption: {len(args.caption)} chars need "
                    f"{(len(args.caption) + 1) // 2} frames, run has "
                    f"{n_frames}"
                )
            cap_bits = np.stack([
                np.asarray(cc_pack(text[2 * i : 2 * i + 2]))
                for i in range(n_frames)
            ])
        vid_audio = None
        vid_st = None  # (2, T) source pair when --rf-stereo (for SNRs)
        if args.rf_audio_in or args.rf_stereo:
            if not args.rf:
                raise SystemExit("--rf-audio-in/--rf-stereo ride the RF "
                                 "sound carrier: add --rf")
            n_samp = n_frames * lines * args.width
            if args.rf_audio_in:
                from color_modem_tpu.utils.wav import (
                    read_wav,
                    resample_linear,
                )

                wv, wr = read_wav(args.rf_audio_in)
                if args.rf_stereo and wv.shape[0] < 2:
                    wv = np.concatenate([wv, wv])
                tracks = resample_linear(
                    wv[: 2 if args.rf_stereo else 1], wr, plan.fs,
                    n_out=n_samp,
                ).astype(np.float32)
            else:  # --rf-stereo demo tones
                tt = np.arange(n_samp) / plan.fs
                tracks = np.stack([
                    (0.7 * np.sin(2 * np.pi * 1000 * tt)),
                    (0.5 * np.sin(2 * np.pi * 3000 * tt)),
                ]).astype(np.float32)
            if args.rf_stereo:
                from color_modem_tpu.frame.mts import mts_encode

                vid_st = tracks
                # the MTS multiplex is itself just a composite-rate
                # stream: the chunked runner carries it like mono audio,
                # phase-continuously; L/R come back out at the end
                vid_audio = np.asarray(
                    mts_encode(plan, tracks[:1], tracks[1:2])
                )[0].astype(np.float32)
            else:
                vid_audio = tracks[0]
        summary = process_video(
            plan,
            source if args.input else make_src(lines, args.width),
            n_frames,
            args.out,
            decoder=args.decoder,
            chunk=args.chunk,
            mesh=mesh,
            resume=not args.no_resume,
            lines=lines,
            channel=channel,
            interlaced=args.interlaced,
            nr=args.nr is not None,
            nr_sigma=args.nr,
            rf=args.rf,
            rf_audio=vid_audio,
            rf_audio_bw=50e3 if args.rf_stereo else 15e3,
            satellite=args.satellite or args.sat_cnr is not None,
            sat_cnr=args.sat_cnr,
            save_outputs=args.output is not None,
            caption_bits=cap_bits,
            scramble=((args.scramble, args.scramble_key)
                      if args.scramble else None),
        )
        if vid_audio is not None and (args.audio_out or vid_st is not None):
            import glob as _glob

            from color_modem_tpu.utils.wav import resample_linear, write_wav

            rec = np.concatenate([
                np.load(p) for p in sorted(
                    _glob.glob(os.path.join(args.out, "aud_*.npy"))
                )
            ])
            if vid_st is not None:
                from color_modem_tpu.frame.mts import mts_decode

                l2, r2, pilot = mts_decode(plan, rec[None])
                chans = np.stack([np.asarray(l2)[0], np.asarray(r2)[0]])
                crop = min(16384, rec.size // 4)

                def _snr(got, want):
                    e = got[crop:-crop] - want[crop:-crop]
                    return round(float(10 * np.log10(
                        max(float(np.mean(want[crop:-crop] ** 2)), 1e-20)
                        / max(float(np.mean(e ** 2)), 1e-20)
                    )), 2)

                summary["stereo"] = {
                    "left_snr_db": _snr(chans[0], vid_st[0]),
                    "right_snr_db": _snr(chans[1], vid_st[1]),
                    "pilot": round(float(np.mean(np.asarray(pilot))), 4),
                }
            else:
                chans = rec[None]
            if args.audio_out:
                write_wav(args.audio_out,
                          resample_linear(chans, plan.fs, 48000.0), 48000)
                summary["audio_out"] = args.audio_out
        if args.caption:
            # receiver text: assemble the per-chunk decoded cells
            import glob
            import os

            import numpy as np

            from color_modem_tpu.frame.vbi import cc_unpack

            files = sorted(glob.glob(os.path.join(args.out, "cc_*.npy")))
            got, ok = [], True
            for p in files:
                for row in np.load(p):
                    s, good = cc_unpack(row)
                    got.append(s)
                    ok = ok and good
            received = "".join(got)
            summary["caption"] = {
                "sent": text.rstrip(),
                "received": received.rstrip(),
                "exact": received == text and ok,
                "parity_ok": ok,
            }
        if args.output:
            # assemble the per-chunk decoded outputs into one clip (reads
            # in chunk order; resume-friendly — every finished chunk left
            # its rgb_*.npy behind)
            import glob
            import os

            import numpy as np

            from color_modem_tpu.frame.y4m import write_y4m

            files = sorted(glob.glob(os.path.join(args.out, "rgb_*.npy")))
            written = write_y4m(
                args.output, (np.load(p) for p in files), fps=fps
            )
            summary["output"] = args.output
            summary["output_frames"] = written
            if written != n_frames:
                summary["output_incomplete"] = (
                    "some chunks predate --output (resumed run without "
                    "save_outputs) — rerun with --no-resume to regenerate"
                )
        print(json.dumps(summary))
        return 0

    if args.cmd == "decode":
        from color_modem_tpu.standards import ALL_STANDARDS

        rgb, cfg = None, ALL_STANDARDS[args.standard]()
    else:
        rgb, cfg = _load_input(args)
    plan = make_plan(cfg, args.width)
    interlaced = getattr(args, "interlaced", False)
    svideo = getattr(args, "svideo", False)
    _wants_rf = any(
        getattr(args, k, None) not in (None, False, 0.0, "sync")
        for k in ("rf", "rf_noise", "rf_recover", "rf_audio", "rf_stereo",
                  "rf_nicam", "rf_detection", "rf_phase_error", "rf_agc",
                  "rf_freq_error", "rf_aft", "rf_ghost_gain",
                  "rf_equalize", "rf_audio_in", "audio_out")
    ) or getattr(args, "rf_gain", 1.0) != 1.0
    if getattr(args, "rf_agc", False) and not getattr(args, "raster", False):
        raise SystemExit(
            "--rf-agc needs --raster: the AGC is keyed on the sync tip, "
            "which only exists in a rastered composite"
        )
    if getattr(args, "rf_agc", False) and getattr(args, "rf_equalize", False):
        raise SystemExit(
            "--rf-agc and --rf-equalize don't combine: the equalizer "
            "corrects gain itself (a flat gain is a linear channel), and "
            "AGC-normalizing only the picture path would double-correct"
        )
    if svideo:
        if interlaced or args.raster or getattr(args, "burst_locked", False):
            raise SystemExit(
                "--svideo does not combine with --interlaced/--raster/"
                "--burst-locked (separate wires carry no raster)"
            )
        if _wants_rf:
            raise SystemExit(
                "--svideo does not combine with --rf* (the RF layer "
                "transmits the single composite wire; Y/C are two wires)"
            )
        if getattr(args, "caption", None) or getattr(args, "teletext", None):
            raise SystemExit(
                "--svideo does not combine with --caption/--teletext (the "
                "data line rides the composite wire)"
            )
        from color_modem_tpu.frame.svideo import make_svideo_pipeline

        encode, decode, _ = make_svideo_pipeline(plan)
    elif interlaced:
        if getattr(args, "burst_locked", False):
            raise SystemExit(
                "--interlaced does not combine with --burst-locked"
            )
        from color_modem_tpu.frame.interlace import make_interlaced_pipeline

        encode, decode, _ = make_interlaced_pipeline(
            plan, args.decoder, raster=args.raster
        )
    else:
        encode, decode, _ = make_pipeline(
            plan, args.decoder, raster=args.raster
        )
    result = {"standard": args.standard, "decoder": args.decoder,
              "width": args.width,
              "device": jax.default_backend(), "raster": args.raster}
    if interlaced:
        result["interlaced"] = True
    if svideo:
        result["svideo"] = True
        result["decoder"] = "svideo"

    t0 = time.perf_counter()
    if args.cmd == "encode":
        comp = np.asarray(jax.block_until_ready(encode(rgb[None], args.frame)))[0]
        save_composite(args.output, comp)
        if args.raw:
            np.save(args.raw, comp)
        result.update(output=args.output, lines=comp.shape[0])
    elif args.cmd == "decode":
        comp = np.load(args.input).astype(np.float32)
        out = np.asarray(jax.block_until_ready(decode(comp[None], args.frame)))[0]
        save_rgb(args.output, out)
        result.update(output=args.output, lines=comp.shape[0])
    else:  # roundtrip
        from color_modem_tpu.frame.channel import impair

        n_vits = 0
        if getattr(args, "vits", False):
            # VITS: test stimuli REPLACE the bottom rows of the input
            # frame BEFORE encoding, so they are modulated with the
            # correct per-line phase and ride every channel/RF/receiver
            # stage — in-service measurement, the way broadcast plants
            # actually monitored themselves
            if svideo or interlaced:
                raise SystemExit(
                    "--vits does not combine with --svideo/--interlaced"
                )
            from color_modem_tpu.frame.measure import (
                modulated_staircase,
                multiburst,
            )

            k = 4
            is_qam = not plan.cfg.is_fm
            n_vits = (2 * k) if is_qam else k
            if rgb.shape[1] < 2 * n_vits:
                raise SystemExit(
                    f"--vits needs >= {2*n_vits} lines, frame has "
                    f"{rgb.shape[1]}"
                )
            rgb = np.asarray(rgb).copy()
            if is_qam:
                rgb[:, -2 * k: -k] = modulated_staircase(
                    plan, k, rgb.shape[2]
                )
            rgb[:, -k:] = multiburst(plan, k)[..., : rgb.shape[2]]
        # interlaced encode of one frame yields TWO field blocks, so the
        # composite is kept batch-shaped — and device-resident (no host
        # round trip between the stages) — throughout
        comp_b = encode(rgb[None], args.frame)
        cap_rows, cap_text, cap_spec = 0, None, None
        if args.caption:
            # line-21 style caption cells on the top rows (a still frame
            # stacks what a broadcast spreads over successive frames);
            # they ride every channel/RF stage below like real data lines
            from color_modem_tpu.frame.vbi import (
                cc_pack,
                cc_spec,
                encode_data_line,
            )

            cap_text = args.caption + (" " if len(args.caption) % 2 else "")
            cells = [cap_text[i:i + 2] for i in range(0, len(cap_text), 2)]
            cap_rows = len(cells)
            if cap_rows > rgb.shape[1] // 4:
                raise SystemExit(
                    f"--caption: {len(cap_text)} chars need {cap_rows} "
                    f"data rows — too many for a {rgb.shape[1]}-line frame"
                )
            cap_spec = cc_spec(plan)
            cap_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                cap_off = make_raster(plan).n_blank
            for r, cell in enumerate(cells):
                wave = encode_data_line(plan, cap_spec, cc_pack(cell))
                comp_b = comp_b.at[0, r, cap_off:].set(wave)
        ttx_rows, ttx_texts = 0, None
        if args.teletext:
            # WST teletext page on the rows after the captions; decoded
            # off the received composite like the caption cells
            from color_modem_tpu.frame import teletext as ttx_mod

            ttx_texts = args.teletext.split("|")
            try:
                ttx_mod.wst_spec(plan)  # validate the grid before encoding
            except ValueError as e:
                raise SystemExit(f"--teletext: {e}")
            n_need = 1 + len(ttx_texts)
            if cap_rows + n_need > rgb.shape[1] // 2:
                raise SystemExit(
                    f"--teletext: {n_need} data rows (header + "
                    f"{len(ttx_texts)}) don't fit a {rgb.shape[1]}-line "
                    f"frame alongside {cap_rows} caption rows"
                )
            ttx_header = f"P100 {plan.cfg.name.upper()}"
            waves = ttx_mod.encode_page(
                plan, 1, 0x00, ttx_texts, header=ttx_header
            )
            ttx_rows = int(waves.shape[0])
            cap_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                cap_off = make_raster(plan).n_blank
            comp_b = comp_b.at[
                0, cap_rows:cap_rows + ttx_rows, cap_off:
            ].set(waves)
        ident_rows = 0
        if args.secam_ident:
            if not plan.cfg.is_fm:
                raise SystemExit("--secam-ident is a SECAM feature")
            if interlaced or svideo:
                raise SystemExit(
                    "--secam-ident does not combine with "
                    "--interlaced/--svideo"
                )
            from color_modem_tpu.frame.pipeline import frame_line_index
            from color_modem_tpu.modem import secam as secam_mod

            if args.caption or args.teletext or args.wss:
                raise SystemExit(
                    "--secam-ident shares the top rows with the data-line "
                    "options; use it alone"
                )
            ident_rows = 4
            # with --raster the bottles ride the ACTIVE region of normal
            # rastered lines (sync/blanking intact), as broadcast
            ident_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                ident_off = make_raster(plan).n_blank
            g_tx = frame_line_index(plan, args.frame, 1, rgb.shape[1])
            comp_b = comp_b.at[:, :ident_rows, ident_off:].set(
                secam_mod.ident_lines(plan, g_tx[:, :ident_rows])
            )
        vir_rows = 0
        if getattr(args, "vir", False):
            if plan.cfg.is_fm:
                raise SystemExit(
                    "--vir needs a QAM subcarrier (FM chroma has no "
                    "amplitude/phase to reference)"
                )
            if svideo or args.burst_locked:
                # burst-locked decoding measures the SAME phase/gain the
                # VIR would — the two corrections would fight
                raise SystemExit(
                    "--vir does not combine with --svideo/--burst-locked"
                )
            if interlaced and args.decoder in ("comb3d", "comb3dA"):
                raise SystemExit(
                    "--vir --interlaced decodes per field with per-field "
                    "corrections; the temporal combs need frame batches"
                )
            if (args.caption or args.teletext or args.secam_ident
                    or args.wss or args.vitc):
                raise SystemExit(
                    "--vir shares the top rows with the other data-line "
                    "options; use it alone"
                )
            from color_modem_tpu.frame.vir import vir_lines

            vir_rows = 2
            # with --raster the references ride normal rastered lines'
            # active region, like the real line 19
            vir_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                vir_off = make_raster(plan).n_blank
            if interlaced:
                # one reference line atop EACH field (the real line 19
                # rode every field's vertical interval); the two rows
                # weave to the frame's top 2 rows for the accounting
                from color_modem_tpu.frame.interlace import (
                    field_line_index,
                )

                g_vir = field_line_index(
                    plan, args.frame, 1, rgb.shape[1] // 2
                )
                comp_b = comp_b.at[:, :1, vir_off:].set(
                    vir_lines(plan, g_vir[:, :1])
                )
            else:
                from color_modem_tpu.frame.pipeline import (
                    frame_line_index,
                )

                g_vir = frame_line_index(plan, args.frame, 1, rgb.shape[1])
                comp_b = comp_b.at[:, :vir_rows, vir_off:].set(
                    vir_lines(plan, g_vir[:, :vir_rows])
                )
        wss_row = -1
        if args.wss:
            from color_modem_tpu.frame import wss as wss_mod

            if args.wss not in wss_mod.ASPECT_CODES:
                raise SystemExit(
                    f"--wss: unknown aspect {args.wss!r}; one of "
                    f"{sorted(wss_mod.ASPECT_CODES)}"
                )
            wss_row = cap_rows + ttx_rows
            wss_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                wss_off = make_raster(plan).n_blank
            comp_b = comp_b.at[0, wss_row, wss_off:].set(
                wss_mod.encode_wss(plan, wss_mod.wss_word(args.wss))
            )
        vitc_row = -1
        vitc_sent = None
        if args.vitc:
            from color_modem_tpu.frame import vitc as vitc_mod

            try:
                hh, mm, ss, ff = (int(v) for v in args.vitc.split(":"))
            except ValueError:
                raise SystemExit(f"--vitc: want HH:MM:SS:FF, got {args.vitc!r}")
            vitc_sent = (hh, mm, ss, ff)
            vitc_row = cap_rows + ttx_rows + (1 if wss_row >= 0 else 0)
            vitc_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                vitc_off = make_raster(plan).n_blank
            comp_b = comp_b.at[0, vitc_row, vitc_off:].set(
                vitc_mod.encode_vitc_line(
                    plan, vitc_mod.vitc_pack(hh, mm, ss, ff)
                )
            )
        pirate_comp = None
        scr_off = 0
        if getattr(args, "scramble", None):
            # transmitter-side scrambling of the finished composite
            # (after the data services — they descramble bit-exactly
            # like the picture).  Composes with --raster (the authentic
            # configuration: active video scrambles, sync + burst stay in
            # the clear so the receiver can lock), --interlaced (the key
            # schedule follows the transmitted field-sequential line
            # numbering) and the --rf / --satellite hops (Sky's analog
            # Videocrypt really rode Astra's satellite FM).
            if svideo:
                raise SystemExit(
                    "--scramble does not combine with --svideo (scrambling "
                    "is a single-wire composite operation)"
                )
            if args.equalize or args.tbc:
                raise SystemExit(
                    "--scramble does not combine with --equalize/--tbc "
                    "(both lock onto stream continuity the scrambled "
                    "signal deliberately destroys; descramble first)"
                )
            from color_modem_tpu.frame.scramble import (
                SHUFFLE_WINDOW,
                scramble as _scr,
            )

            _scr_rows = rgb.shape[1] // 2 if interlaced else rgb.shape[1]
            if args.scramble == "shuffle" and _scr_rows % SHUFFLE_WINDOW:
                raise SystemExit(
                    f"--scramble shuffle permutes within {SHUFFLE_WINDOW}-"
                    f"line windows: needs the {'field' if interlaced else 'frame'} "
                    f"line count ({_scr_rows}) divisible by {SHUFFLE_WINDOW}"
                )
            if interlaced:
                from color_modem_tpu.frame.interlace import field_line_index

                g_scr = field_line_index(
                    plan, args.frame, 1, rgb.shape[1] // 2
                )
            else:
                from color_modem_tpu.frame.pipeline import frame_line_index

                g_scr = frame_line_index(plan, args.frame, 1, rgb.shape[1])
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                scr_off = make_raster(plan).n_blank
            comp_b = _scr(plan, comp_b, g_scr, args.scramble,
                          args.scramble_key, active_start=scr_off)
        sat_sound = bool(args.sat_audio or args.sat_stereo
                         or args.sat_audio_in)
        sat_hop = args.satellite or args.sat_cnr is not None or sat_sound
        if sat_hop:
            if args.rf or args.rf_noise > 0.0:
                raise SystemExit(
                    "--satellite (FM) and --rf (VSB-AM) are different "
                    "transmission layers; pick one"
                )
            import jax.numpy as jnp

            from color_modem_tpu.frame import satellite as sat_mod

            b_s, l_s, n_row = comp_b.shape
            n_tot = l_s * n_row
            k_subs = 0
            sat_tx = None
            if sat_sound:
                k_subs = 2 if args.sat_stereo else 1
                if args.sat_audio_in:
                    from color_modem_tpu.utils.wav import (
                        read_wav,
                        resample_linear,
                    )

                    wx, wr = read_wav(args.sat_audio_in)
                    if args.sat_stereo or wx.shape[0] >= 2:
                        k_subs = 2
                    wav = resample_linear(wx, wr, plan.fs, n_out=n_tot)
                    sat_tx = np.stack(
                        [wav[min(i, wav.shape[0] - 1)] for i in range(k_subs)]
                    ).astype(np.float32)
                else:
                    # demo tones, snapped to frame-periodic bins (the
                    # satellite block is ONE PERIOD — frame/satellite.py)
                    t_s = np.arange(n_tot) / plan.fs

                    def _bin_tone(f, amp):
                        kk = max(1, round(f * n_tot / plan.fs))
                        return amp * np.sin(
                            2 * np.pi * (kk * plan.fs / n_tot) * t_s
                        )

                    if k_subs == 2:
                        sat_tx = np.stack(
                            [_bin_tone(1000, 0.7), _bin_tone(3000, 0.5)]
                        ).astype(np.float32)
                    else:
                        sat_tx = (_bin_tone(1000, 0.6)
                                  + _bin_tone(7000, 0.3)).astype(
                            np.float32
                        )[None]
            sp = sat_mod.make_sat_plan(
                plan.fs, n_row,
                total_lines=plan.cfg.total_lines, audio_subs=k_subs,
            )
            key = jax.random.PRNGKey(11)
            comp_tx = comp_b
            sat_rf = sat_mod.fm_modulate(
                sp, comp_b,
                audio=(jnp.asarray(
                    np.broadcast_to(sat_tx, (b_s, k_subs, n_tot))
                ) if k_subs else None),
            )
            if args.sat_cnr is not None:
                sat_rf = sat_mod.awgn(sp, sat_rf, key, args.sat_cnr)
            comp_b = sat_mod.fm_demodulate(sp, sat_rf)
            sat_transparency = float(
                psnr(np.asarray(comp_b), np.asarray(comp_tx))
            )
            result["satellite"] = {
                "deviation_mhz": round(sp.deviation / 1e6, 1),
                "fs_rf_mhz": round(sp.fs_rf / 1e6, 2),
                "transparency_db": round(sat_transparency, 2),
                **({"cnr_db": args.sat_cnr}
                   if args.sat_cnr is not None else {}),
            }
            print(
                "satellite FM hop: transparency "
                f"{sat_transparency:.1f} dB"
                + (f" at CNR {args.sat_cnr} dB" if args.sat_cnr is not None
                   else " (noise-free)")
            )
            if k_subs:
                sat_rx = np.asarray(
                    sat_mod.fm_demodulate_audio(sp, sat_rf)
                )[0]
                snrs = []
                for i in range(k_subs):
                    ref = sat_tx[i] - sat_tx[i].mean()  # rx is AC-coupled
                    err = sat_rx[i] - ref
                    snrs.append(round(float(
                        10 * np.log10(np.mean(ref ** 2)
                                      / max(np.mean(err ** 2), 1e-30))
                    ), 1))
                subs_mhz = [round(f / 1e6, 2) for f in sp.sub_freqs]
                result["satellite"]["subcarriers_mhz"] = subs_mhz
                result["satellite"]["audio_snr_db"] = snrs
                print(
                    f"satellite sound: {k_subs} FM subcarrier(s) at "
                    f"{subs_mhz} MHz, audio SNR {snrs} dB"
                )
                if args.audio_out:
                    from color_modem_tpu.utils.wav import (
                        resample_linear,
                        write_wav,
                    )

                    write_wav(
                        args.audio_out,
                        resample_linear(sat_rx, plan.fs, 48000.0),
                        48000,
                    )
                    print(f"wrote {args.audio_out}")
        if (args.rf or args.rf_noise > 0.0 or args.rf_recover or args.rf_audio
                or args.rf_stereo or args.rf_nicam or args.rf_a2
                or args.rf_dropouts > 0.0 or args.rf_doc
                or args.rf_detection != "sync" or args.rf_phase_error != 0.0
                or args.rf_gain != 1.0 or args.rf_agc
                or args.rf_freq_error != 0.0 or args.rf_aft
                or args.rf_ghost_gain != 0.0 or args.rf_equalize
                or args.rf_audio_in or (args.audio_out and not sat_hop)):
            # RF hop first (it IS the transmission); the composite-level
            # impairments below then model the receiver-side degradations
            import dataclasses

            from color_modem_tpu.frame.rf import (
                make_rf_plan,
                recover_carrier_phase,
                rf_demodulate,
                rf_modulate,
            )

            rf_kw = {}
            if args.rf_stereo:
                # MTS needs the wider sound channel (sidebands ~45 kHz)
                rf_kw["audio_bw"] = 50e3
            rf_row = None
            if args.raster:
                # rastered lines are longer rows on the same sample clock;
                # the carrier law must snap to the actual row length
                from color_modem_tpu.frame.raster import make_raster

                rf_row = make_raster(plan).n_total
                rf_kw["row_samples"] = rf_row
            rfp = make_rf_plan(plan, **rf_kw)
            # a channel carrier offset = transmitting on a rotated carrier
            # (the receiver's mixers stay nominal)
            tx_rfp = rfp if args.rf_phase_error == 0.0 else dataclasses.replace(
                rfp, ramp=rfp.ramp + np.deg2rad(args.rf_phase_error)
            )
            audio = None
            b_rf, l_rf, n_rf = comp_b.shape
            t = np.arange(l_rf * n_rf) / plan.fs
            wav_in = None
            if args.rf_audio_in:
                # real audio: resample the file to the composite grid
                # (one audio sample per video sample — frame/rf.py)
                from color_modem_tpu.utils.wav import read_wav, resample_linear

                wav_x, wav_rate = read_wav(args.rf_audio_in)
                wav_in = resample_linear(
                    wav_x, wav_rate, plan.fs, n_out=l_rf * n_rf
                )
            a2_l = a2_r = None
            if args.rf_a2:
                if args.rf_stereo:
                    raise SystemExit(
                        "--rf-a2 and --rf-stereo are different stereo "
                        "systems (A2 two-carrier vs MTS multiplex); "
                        "pick one"
                    )
                if args.rf_nicam:
                    raise SystemExit(
                        "--rf-a2 and --rf-nicam cannot share a channel: "
                        "A2's second carrier (FM sound + 15.5 fh = "
                        "+242 kHz) sits inside NICAM's lower sideband "
                        "(+245..755 kHz) — no real channel plan carried "
                        "both (Germany used A2, NICAM countries NICAM); "
                        "pick one"
                    )
                if wav_in is not None:
                    st = wav_in if wav_in.shape[0] >= 2 else np.concatenate(
                        [wav_in, wav_in]
                    )
                    a2_l, a2_r = st[0], st[1]
                else:
                    a2_l = (0.6 * np.sin(2 * np.pi * 800 * t)
                            + 0.2 * np.sin(2 * np.pi * 5000 * t)).astype(
                        np.float32
                    )
                    a2_r = (0.5 * np.sin(2 * np.pi * 2300 * t)).astype(
                        np.float32
                    )
                a2_l = np.broadcast_to(a2_l, (b_rf, l_rf * n_rf))
                a2_r = np.broadcast_to(a2_r, (b_rf, l_rf * n_rf))
                import jax.numpy as jnp

                # carrier 1: compatible mono sum (stereo) or program 1
                audio = jnp.asarray(
                    0.5 * (a2_l + a2_r) if args.rf_a2 == "stereo" else a2_l
                )
            elif args.rf_stereo:
                from color_modem_tpu.frame.mts import mts_encode

                if wav_in is not None:
                    st = wav_in if wav_in.shape[0] >= 2 else np.concatenate(
                        [wav_in, wav_in]
                    )
                    st_l = np.broadcast_to(st[0], (b_rf, l_rf * n_rf))
                    st_r = np.broadcast_to(st[1], (b_rf, l_rf * n_rf))
                else:
                    st_l = np.broadcast_to(
                        (0.7 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32),
                        (b_rf, l_rf * n_rf),
                    )
                    st_r = np.broadcast_to(
                        (0.5 * np.sin(2 * np.pi * 3000 * t)).astype(np.float32),
                        (b_rf, l_rf * n_rf),
                    )
                audio = mts_encode(plan, st_l, st_r, row_samples=rf_row)
            elif args.rf_audio or wav_in is not None:
                import jax.numpy as jnp

                mono = (
                    wav_in[0] if wav_in is not None else
                    (0.6 * np.sin(2 * np.pi * 1000 * t)
                     + 0.3 * np.sin(2 * np.pi * 7000 * t)).astype(np.float32)
                )
                audio = jnp.asarray(
                    np.broadcast_to(mono, (b_rf, l_rf * n_rf))
                )
            rf_sig = rf_modulate(tx_rfp, comp_b, args.frame, audio,
                                 df=args.rf_freq_error)
            a2p = None
            if args.rf_a2:
                from color_modem_tpu.frame import a2 as a2_mod

                a2p = a2_mod.make_a2_plan(rfp)
                import jax.numpy as jnp

                rf_sig = a2_mod.a2_on_rf(
                    a2p, rf_sig, args.frame,
                    jnp.asarray(a2_r), args.rf_a2,
                )
            nic_l = nic_r = None
            nic_cap = 0
            if args.rf_nicam:
                from color_modem_tpu.frame import nicam as nicam_mod

                nic_cap = nicam_mod.nicam_capacity(rfp, rf_sig.shape)
                if nic_cap < 1:
                    raise SystemExit(
                        "--rf-nicam: the RF block is shorter than one "
                        "728-bit NICAM frame (~1 ms) — raise --lines"
                    )
                na = nicam_mod.BLOCK * nic_cap
                ta = np.arange(na) / 32000.0
                nic_l = (0.7 * np.sin(2 * np.pi * 1000 * ta)).astype(
                    np.float32
                )
                nic_r = (0.5 * np.sin(2 * np.pi * 3000 * ta)).astype(
                    np.float32
                )
                rf_sig = nicam_mod.nicam_on_rf(rfp, rf_sig, nic_l, nic_r)
            if args.rf_gain != 1.0:
                # channel attenuation scales the carrier; receiver noise
                # below is added AFTER it (noise lives at the receiver)
                rf_sig = args.rf_gain * rf_sig
            if args.rf_ghost_gain != 0.0:
                from color_modem_tpu.frame.rf import rf_ghost

                rf_sig = rf_ghost(rfp, rf_sig, args.rf_ghost_delay_us,
                                  args.rf_ghost_gain)
            if args.rf_dropouts > 0.0:
                from color_modem_tpu.frame.rf import rf_dropout

                rf_sig = rf_dropout(rfp, rf_sig, 7, rate=args.rf_dropouts)
            if args.rf_noise > 0.0:
                rf_sig = rf_sig + args.rf_noise * jax.random.normal(
                    jax.random.PRNGKey(2), rf_sig.shape, dtype=rf_sig.dtype
                )
            pe = 0.0
            df_hat = None
            if args.rf_aft:
                # AFT: estimate the offset, digitally retune the stream
                # back onto the Nyquist flank, then the standard phase
                # recovery below locks the leftover static phase
                from color_modem_tpu.frame.rf import (
                    recover_carrier_frequency,
                    rf_retune,
                )

                df_hat = float(np.asarray(
                    recover_carrier_frequency(rfp, rf_sig, args.frame)
                )[0])
                rf_sig = rf_retune(rfp, rf_sig, df_hat, args.frame)
            if args.rf_recover or args.rf_aft:
                # circular mean: naive averaging of atan2 angles is wrong
                # near the +-pi wrap (+179 and -179 would average to ~0)
                est = np.asarray(
                    recover_carrier_phase(rfp, rf_sig, args.frame)
                )
                pe = float(np.arctan2(
                    np.mean(np.sin(est)), np.mean(np.cos(est))
                ))
            comp_b = rf_demodulate(
                rfp, rf_sig, args.frame, args.rf_detection, pe,
                doc=args.rf_doc, agc=args.rf_agc,
            )
            if args.rf_equalize:
                # receiver GCR path: the reference record rides the SAME
                # RF chain (its own noise realization), estimation and
                # correction about the zero-carrier pivot (an RF channel
                # is linear in the envelope, not the composite)
                import jax.numpy as jnp

                from color_modem_tpu.frame.equalize import (
                    apply_equalizer,
                    design_equalizer,
                    gcr_record_guarded,
                )
                from color_modem_tpu.frame.rf import rf_ghost

                g = jnp.asarray(
                    gcr_record_guarded(plan, samples=rf_row)
                )[None]
                g_rf = rf_modulate(tx_rfp, g, args.frame,
                                   df=args.rf_freq_error)
                if args.rf_gain != 1.0:
                    g_rf = args.rf_gain * g_rf
                if args.rf_ghost_gain != 0.0:
                    g_rf = rf_ghost(rfp, g_rf, args.rf_ghost_delay_us,
                                    args.rf_ghost_gain)
                if args.rf_noise > 0.0:
                    g_rf = g_rf + args.rf_noise * jax.random.normal(
                        jax.random.PRNGKey(3), g_rf.shape, dtype=g_rf.dtype
                    )
                if args.rf_aft:
                    g_rf = rf_retune(rfp, g_rf, df_hat, args.frame)
                rx_g = rf_demodulate(
                    rfp, g_rf, args.frame, args.rf_detection, pe
                )[0][:3]
                per = 2 * (rf_row or plan.n_samples)
                ntaps = min(1281, per - 1)
                ntaps -= 1 - ntaps % 2
                pv = rfp.video_zero
                taps = design_equalizer(
                    plan, rx_g, ntaps=ntaps,
                    reg=1e-4 if args.rf_noise == 0.0 else 1e-3, pivot=pv,
                )
                comp_b = apply_equalizer(comp_b, taps, pivot=pv)
            audio_snr = None
            stereo_report = None
            a2_report = None
            audio_rec = None  # recovered (channels, n) at composite rate
            if args.rf_a2:
                # interlaced: the two fields are consecutive broadcast
                # time — the ident-mode decision integrates over the
                # field PAIR (a single field is a sub-cycle window for
                # the 117/274 Hz ident tones; a2_detect_mode docstring)
                gl, gr, a2_info = a2_mod.a2_decode(
                    a2p, rf_sig, args.frame, group=2 if interlaced else 1
                )
                audio_rec = np.stack([gl[0], gr[0]])
                crop = min(8192, gl.shape[-1] // 4)
                want_l = (0.5 * (a2_l + a2_r)
                          if a2_info["mode"][0] == "mono" else a2_l)
                want_r = (a2_r if a2_info["mode"][0] != "mono"
                          else want_l)

                def _a2snr(got, want):
                    e = got[:, crop:-crop] - want[:, crop:-crop]
                    return round(10.0 * np.log10(
                        max(float(np.mean(want[:, crop:-crop] ** 2)), 1e-20)
                        / max(float(np.mean(e ** 2)), 1e-20)
                    ), 2)

                a2_report = {
                    "mode_sent": args.rf_a2,
                    "mode_detected": a2_info["mode"][0],
                    "left_snr_db": _a2snr(gl, want_l),
                    "right_snr_db": _a2snr(gr, want_r),
                    "pilot_level": round(float(a2_info["pilot_level"][0]), 4),
                    "carrier2_mhz": round(a2p.f_snd2 / 1e6, 4),
                }
            elif args.rf_stereo:
                from color_modem_tpu.frame.mts import mts_decode
                from color_modem_tpu.frame.rf import rf_demodulate_sound

                aud = rf_demodulate_sound(rfp, rf_sig, args.frame)
                l2, r2, pilot = mts_decode(plan, aud, row_samples=rf_row)
                audio_rec = np.stack(
                    [np.asarray(l2)[0], np.asarray(r2)[0]]
                )
                crop = min(16384, aud.shape[-1] // 4)

                def _snr(got, want):
                    e = np.asarray(got)[:, crop:-crop] - want[:, crop:-crop]
                    return 10.0 * np.log10(
                        np.mean(want[:, crop:-crop] ** 2)
                        / max(float(np.mean(e**2)), 1e-20)
                    )

                stereo_report = {
                    "left_snr_db": round(float(_snr(l2, st_l)), 2),
                    "right_snr_db": round(float(_snr(r2, st_r)), 2),
                    "pilot": round(float(np.mean(np.asarray(pilot))), 4),
                }
            elif args.rf_audio or args.rf_audio_in:
                from color_modem_tpu.frame.rf import rf_demodulate_sound

                aud = np.asarray(rf_demodulate_sound(rfp, rf_sig, args.frame))
                audio_rec = aud[:1]
                a_ref = np.asarray(audio)
                crop = min(8192, aud.shape[-1] // 4)  # audio-LPF transient
                err = aud[:, crop:-crop] - a_ref[:, crop:-crop]
                audio_snr = 10.0 * np.log10(
                    max(float(np.mean(a_ref[:, crop:-crop] ** 2)), 1e-20)
                    / max(float(np.mean(err**2)), 1e-20)
                )
            nicam_report = None
            if args.rf_nicam:
                from color_modem_tpu.frame import nicam as nicam_mod

                n_l, n_r, n_rep, n_lock = nicam_mod.nicam_from_rf(
                    rfp, rf_sig, nic_cap
                )

                def _nsnr(got, want):
                    e = np.asarray(got) - want
                    return 10.0 * np.log10(
                        max(float(np.mean(want**2)), 1e-20)
                        / max(float(np.mean(e**2)), 1e-20)
                    )

                nicam_report = {
                    "frames": nic_cap,
                    "left_snr_db": round(_nsnr(n_l, nic_l), 2),
                    "right_snr_db": round(_nsnr(n_r, nic_r), 2),
                    "parity_errors": int(
                        np.asarray(n_rep["parity_errors"]).sum()
                    ),
                    "faw_ok": bool(np.asarray(n_rep["faw_ok"]).all()),
                    "offset_bits": int(np.asarray(n_lock["offset_bits"])),
                }
            if args.audio_out:
                if audio_rec is None:
                    raise SystemExit(
                        "--audio-out needs a sound transmission: add "
                        "--rf-audio, --rf-audio-in or --rf-stereo"
                    )
                from color_modem_tpu.utils.wav import (
                    resample_linear,
                    write_wav,
                )

                write_wav(
                    args.audio_out,
                    resample_linear(audio_rec, plan.fs, 48000.0),
                    48000,
                )
                result["audio_out"] = args.audio_out
            result["rf"] = {
                "fc_mhz": round(rfp.fc / 1e6, 3),
                "f_snd_mhz": round(rfp.f_snd / 1e6, 3),
                "fs_rf_mhz": round(rfp.fs_rf / 1e6, 2),
                "detection": args.rf_detection,
                **({"noise": args.rf_noise} if args.rf_noise else {}),
                **({"dropouts": args.rf_dropouts, "doc": args.rf_doc}
                   if args.rf_dropouts or args.rf_doc else {}),
                **({"phase_error_deg": args.rf_phase_error}
                   if args.rf_phase_error else {}),
                **({"gain": args.rf_gain, "agc": args.rf_agc}
                   if args.rf_gain != 1.0 or args.rf_agc else {}),
                **({"ghost_delay_us": args.rf_ghost_delay_us,
                    "ghost_gain": args.rf_ghost_gain}
                   if args.rf_ghost_gain else {}),
                **({"equalized": True} if args.rf_equalize else {}),
                **({"recovered_phase_deg": round(float(np.degrees(pe)), 2)}
                   if args.rf_recover or args.rf_aft else {}),
                **({"freq_error_hz": args.rf_freq_error}
                   if args.rf_freq_error else {}),
                **({"aft_recovered_hz": round(df_hat, 1)}
                   if df_hat is not None else {}),
                **({"audio_snr_db": round(float(audio_snr), 2)}
                   if audio_snr is not None else {}),
                **({"stereo": stereo_report}
                   if stereo_report is not None else {}),
                **({"a2": a2_report} if a2_report is not None else {}),
                **({"nicam": nicam_report}
                   if nicam_report is not None else {}),
            }
        channel = {"noise": args.noise, "chroma_gain": args.chroma_gain,
                   "chroma_phase_deg": args.chroma_phase,
                   "diff_gain": args.diff_gain,
                   "diff_phase_deg": args.diff_phase,
                   "ghost_delay_us": args.ghost_delay_us,
                   "ghost_gain": args.ghost_gain}
        impair_kw = dict(
            noise_sigma=args.noise, chroma_gain=args.chroma_gain,
            chroma_phase_deg=args.chroma_phase,
            diff_gain=args.diff_gain, diff_phase_deg=args.diff_phase,
            ghost_delay_us=args.ghost_delay_us, ghost_gain=args.ghost_gain,
        )
        if any([args.noise > 0.0, args.chroma_gain != 1.0,
                args.chroma_phase != 0.0, args.diff_gain != 0.0,
                args.diff_phase != 0.0, args.ghost_gain != 0.0]):
            key = jax.random.PRNGKey(0) if args.noise > 0.0 else None
            comp_b = impair(plan, comp_b, key=key, **impair_kw)
            result["channel"] = channel
        if args.equalize:
            import jax.numpy as jnp

            from color_modem_tpu.frame.equalize import (
                apply_equalizer,
                design_equalizer,
                gcr_record,
                ntaps_for_delay,
            )

            rx = impair(
                plan, jnp.asarray(gcr_record(plan))[None],
                # the GCR record sees its own noise realization
                key=jax.random.PRNGKey(1) if args.noise > 0.0 else None,
                **impair_kw,
            )[0]
            # reach the requested ghost's echoes, not just the default 64
            taps = design_equalizer(
                plan, rx, ntaps=ntaps_for_delay(plan, args.ghost_delay_us)
            )
            comp_b = apply_equalizer(comp_b, taps)
            result["equalized"] = True
        if args.vhs:
            from color_modem_tpu.frame.channel import vhs_playback

            comp_b = vhs_playback(plan, comp_b)
            result["vhs"] = True
        if args.tbe_us != 0.0 or args.tbe_flagging_us != 0.0 or args.tbc:
            # (raster/interlace preconditions were validated up front)
            from color_modem_tpu.frame.pipeline import frame_line_index
            from color_modem_tpu.frame.raster import make_raster
            from color_modem_tpu.frame.timebase import (
                correctable_reach,
                impair_timebase,
                tbc_correct,
            )

            rp = make_raster(plan)
            # refuse to CLAIM correction beyond the estimator's physical
            # reach — outside it the estimate silently degrades instead
            worst = (abs(args.tbe_us) + abs(args.tbe_flagging_us)) * 1e-6
            need = int(np.ceil(worst * plan.fs)) + 1
            reach = correctable_reach(rp)
            if args.tbc and need > reach:
                raise SystemExit(
                    f"--tbc cannot reach {worst*1e6:.2f} us of time-base "
                    f"error: the single-line sync/burst estimator's limit "
                    f"at this geometry is ~{reach/plan.fs*1e6:.2f} us "
                    f"({reach} samples)"
                )
            if args.tbe_us != 0.0 or args.tbe_flagging_us != 0.0:
                comp_b, _ = impair_timebase(
                    plan, comp_b, wobble_us=args.tbe_us,
                    flagging_us=args.tbe_flagging_us,
                )
                result["tbe"] = {"wobble_us": args.tbe_us,
                                 "flagging_us": args.tbe_flagging_us}
            if args.tbc:
                g = frame_line_index(plan, args.frame, 1, rgb.shape[1])
                comp_b = tbc_correct(plan, rp, comp_b, g)
                result["tbc"] = True
        if getattr(args, "scramble", None):
            # receiver-side: keep the pirate's view, then descramble
            from color_modem_tpu.frame.scramble import descramble as _descr

            pirate_comp = comp_b
            comp_b = _descr(plan, comp_b, g_scr, args.scramble,
                            args.scramble_key, active_start=scr_off)
        if args.burst_locked:
            from color_modem_tpu.frame.pipeline import frame_line_index
            from color_modem_tpu.frame.raster import (
                decode_burst_locked,
                make_raster,
            )

            rp = make_raster(plan)
            g = frame_line_index(plan, args.frame, 1, rgb.shape[1])
            if getattr(args, "pal_ident", False):
                # simulate a slipped receiver line counter, then let the
                # ident stage recover the V-switch parity from the burst
                from color_modem_tpu.frame.raster import identify_vswitch

                g_rx = g + 1
                slip = identify_vswitch(plan, rp, comp_b, g_rx)
                g = g_rx + slip[..., None]
                result["pal_ident"] = {
                    "rx_line_slip": 1,
                    "identified_slip": int(np.asarray(slip)[0]),
                    "recovered": int(np.asarray(slip)[0]) == 1,
                }
            out = np.asarray(jax.block_until_ready(decode_burst_locked(
                plan, rp, comp_b, g, args.decoder,
                acc=args.acc, color_kill=args.color_kill,
            )))[0]
            result["burst_locked"] = True
            if args.acc:
                result["acc"] = True
            if args.color_kill > 0.0:
                result["color_kill"] = args.color_kill
        elif ident_rows:
            # the receiver's line counter slipped one line; the bottles
            # tell it the Dr/Db parity anyway.  With --raster the sync
            # separator runs first (strip_raster), THEN the data-line
            # machinery — the real receiver order.
            from color_modem_tpu.frame.pipeline import decode_block
            from color_modem_tpu.modem import secam as secam_mod

            comp_a = comp_b
            if args.raster:
                from color_modem_tpu.frame.raster import (
                    make_raster,
                    strip_raster,
                )

                comp_a = strip_raster(make_raster(plan), comp_b)
            rx_g = g_tx + 1
            swap = secam_mod.identify_from_ident(
                plan, comp_a[:, :ident_rows], rx_g[:, :ident_rows]
            )
            out = np.asarray(jax.block_until_ready(decode_block(
                plan, comp_a, rx_g + swap[..., None],
                args.decoder,
            )))[0]
            result["secam_ident"] = {
                "rx_line_slip": 1,
                "identified_swap": int(np.asarray(swap)[0]),
                "recovered": int(np.asarray(swap)[0]) == 1,
            }
        elif vir_rows:
            # decode with the VIR-measured picture-level corrections; the
            # references rode every channel stage above, like real line 19.
            # With --raster: sync separation first, then the references.
            from color_modem_tpu.frame.pipeline import frame_line_index
            from color_modem_tpu.frame.vir import (
                decode_vir_corrected,
                measure_vir,
            )

            comp_a = comp_b
            if args.raster:
                from color_modem_tpu.frame.raster import (
                    make_raster,
                    strip_raster,
                )

                comp_a = strip_raster(make_raster(plan), comp_b)
            if interlaced:
                # per-FIELD references and corrections: each field's
                # reference line corrects that field's picture lines
                # (the per-field form of decode_vir_corrected), then the
                # corrected fields weave back to the frame
                import jax.numpy as jnp

                from color_modem_tpu.frame.interlace import (
                    field_line_index,
                    weave_fields,
                )
                from color_modem_tpu.frame.pipeline import decode_block

                g_f = field_line_index(
                    plan, args.frame, 1, comp_a.shape[-2]
                )
                rep = measure_vir(plan, comp_a[:, :1], g_f[:, :1])
                g_pic = g_f[:, 1:]
                ones = jnp.ones(g_pic.shape, jnp.float32)
                fields = decode_block(
                    plan, comp_a[:, 1:], g_pic, args.decoder,
                    phase_err=rep["phase_err"][..., None] * ones,
                    chroma_gain=rep["chroma_gain_corr"][..., None] * ones,
                )
                pic = np.asarray(
                    jax.block_until_ready(weave_fields(fields))
                )[0]
            else:
                g = frame_line_index(plan, args.frame, 1, rgb.shape[1])
                rep = measure_vir(
                    plan, comp_a[:, :vir_rows], g[:, :vir_rows]
                )
                pic = np.asarray(jax.block_until_ready(
                    decode_vir_corrected(
                        plan, comp_a, g, vir_rows, args.decoder,
                    )
                ))[0]
            # keep `out` frame-shaped for the uniform PSNR/data_rows
            # accounting below (the VIR rows themselves are excluded)
            out = np.concatenate(
                [np.zeros_like(pic[:, :vir_rows]), pic], axis=1
            )
            result["vir"] = {
                "chroma_gain_corr": round(
                    float(np.asarray(rep["chroma_gain_corr"])[0]), 3
                ),
                "phase_err_deg": round(
                    float(np.degrees(np.asarray(rep["phase_err"])[0])), 2
                ),
                "luma_ref": round(
                    float(np.asarray(rep["luma_ref"])[0]), 3
                ),
            }
        else:
            out = np.asarray(
                jax.block_until_ready(decode(comp_b, args.frame))
            )[0]
        if cap_rows:
            # read the data lines off the RECEIVED composite, after every
            # receiver correction stage (equalizer, TBC, RF loops)
            from color_modem_tpu.frame.vbi import cc_unpack, decode_data_line

            cap_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                cap_off = make_raster(plan).n_blank
            got, all_ok, worst = [], True, 1.0
            for r in range(cap_rows):
                bits, margin = decode_data_line(
                    plan, cap_spec, comp_b[0, r, cap_off:]
                )
                s, ok = cc_unpack(np.asarray(bits))
                got.append(s)
                all_ok = all_ok and ok
                worst = min(worst, float(margin))
            received = "".join(got)
            result["caption"] = {
                "sent": cap_text,
                "received": received,
                "exact": received == cap_text,
                "parity_ok": all_ok,
                "worst_margin": round(worst, 3),
            }
        if ttx_rows:
            # read the page off the RECEIVED composite, post receiver
            from color_modem_tpu.frame import teletext as ttx_mod

            cap_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                cap_off = make_raster(plan).n_blank
            pkts = ttx_mod.decode_packets(
                plan, comp_b[0, cap_rows:cap_rows + ttx_rows, cap_off:]
            )
            got_rows = [p.text.rstrip() for p in pkts[1:]]
            result["teletext"] = {
                "page": pkts[0].page,
                "header": pkts[0].text.rstrip(),
                "rows": got_rows,
                "exact": got_rows == [t.rstrip() for t in ttx_texts],
                "address_ok": all(p.address_ok for p in pkts),
                "parity_ok": all(bool(p.parity_ok.all()) for p in pkts),
                "worst_margin": round(min(p.margin for p in pkts), 3),
            }
        if wss_row >= 0:
            from color_modem_tpu.frame import wss as wss_mod

            wss_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                wss_off = make_raster(plan).n_blank
            got, margin = wss_mod.decode_wss(
                plan, comp_b[0, wss_row, wss_off:]
            )
            rep = wss_mod.parse_wss(np.asarray(got))
            result["wss"] = {
                "sent": args.wss,
                "received": rep["aspect"],
                "exact": rep["aspect"] == args.wss and rep["aspect_ok"],
                "margin": round(float(margin), 3),
            }
        if vitc_row >= 0:
            from color_modem_tpu.frame import vitc as vitc_mod

            vitc_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                vitc_off = make_raster(plan).n_blank
            got, score = vitc_mod.decode_vitc_line(
                plan, comp_b[0, vitc_row, vitc_off:]
            )
            rep = vitc_mod.vitc_unpack(np.asarray(got))
            rx_tc = (rep["hours"], rep["minutes"], rep["seconds"],
                     rep["frames"])
            result["vitc"] = {
                "sent": "%02d:%02d:%02d:%02d" % vitc_sent,
                "received": "%02d:%02d:%02d:%02d" % rx_tc,
                "exact": rx_tc == vitc_sent and rep["crc_ok"],
                "crc_ok": rep["crc_ok"],
                "sync_score": int(score),
            }
        if n_vits:
            # read the test lines off the RECEIVED composite (staircase:
            # vectorscope numbers) and the DECODED luma (multiburst:
            # frequency response) — the in-service measurement loop
            from color_modem_tpu.frame.measure import (
                measure_differential,
                measure_frequency_response,
            )
            from color_modem_tpu.frame.pipeline import frame_line_index

            vits_off = 0
            if args.raster:
                from color_modem_tpu.frame.raster import make_raster

                vits_off = make_raster(plan).n_blank
            k = 4
            L = rgb.shape[1]
            vits_report = {}
            if not plan.cfg.is_fm:
                g = frame_line_index(plan, args.frame, 1, L)
                rep = measure_differential(
                    plan,
                    comp_b[:, L - 2 * k: L - k, vits_off:],
                    g[:, L - 2 * k: L - k],
                )
                vits_report["dg"] = round(rep["dg"], 4)
                vits_report["dp_deg"] = round(rep["dp_deg"], 2)
            import jax.numpy as jnp

            y = np.tensordot(
                np.asarray(plan.rgb_to_ycc)[0], out[:, L - k:], axes=(0, 0)
            )
            freq = measure_frequency_response(plan, jnp.asarray(y))
            vits_report["frequency_response"] = {
                f"{f}MHz": round(v, 3) for f, v in freq.items()
            }
            result["vits"] = vits_report
        svc_rows = (cap_rows + ttx_rows + (1 if wss_row >= 0 else 0)
                    + (1 if vitc_row >= 0 else 0) + ident_rows)
        # interlaced: the data services ride FIELD 0's top rows, which
        # weave to the EVEN frame rows 0, 2, .., 2*svc_rows-2 — exclude
        # the whole interleaved band (round-4 full-stack probe: the old
        # frame-row slice left half the data lines inside the "picture"
        # and read 17 dB on a healthy 30 dB run).  VIR keeps its own
        # accounting: its interlaced path strips field row 0s and
        # rebuilds `out` with a vir_rows zero prefix above.
        data_rows = (2 * svc_rows if interlaced else svc_rows) + vir_rows
        hi = rgb.shape[1] - n_vits
        if data_rows or n_vits:
            result["psnr_db"] = round(
                psnr(out[:, data_rows:hi], rgb[:, data_rows:hi]), 2
            )
        else:
            result["psnr_db"] = round(psnr(out, rgb), 2)
        if pirate_comp is not None:
            # pirate PSNR over the same picture-row slice as psnr_db
            # (ADVICE r2): data/test lines are not picture for either
            pirate = np.asarray(decode(pirate_comp, args.frame))[0]
            result["scramble"] = {
                "mode": args.scramble,
                "key": args.scramble_key,
                "pirate_psnr_db": round(
                    psnr(pirate[:, data_rows:hi], rgb[:, data_rows:hi]), 2
                ),
            }
        result["lines"] = int(rgb.shape[1])
        if args.output:
            save_rgb(args.output, out)
            result["output"] = args.output
        if args.composite:
            if interlaced:
                from color_modem_tpu.frame.interlace import weave_fields

                save_composite(args.composite,
                               np.asarray(weave_fields(comp_b))[0])
            elif svideo:
                # two wires: visualize the luma plane (the C plane has no
                # meaningful grayscale rendering)
                save_composite(args.composite, np.asarray(comp_b)[0, 0])
            else:
                save_composite(args.composite, np.asarray(comp_b)[0])
            result["composite"] = args.composite
    result["seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
