"""Single-chip benchmark — prints ONE JSON line (the driver metric).

Metric: encode+decode round-trip throughput in Mpix/s on one chip for the
flagship config (BASELINE.json config 2: NTSC, 2D-comb decoder, batched
720x480 frames).  ``vs_baseline`` is the speedup over the reference's
estimated throughput ceiling of 1 Mpix/s (a per-scanline Python/NumPy loop;
the reference publishes no numbers), i.e. value/1.0.  It runs only on a
GPU and names the card in its output.

Run either way (same protocol, SURVEY.md §5.6):

    python bench.py [--batch B] [--iters K] [--standard ntsc] [--decoder comb3]
    python -m color_modem_tpu.cli bench [same flags]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def add_bench_args(ap) -> None:
    """Benchmark flags, shared by bench.py and the ``bench`` CLI verb."""
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--standard", default="ntsc")
    ap.add_argument("--decoder", default="comb3")
    ap.add_argument("--lines", type=int, default=0, help="0 = standard active lines")
    ap.add_argument("--samples", type=int, default=720)
    ap.add_argument(
        "--roofline", action="store_true",
        help="also report achieved TFLOP/s and HBM GB/s vs chip peaks "
        "(SURVEY.md §5.1 speed-of-light check)",
    )


def run(args) -> None:
    import os

    import jax
    import jax.numpy as jnp

    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS
    from color_modem_tpu.utils.metrics import psnr
    from color_modem_tpu.utils.runtime import require_gpu

    cfg = ALL_STANDARDS[args.standard]()
    lines = args.lines or cfg.active_lines
    plan = make_plan(cfg, args.samples)
    from color_modem_tpu.standards.decoders import allowed_decoders

    if args.decoder not in allowed_decoders(cfg):
        import sys

        fallback = allowed_decoders(cfg)[0]
        print(
            f"bench: {cfg.name} does not support decoder "
            f"{args.decoder!r}; benchmarking {fallback!r} instead",
            file=sys.stderr,
        )
        args.decoder = fallback
    from color_modem_tpu.utils.testimages import smooth_scene

    # band-limited scene: makes the reported PSNR a meaningful health check
    # (raw random noise cannot round-trip a band-limited analog channel)
    one = smooth_scene(lines, args.samples, seed=0)
    rgb = jnp.asarray(
        np.broadcast_to(one, (args.batch, 3, lines, args.samples)), jnp.float32
    )

    from color_modem_tpu.utils.profiling import time_calls

    dev = require_gpu()
    _, _, roundtrip = make_pipeline(plan, args.decoder)
    quality = psnr(np.asarray(roundtrip(rgb, 0)), np.asarray(rgb))
    dt = time_calls(roundtrip, rgb, 0, iters=args.iters)

    pixels = args.batch * lines * args.samples
    mpix_s = pixels / dt / 1e6
    scanlines_s = args.batch * lines / dt

    line = json.dumps(
        {
            "metric": f"{args.standard}-{args.decoder} roundtrip throughput "
            f"(1 {dev.device_kind}, {args.batch}x{lines}x{args.samples}, "
            f"psnr={quality:.1f}dB, {scanlines_s:,.0f} scanlines/s)",
            "value": round(mpix_s, 1),
            "unit": "Mpix/s",
            "vs_baseline": round(mpix_s / 1.0, 1),
        }
    )
    print(line)

    # structured record for results/ (SURVEY.md §5.5)
    os.makedirs("results", exist_ok=True)
    record = {
        "ts": time.time(),
        "standard": args.standard,
        "decoder": args.decoder,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "shape": [args.batch, lines, args.samples],
        "iters": args.iters,
        "mpix_per_s": round(mpix_s, 1),
        "scanlines_per_s": round(scanlines_s),
        "roundtrip_psnr_db": round(float(quality), 2),
    }
    if args.roofline:
        from color_modem_tpu.utils.profiling import chip_peaks

        peaks = chip_peaks()
        ca = roundtrip.lower(rgb, 0).compile().cost_analysis()
        flops = float(ca.get("flops", float("nan")))
        byt = float(ca.get("bytes accessed", float("nan")))

        def _num(v, nd):
            # NaN (cost analysis without the entry) is not valid JSON
            return round(v, nd) if np.isfinite(v) else None

        record["roofline"] = {
            "logical_tflops": _num(flops / dt / 1e12, 2),
            "tflops_fraction_of_f32_peak": _num(
                flops / dt / 1e12 / peaks["f32_tflops"], 3
            ),
            "hbm_gbps": _num(byt / dt / 1e9, 1),
            "hbm_fraction_of_peak": _num(
                byt / dt / 1e9 / peaks["hbm_gbps"], 3
            ),
        }
        print(json.dumps({"roofline": record["roofline"]}))

    path = f"results/bench_{args.standard}_{args.decoder}.json"
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> None:
    from color_modem_tpu.utils.runtime import enable_compile_cache

    ap = argparse.ArgumentParser(description=__doc__)
    add_bench_args(ap)
    args = ap.parse_args(argv)
    enable_compile_cache()
    run(args)


if __name__ == "__main__":
    main()
