"""Run one benchmark cell on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from process start): load the cell from
``BENCHMARK.json``, build the program's jits, make the input ring on the
device from the seed and warm every shape.  Then the window: the cell's
traffic for ``--seconds`` (``--trace 0``, end-to-end metrics), or
(``--trace 1``, per-layer metrics) for the mix's ``trace_seconds`` without
the profiler and then as long again under it: readers of device time read
the traced window, readers of the host's clock the plain one, which the
profiler's own host work leaves out.  Then the check against the float64 reference.  The last line of
standard output is the JSON result; the last lines of standard error are
the numbers compared, each with its limit.  Without a GPU, or with fewer
than the cell needs, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _pixels(w, cell):
    return w.frames * int(cell.config["lines"]) * int(cell.config["samples"])


#: End-to-end metrics: name -> f(window, cell, setup seconds).
END_TO_END = {
    "mpix_per_s": lambda w, cell, setup: _pixels(w, cell) / w.seconds / 1e6,
    "frame_p95_ms": lambda w, cell, setup: (
        float(np.percentile(w.latency_s, 95)) * 1e3 if w.latency_s else None),
    "setup_s": lambda w, cell, setup: setup,
}


@dataclass
class ReadContext:
    """What a per-layer reader (``metrics/<name>.py``) may read."""

    reduction: object
    window: object        # the traced window
    plain_window: object  # as long, without the profiler
    frames_per_call: int
    config: dict
    kind: str
    notes: list = field(default_factory=list)

    def note(self, text: str) -> None:
        self.notes.append(text)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import check, harness, lastline, peaks, spec, trace_reduce

    cell = spec.load_cell(args.workload)
    cache_dir = harness.configure_cache()
    compiles = harness.Compiles()
    import jax

    devs = harness.require_chips(cell.chips)
    kind = devs[0].device_kind
    peaks.peaks(kind)  # an unknown card is an error, before any work
    print(f"device: {devs[0].platform} {kind} x{len(jax.devices())}; "
          f"nvidia-smi: {peaks.smi()}", flush=True)

    traffic = harness.build(cell)
    traffic.setup(args.seed)
    setup_s = time.perf_counter() - T_START
    print(f"setup: {setup_s:.3f} s; {compiles.backend} programs built, persistent cache "
          f"{compiles.hits} hits / {compiles.misses} writes ({cache_dir})", flush=True)

    before = compiles.backend
    metrics, breakdown, extra, plain = {}, None, {}, None
    if args.trace:
        seconds = min(args.seconds, float(cell.traffic["trace_seconds"]))
        plain = traffic.run(seconds)
        tdir = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            jax.profiler.start_trace(tdir)
            try:
                with jax.profiler.TraceAnnotation(trace_reduce.WINDOW):
                    win = traffic.run(seconds, spans=True)
            finally:
                jax.profiler.stop_trace()
            red = trace_reduce.Reduction(trace_reduce.extract(tdir))
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
        ctx = ReadContext(red, win, plain, traffic.frames_per_call, cell.config, kind)
        for m in cell.per_layer:
            v = spec.load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
        for n in ctx.notes:
            print(n, flush=True)
        del ctx
        breakdown = {"device_ops": red.top_ops(), "idle_gaps": red.idle_gaps()}
        extra = {"busy_s": red.busy_s, "window_s": red.window_s}
    else:
        win = traffic.run(args.seconds)
        for m in cell.end_to_end:
            v = END_TO_END[m["name"]](win, cell, setup_s)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
    in_window = compiles.backend - before
    print(f"window: {win.calls} calls, {win.frames} frames in {win.seconds:.3f} s; "
          f"{in_window} programs built inside it", flush=True)
    if win.latency_s:
        lat = np.asarray(win.latency_s) * 1e3
        print("latency ms: p50 {:.4f} p95 {:.4f} p99 {:.4f} max {:.4f}; hand-over "
              "mean {:.4f}".format(*np.percentile(lat, [50, 95, 99]), lat.max(),
                                   np.mean(win.dispatch_s) * 1e3), flush=True)

    device = {"platform": devs[0].platform, "kind": kind, "count": len(jax.devices()),
              "memory_peak_bytes": max(
                  int((d.memory_stats() or {}).get("peak_bytes_in_use", 0)) for d in devs),
              **extra}
    attempted = win.frames
    calls = traffic.host_calls(win.kept)
    compare = type(traffic).check
    del traffic, win, plain
    if args.trace:
        got = peaks.probe()
        p = peaks.peaks(kind)
        print(f"probe: f32 HIGHEST matmul {got['matmul_f32_flops']:.4g} FLOP/s "
              f"(published {p['f32_flops']:.4g}); copy {got['copy_bytes_per_s']:.4g} B/s "
              f"(published {p['hbm_bytes_per_s']:.4g})", flush=True)
    t0 = time.perf_counter()
    worst, compared, failed = compare(cell.config, calls)
    correct = check.verdict(cell.config, worst, compared)
    print(f"check: {compared} frames against the reference in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    limits = cell.config.get("limits", {})
    compared_numbers = {k: worst[k] for k in limits} if limits else worst
    lastline.emit(lastline.result(
        correct, attempted, failed, metrics, device, compared_numbers, limits, breakdown))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — the boundary: report, print no result
        traceback.print_exc()
        sys.exit(1)
