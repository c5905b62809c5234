"""Record the trace fixture of ``test_trace_reduce.py`` on the card.

    python3 benchmark/tests/make_fixture.py [out.json]

Traces a short window of ``ntsc-comb3-480.batch16`` (a handful of calls),
prints how the trace is laid out -- its planes, lines, and a few device
events with all their stats -- and writes the events that
``trace_reduce.extract`` keeps, inside the window, as the fixture, with the
numbers ``test_trace_reduce.py`` expects, worked out by another route.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "ntsc_batch_trace.json")


def main(out: str = OUT) -> int:
    from benchmark import harness, spec, trace_reduce

    harness.configure_cache()
    cell = spec.load_cell("ntsc-comb3-480.batch16")
    harness.require_chips(1)
    import jax
    from jax.profiler import ProfileData

    traffic = harness.build(cell)
    traffic.setup(20251016)
    tdir = tempfile.mkdtemp(prefix="bench_fixture_")
    try:
        jax.profiler.start_trace(tdir)
        with jax.profiler.TraceAnnotation(trace_reduce.WINDOW):
            win = traffic.run(0.02, spans=True)
        jax.profiler.stop_trace()
        events = trace_reduce.extract(tdir)
        path = [os.path.join(d, f) for d, _, fs in os.walk(tdir) for f in fs
                if f.endswith(".xplane.pb")][0]
        for plane in ProfileData.from_file(path).planes:
            lines = {ln.name: sum(1 for _ in ln.events) for ln in plane.lines}
            print("plane", plane.name, json.dumps(lines)[:600])
            if plane.name.startswith(trace_reduce.DEVICE_PLANE):
                for ln in plane.lines:
                    for ev in list(ln.events)[:3]:
                        print("  ", ln.name, "|", ev.name[:120], ev.start_ns, ev.duration_ns,
                              {k: str(v)[:80] for k, v in ev.stats})
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    red = trace_reduce.Reduction(events)
    keep = [e for e in events if e["t"] + e["d"] >= red.t0 and e["t"] <= red.t1]
    print("calls", win.calls, "kept events", len(keep),
          Counter((e["plane"], e["line"]) for e in keep).most_common(12))
    print("modules", Counter(e.get("module") for e in keep).most_common(8))
    print("busy_s", red.busy_s, "window_s", red.window_s, "encode",
          red.module_seconds("jit_encode"), "decode", red.module_seconds("jit_decode"))
    fx = {"calls": win.calls, "frames_per_call": traffic.frames_per_call,
          "events": keep, "expected": expected(keep)}
    print("expected", fx["expected"])
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(fx, f, indent=0)
    return 0


def expected(events) -> dict:
    """The fixture's numbers by another route: a per-nanosecond timeline."""
    import numpy as np

    w = next(e for e in events if e["name"] == "bench.window")
    t0, t1 = w["t"], w["t"] + w["d"]
    busy = np.zeros(t1 - t0, bool)
    by_module = {"jit_encode": 0, "jit_decode": 0}
    for e in events:
        if e["plane"].startswith("/device:") and e["line"].startswith("Stream"):
            s, t = max(e["t"], t0), min(e["t"] + e["d"], t1)
            if t > s:
                busy[s - t0: t - t0] = True
                if e["module"] in by_module:
                    by_module[e["module"]] += t - s
    return {"busy_s": int(busy.sum()) * 1e-9, "window_s": (t1 - t0) * 1e-9,
            "encode_s": by_module["jit_encode"] * 1e-9,
            "decode_s": by_module["jit_decode"] * 1e-9}


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
