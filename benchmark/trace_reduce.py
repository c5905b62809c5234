"""From a profiler trace to device busy time, time by XLA module, and gaps.

``extract`` reads the ``.xplane.pb`` that ``jax.profiler`` writes and keeps
two kinds of event, on the profiler's one clock: the benchmark's own host
spans (names starting ``bench.``) and every operation on a device plane
(kernels and copies, with the XLA module each belongs to).
``Reduction`` works on that plain list, so the same arithmetic runs on a
recorded fixture in the tests.

* busy: the union of the operation intervals inside the ``bench.window``
  span, per device, averaged over the devices that ran anything;
* time by module: the summed durations of one XLA module's operations (a
  jitted entry point such as ``jit_encode``).  The device stats carry no
  run id, so a reader divides by the calls the window made: a traced
  window starts with the device idle and ends once every call it made is
  done, so all of their operations, and no others, lie inside it;
* idle gaps: the stretches inside the window with no operation on the
  device, each labelled by the host span that covered most of it.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict

HOST_PREFIX = "bench."
WINDOW = "bench.window"
DEVICE_PLANE = "/device:"
#: Lines of a device plane that hold the operations themselves; other
#: lines, where a profiler adds them, summarise those same operations.
OP_LINE = "Stream"


def extract(trace_dir: str) -> list[dict]:
    """Events of the newest ``.xplane.pb`` under ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    events = []
    for plane in ProfileData.from_file(paths[-1]).planes:
        dev = plane.name.startswith(DEVICE_PLANE)
        for line in plane.lines:
            for ev in line.events:
                if not dev and not ev.name.startswith(HOST_PREFIX):
                    continue
                e = {"plane": plane.name, "line": line.name, "name": ev.name,
                     "t": int(ev.start_ns), "d": int(ev.duration_ns)}
                if dev:
                    stats = dict(ev.stats)
                    e["module"] = str(stats.get("hlo_module", ""))
                events.append(e)
    return events


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Reduction:
    def __init__(self, events: list[dict]):
        win = [e for e in events if e["name"] == WINDOW]
        if not win:
            raise ValueError(f"trace has no {WINDOW} span")
        w = max(win, key=lambda e: e["d"])
        self.t0, self.t1 = w["t"], w["t"] + w["d"]
        self.host = [e for e in events
                     if e["name"].startswith(HOST_PREFIX) and e["name"] != WINDOW]
        ops = [e for e in events
               if e["plane"].startswith(DEVICE_PLANE) and e["line"].startswith(OP_LINE)]
        self.planes = sorted({e["plane"] for e in ops})
        # operations clipped to the window
        self.ops = []
        for e in ops:
            s, t = max(e["t"], self.t0), min(e["t"] + e["d"], self.t1)
            if t > s:
                self.ops.append(dict(e, s=s, e=t))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self, plane: str):
        return _union((o["s"], o["e"]) for o in self.ops if o["plane"] == plane)

    @property
    def busy_s(self) -> float:
        """Busy seconds inside the window, averaged over the devices."""
        if not self.planes:
            return 0.0
        tot = sum(e - s for p in self.planes for s, e in self.busy_intervals(p))
        return tot * 1e-9 / len(self.planes)

    def module_seconds(self, module: str) -> float:
        """Device seconds of ``module``'s operations inside the window."""
        return sum(o["e"] - o["s"] for o in self.ops if o["module"] == module) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(int)
        for o in self.ops:
            by[o["name"]] += o["e"] - o["s"]
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9 / max(1, len(self.planes))] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest idle stretches of the first device, labelled."""
        if not self.planes:
            return [["no device operation", self.window_s]]
        gaps, at = [], self.t0
        for s, e in self.busy_intervals(self.planes[0]) + [[self.t1, self.t1]]:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            cover = defaultdict(int)
            for h in self.host:
                ov = min(e, h["t"] + h["d"]) - max(s, h["t"])
                if ov > 0:
                    cover[h["name"][len(HOST_PREFIX):]] += ov
            label = max(cover, key=cover.get) if cover else "host outside any span"
            out.append([label, (e - s) * 1e-9])
        return out
