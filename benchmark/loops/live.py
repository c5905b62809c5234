"""One client with one frame in flight (an emulator front end).

Upload a host frame, encode, decode, read the RGB back, then send the next
frame.  Each frame's latency runs from the hand-over of the host frame to
holding its RGB on the host; its hand-over time ends once both calls are
queued.
"""

from __future__ import annotations

import time

import jax
import numpy as np

from benchmark import harness
from benchmark.generator import FrameLoop, Window, span


class Live(FrameLoop):
    def setup(self, seed: int) -> None:
        self.ring = list(np.asarray(self.frames(seed)))  # the client's host frames
        np.asarray(self.decode(self.encode(jax.device_put(self.ring[0]), 0), 0))

    def window(self, seconds, spans, keep) -> Window:
        ring = self.ring
        w = Window()
        n = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            slot = n % len(ring)
            start = time.perf_counter()
            with span("bench.upload", spans):
                x = jax.device_put(ring[slot])
            with span("bench.dispatch", spans):
                comp = self.encode(x, n)
                rgb = self.decode(comp, n)
            queued = time.perf_counter()
            with span("bench.readback", spans):
                out = np.asarray(rgb)
            end = time.perf_counter()
            w.latency_s.append(end - start)
            w.dispatch_s.append(queued - start)
            keep.offer((slot, n, comp, out))
            n += 1
            if end >= deadline:
                break
        w.calls, w.seconds = n, time.perf_counter() - t0
        return w


def build(config: dict, traffic: dict) -> Live:
    return Live(traffic, int(config["lines"]), int(config["samples"]),
                *harness.pipeline(config))
