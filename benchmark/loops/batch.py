"""A closed loop of device-resident batches (library users of ``make_pipeline``).

Each call encodes one batch of the ring and decodes its composite, the two
jits one after the other; the outputs stay on the device.  At most
``in_flight`` calls are queued ahead of the host.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from benchmark import harness
from benchmark.generator import FrameLoop, Window, span


class Batch(FrameLoop):
    def setup(self, seed: int) -> None:
        self.ring = list(self.frames(seed))
        np.asarray(self.decode(self.encode(self.ring[0], 0), 0))

    def window(self, seconds, spans, keep) -> Window:
        b, ring, depth = self.frames_per_call, self.ring, int(self.t["in_flight"])
        pending = deque()
        n = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            slot = n % len(ring)
            with span("bench.dispatch", spans):
                comp = self.encode(ring[slot], n * b)
                rgb = self.decode(comp, n * b)
            keep.offer((slot, n * b, comp, rgb))
            pending.append(rgb)
            n += 1
            if len(pending) > depth:
                with span("bench.wait", spans):
                    pending.popleft().block_until_ready()
            if time.perf_counter() >= deadline:
                break
        with span("bench.wait", spans):
            for p in pending:
                p.block_until_ready()
        return Window(calls=n, seconds=time.perf_counter() - t0)


def build(config: dict, traffic: dict) -> Batch:
    return Batch(traffic, int(config["lines"]), int(config["samples"]),
                 *harness.pipeline(config))
