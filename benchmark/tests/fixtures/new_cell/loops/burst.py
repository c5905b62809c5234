"""A loop that exists only in a test fixture: bursts of ``burst`` calls
queued back to back, then a wait for all of them."""

import time

import numpy as np

from benchmark import harness
from benchmark.generator import FrameLoop, Window, span


class Burst(FrameLoop):
    def setup(self, seed):
        self.ring = list(self.frames(seed))
        np.asarray(self.decode(self.encode(self.ring[0], 0), 0))

    def window(self, seconds, spans, keep):
        b, k = self.frames_per_call, int(self.t["burst"])
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            outs = []
            for _ in range(k):
                slot = n % len(self.ring)
                with span("bench.dispatch", spans):
                    comp = self.encode(self.ring[slot], n * b)
                    rgb = self.decode(comp, n * b)
                keep.offer((slot, n * b, comp, rgb))
                outs.append(rgb)
                n += 1
            with span("bench.wait", spans):
                for o in outs:
                    o.block_until_ready()
        return Window(calls=n, seconds=time.perf_counter() - t0)


def build(config, traffic):
    return Burst(traffic, int(config["lines"]), int(config["samples"]),
                 *harness.pipeline(config))
