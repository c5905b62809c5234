"""The traffic generator: frames from the seed, and what every loop shares.

A traffic file (``traffic/<mix>.json``) holds parameters only.  Its
``loop`` names the file that drives the window, ``loops/<loop>.py``, whose
``build(config, traffic)`` returns a :class:`FrameLoop`; a new kind of
traffic is a new loop file, a new mix of an existing kind a data file.
The parameters every frame loop reads:

* ``frames_per_call``: frames in one encode/decode call.
* ``ring``: distinct inputs made in set-up and cycled through in the window.
* ``check_calls``: calls kept (a seeded reservoir over the whole window)
  and compared with the reference once the window has closed.
* ``trace_seconds``: length of the window in a traced run.

Inputs are band-limited scenes made on the device from the seed in one
jitted call (a few random base scenes, each frame a rolled and gain-shifted
variant keyed on its index), so nothing is generated inside the window.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

#: Random base scenes behind every ring; each frame is a variant of one.
N_BASE = 4


def seed_key(seed: int) -> jax.Array:
    """A PRNG key from any whole number, also one wider than 32 bits."""
    seed = int(seed)
    key = jax.random.key(seed & 0xFFFFFFFF)
    return jax.random.fold_in(key, (seed >> 32) & 0x7FFFFFFF)


@partial(jax.jit, static_argnums=(1, 2, 3))
def make_frames(key, n: int, lines: int, samples: int) -> jax.Array:
    """(n, 3, lines, samples) float32 distinct scenes in [0, 1]."""
    kb, ks = jax.random.split(key)
    img = jax.random.uniform(kb, (N_BASE, 3, lines, samples), jnp.float32)
    # low-pass well inside the chroma bands, like natural pictures
    for axis, keep in ((2, max(2, lines // 16)), (3, max(2, samples // 32))):
        spec = jnp.fft.rfft(img, axis=axis)
        idx = jnp.arange(spec.shape[axis]).reshape(
            [-1 if a == axis else 1 for a in range(4)])
        img = jnp.fft.irfft(jnp.where(idx < keep, spec, 0), n=img.shape[axis],
                            axis=axis)
    lo = img.min(axis=(1, 2, 3), keepdims=True)
    hi = img.max(axis=(1, 2, 3), keepdims=True)
    base = 0.1 + 0.8 * (img - lo) / jnp.maximum(hi - lo, 1e-9)
    offs = jax.random.randint(ks, (3,), 0, 1 << 20)

    def one(i):
        b = base[i % N_BASE]
        b = jnp.roll(b, (i * 37 + offs[0]) % samples, axis=-1)
        b = jnp.roll(b, (i * 11 + offs[1]) % lines, axis=-2)
        gain = 0.85 + 0.1 * jnp.cos(0.37 * i + offs[2].astype(jnp.float32))
        return jnp.clip(b * gain + 0.05, 0.0, 1.0)

    return jax.vmap(one)(jnp.arange(n))


class Reservoir:
    """Uniform sample of ``k`` items over a stream of unknown length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclass
class Window:
    calls: int = 0
    frames: int = 0
    seconds: float = 0.0
    latency_s: list = field(default_factory=list)   # live: per frame
    dispatch_s: list = field(default_factory=list)  # live: per frame
    kept: list = field(default_factory=list)        # (ring slot, frame0, comp, rgb)


def span(name: str, on: bool):
    return jax.profiler.TraceAnnotation(name) if on else contextlib.nullcontext()


class FrameLoop:
    """One cell's traffic through the program's encode/decode pair.

    A loop file subclasses this and gives ``setup`` (the ring and the warm
    call) and ``window`` (the timed loop, which offers every call to the
    reservoir ``keep`` as ``(ring slot, frame0, comp, rgb)``).
    """

    def __init__(self, traffic: dict, lines: int, samples: int, encode, decode):
        self.t, self.lines, self.samples = traffic, lines, samples
        self.encode, self.decode = encode, decode
        self.ring: list = []

    @property
    def frames_per_call(self) -> int:
        return int(self.t["frames_per_call"])

    def frames(self, seed: int):
        """The ring's frames from the seed, ``(ring, frames_per_call, 3, L, N)``."""
        b, r = self.frames_per_call, int(self.t["ring"])
        f = make_frames(seed_key(seed), b * r, self.lines, self.samples)
        self.rng = np.random.default_rng(int(seed))
        return f.reshape((r, b) + f.shape[1:])

    def setup(self, seed: int) -> None:
        raise NotImplementedError

    def window(self, seconds: float, spans: bool, keep: Reservoir) -> Window:
        raise NotImplementedError

    def run(self, seconds: float, spans: bool = False) -> Window:
        keep = Reservoir(int(self.t["check_calls"]), self.rng)
        w = self.window(seconds, spans, keep)
        w.kept = keep.items
        w.frames = w.calls * self.frames_per_call
        return w

    def host_calls(self, kept: list) -> list:
        """Kept calls as host ``(rgb_in, frame0, comp, rgb)`` arrays."""
        return [(np.asarray(self.ring[slot]), frame0, np.asarray(comp), np.asarray(rgb))
                for slot, frame0, comp, rgb in kept]

    @staticmethod
    def check(config: dict, calls: list) -> tuple[dict, int, int]:
        """Host calls against the reference (``check.compare``); static, so
        the program's state can be freed before the reference runs."""
        from benchmark import check

        return check.compare(config, calls)
