"""Analog pay-TV scrambling: the three classic composite-domain systems.

Analog television's conditional-access era scrambled the COMPOSITE
waveform with keyed, invertible geometric operations — no cryptography on
the video itself, just enough geometry to destroy the picture for
non-subscribers while a keyed set-top box put every sample back:

* **cut-and-rotate** (Videocrypt, BSkyB 1989-2001): each active line is
  cut at a keyed pseudo-random point and the two segments are swapped
  (a circular rotation of the line);
* **line delay** (Discret 11, Canal+ 1984-1995): each line is delayed by
  one of three keyed pseudo-random delays (0 / 902 / 1804 ns);
* **line shuffle** (Nagravision Syster, 1990s): lines are permuted within
  a window by a keyed permutation.

Reference parity: beyond-reference (the upstream library has no
conditional-access simulation; SURVEY.md §2.1, mount empty §0.1).

Array formulation: every system is ONE ``take_along_axis`` gather per
block (rotation and delay gather along samples, shuffle gathers along
lines), with the key schedule a closed-form integer hash of
``(key, absolute line index)`` — the same philosophy as the NCO phase law
(dsp/nco.py): no sequential PRNG state, so frames and line blocks shard
freely and descrambling is *bit-exact* (index ops move samples, they
never touch their values).

Documented deviations from the historical systems: Discret's delay is
circular within the line here (the real system shifted content off the
active edge; circularity is what makes descrambling exact), the key
schedules are a keyed integer hash rather than the originals' PRBS/
smart-card schedules, and Nagravision's 256-line rolling window is a
per-frame block permutation.  The *geometry* of each system — what a
pirate's screen actually showed — is the authentic part.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from color_modem_tpu.modem.plan import ModemPlan

MODES = ("cutrotate", "linedelay", "shuffle")

#: Discret 11's three delay taps, nanoseconds
DELAY_TAPS_NS = (0.0, 902.0, 1804.0)
#: Nagravision-style permutation window, lines
SHUFFLE_WINDOW = 32


def _hash32(gline: jax.Array, key: int) -> jax.Array:
    """Keyed integer hash of absolute line indices -> uint32.

    Two rounds of multiply-xorshift (the finalizer structure of Murmur3):
    closed-form, stateless, identical on every backend.
    """
    h = gline.astype(jnp.uint32) * jnp.uint32(2654435761)
    h = h ^ jnp.uint32(key & 0xFFFFFFFF)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def _rotate_lines(x: jax.Array, shift: jax.Array) -> jax.Array:
    """Per-line circular rotation: out[..., l, i] = x[..., l, (i+shift[l]) % N]."""
    n = x.shape[-1]
    idx = (jnp.arange(n, dtype=jnp.int32) + shift[..., None]) % n
    return jnp.take_along_axis(x, idx, axis=-1)


def _cut_points(plan: ModemPlan, gline: jax.Array, key: int) -> jax.Array:
    """Keyed cut points in [N/8, 7N/8) — the real system also kept cuts
    away from the line edges (sync/burst must survive in the clear)."""
    n = plan.n_samples
    lo, span = n // 8, 3 * n // 4
    return (lo + _hash32(gline, key) % jnp.uint32(span)).astype(jnp.int32)


def _delay_samples(plan: ModemPlan, gline: jax.Array, key: int) -> jax.Array:
    taps = jnp.asarray(
        np.round(np.asarray(DELAY_TAPS_NS) * 1e-9 * plan.fs).astype(np.int32)
    )
    return taps[(_hash32(gline, key) % jnp.uint32(3)).astype(jnp.int32)]


def _shuffle_perm(gline: jax.Array, key: int) -> jax.Array:
    """(..., L) keyed permutation WITHIN windows of SHUFFLE_WINDOW lines:
    argsort of the per-line hash inside each window (ties broken by the
    stable sort's index order — same everywhere, so exactly invertible)."""
    l = gline.shape[-1]
    if l % SHUFFLE_WINDOW:
        raise ValueError(
            f"shuffle needs the line count divisible by {SHUFFLE_WINDOW}, "
            f"got {l}"
        )
    h = _hash32(gline, key)
    win = h.reshape(gline.shape[:-1] + (l // SHUFFLE_WINDOW, SHUFFLE_WINDOW))
    perm = jnp.argsort(win, axis=-1, stable=True).astype(jnp.int32)
    base = (
        jnp.arange(l // SHUFFLE_WINDOW, dtype=jnp.int32)[:, None]
        * SHUFFLE_WINDOW
    )
    return (perm + base).reshape(gline.shape)


def _invert_perm(perm: jax.Array) -> jax.Array:
    return jnp.argsort(perm, axis=-1, stable=True).astype(jnp.int32)


def scramble(
    plan: ModemPlan,
    comp: jax.Array,
    gline: jax.Array,
    mode: str,
    key: int,
    active_start: int = 0,
) -> jax.Array:
    """Scramble a (..., L, N) composite block (keyed, exactly invertible).

    ``active_start``: first ACTIVE sample of each row — nonzero for
    rastered lines (frame/raster.py ``n_blank``), where the authentic
    systems scrambled only the picture region and left sync + burst in
    the clear so receivers could still lock (Videocrypt rotated active
    video within an otherwise ordinary rastered line).  Rotation and
    delay then act circularly within the active region; shuffle permutes
    the active slices between lines while each line keeps its own
    blanking (the swinging burst must stay on its own line number)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    comp = comp.astype(jnp.float32)
    if active_start:
        act = scramble(plan, comp[..., active_start:], gline, mode, key)
        return jnp.concatenate([comp[..., :active_start], act], axis=-1)
    if mode == "cutrotate":
        return _rotate_lines(comp, _cut_points(plan, gline, key))
    if mode == "linedelay":
        return _rotate_lines(comp, -_delay_samples(plan, gline, key))
    perm = _shuffle_perm(gline, key)
    return jnp.take_along_axis(comp, perm[..., None], axis=-2)


def descramble(
    plan: ModemPlan,
    comp: jax.Array,
    gline: jax.Array,
    mode: str,
    key: int,
    active_start: int = 0,
) -> jax.Array:
    """Exact inverse of :func:`scramble` under the same key."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    comp = comp.astype(jnp.float32)
    if active_start:
        act = descramble(plan, comp[..., active_start:], gline, mode, key)
        return jnp.concatenate([comp[..., :active_start], act], axis=-1)
    if mode == "cutrotate":
        return _rotate_lines(comp, -_cut_points(plan, gline, key))
    if mode == "linedelay":
        return _rotate_lines(comp, _delay_samples(plan, gline, key))
    inv = _invert_perm(_shuffle_perm(gline, key))
    return jnp.take_along_axis(comp, inv[..., None], axis=-2)
