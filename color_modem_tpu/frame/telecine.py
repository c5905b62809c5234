"""3:2 pulldown (telecine) and its inverse (beyond-reference).

Film is 24 frames/s; NTSC transmits ~60 fields/s.  Broadcast telecine
maps every 4 film frames onto 10 fields — the 2:3:2:3 cadence — with
field parity strictly alternating top, bottom, top, ...:

    position:  0    1    2    3    4    5    6    7    8    9
    field:     A_t  A_b  B_t  B_b  B_t  C_b  C_t  D_b  D_t  D_b

Positions 4 and 9 REPEAT positions 2 and 7 (same film frame, same
parity): the repeated-field signature lands on stream indices that are
congruent mod 5, which is what :func:`detect_pulldown_phase` measures.
Inverse telecine (the film-mode deinterlacer) finds that cadence, drops
the duplicates, and weaves the original progressive film frames back
EXACTLY — something no motion-adaptive deinterlacer can do, because for
film content the two fields of a pair really are the same instant.

Representation matches frame/deinterlace.py: a field-sequential batch
``(F, 3, L/2, N)`` where even indices are top fields (even rows).  A
stream may start anywhere in the cadence as long as it starts with a
top field (an even pattern position — the five even positions have five
distinct residues mod 5, so the duplicate signature pins the phase
uniquely).

Array notes: telecine and reassembly are pure gathers; the cadence metric
is a batched reduction.  Phase detection itself is a HOST decision (one
scalar readback, like the video runner's resume decisions) because the
trim offset changes array shapes — jit the per-chunk compute, decide the
phase outside.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

#: film-frame index feeding each of the 10 field positions (A=0 .. D=3)
_FRAME_OF_FIELD = (0, 0, 1, 1, 1, 2, 2, 3, 3, 3)

#: reassembly: (top, bottom) field positions of the four film frames
#: (positions 4 and 9 are the dropped duplicates)
_PAIRS = ((0, 1), (2, 3), (6, 5), (8, 7))


def telecine(film):
    """Film frames (4K, 3, L, N) -> field sequence (10K, 3, L/2, N).

    The 2:3:2:3 cadence above; top fields carry even rows (the
    frame/deinterlace.py convention)."""
    film = jnp.asarray(film, jnp.float32)
    f, c, l, n = film.shape
    if f % 4 != 0 or l % 2 != 0:
        raise ValueError("telecine needs a multiple of 4 frames, even rows")
    groups = film.reshape(f // 4, 4, c, l, n)
    picked = groups[:, jnp.asarray(_FRAME_OF_FIELD)]  # (K, 10, c, l, n)
    par = (jnp.arange(10) % 2)[None, :, None, None, None]
    fields = jnp.where(
        par == 0, picked[..., 0::2, :], picked[..., 1::2, :]
    )
    return fields.reshape(-1, c, l // 2, n)


def cadence_metric(fields):
    """Per-field repeated-field metric d (F,): mean squared difference to
    the previous SAME-PARITY field (2 instants back; first two fields
    have no predecessor and read as +inf).  A true 3:2 duplicate scores
    ~0 (exactly 0 on a clean chain); everything else scores picture-sized.
    Device-side; feed to :func:`detect_pulldown_phase`."""
    x = jnp.asarray(fields, jnp.float32)
    d = jnp.mean((x[2:] - x[:-2]) ** 2, axis=(1, 2, 3))
    return jnp.concatenate([jnp.full((2,), jnp.inf, d.dtype), d])


def detect_pulldown_phase(fields):
    """Returns ``(phase, confidence)``: the cadence position (even, 0-8)
    of the stream's FIRST field, and the ratio of the second-best to best
    residue-class score (>> 1 for genuine film cadence, ~1 for video).

    Duplicates sit at stream indices ``i`` with ``(i + phase) % 5 == 4``;
    the five even start positions give five distinct residues, so the
    argmin pins the phase uniquely.  Host decision (one readback).
    """
    d = np.asarray(cadence_metric(fields))
    if d.shape[0] < 12:
        raise ValueError("need >= 12 fields to detect a 3:2 cadence")
    idx = np.arange(d.shape[0])
    scores = np.array([
        float(np.mean(d[(idx % 5 == c) & np.isfinite(d)]))
        if np.any((idx % 5 == c) & np.isfinite(d)) else np.inf
        for c in range(5)
    ])
    c = int(np.argmin(scores))
    # phase is the even p in 0..8 with (4 - p) % 5 == c
    phase = next(p for p in (0, 2, 4, 6, 8) if (4 - p) % 5 == c)
    rest = np.delete(scores, c)
    confidence = float(np.min(rest) / max(float(scores[c]), 1e-12))
    return phase, confidence


def inverse_telecine(fields, phase: int | None = None):
    """Field sequence (F, 3, L/2, N) -> progressive film (4K', 3, L, N).

    Detects the cadence when ``phase`` is omitted, trims the partial
    leading/trailing groups, drops the duplicate fields, and weaves each
    film frame's field pair — EXACT recovery for true telecined content.
    """
    if phase is None:
        phase, _ = detect_pulldown_phase(fields)
    if phase % 2 != 0 or not 0 <= phase <= 8:
        raise ValueError(f"phase must be even in 0..8, got {phase}")
    x = jnp.asarray(fields, jnp.float32)
    skip = (10 - phase) % 10
    usable = (x.shape[0] - skip) // 10 * 10
    if usable <= 0:
        raise ValueError(
            f"no complete 10-field group after trimming {skip} leading "
            f"fields (got {x.shape[0]})"
        )
    g = x[skip : skip + usable].reshape(
        usable // 10, 10, *x.shape[1:]
    )  # (K, 10, 3, L/2, N)
    tops = g[:, jnp.asarray([p[0] for p in _PAIRS])]
    bots = g[:, jnp.asarray([p[1] for p in _PAIRS])]
    # interleave rows: top carries even rows, bottom odd (weave_fields
    # pattern, kept local to avoid a (2B)-reshape round trip)
    pair = jnp.stack([tops, bots], axis=-2)  # (K, 4, 3, L/2, 2, N)
    film = pair.reshape(pair.shape[:-3] + (-1, pair.shape[-1]))
    return film.reshape((-1,) + film.shape[2:])
