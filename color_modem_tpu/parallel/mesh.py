"""Device mesh construction (SURVEY.md §2.4, §5.8).

The mesh has two named axes:

* ``"frame"``  — data parallelism over the frame batch: embarrassingly
  parallel, no steady-state collectives.
* ``"lineblk"`` — sequence/context parallelism over scanline blocks: each
  device owns a contiguous block of lines and exchanges 1-4 line halos with
  its ring neighbors (parallel/halo.py).  This is the framework's
  long-context story: the closed-form NCO (dsp/nco.py) means *no* sequential
  state crosses block boundaries — only stencil halos do.

The reference is strictly sequential single-process [SURVEY.md §2.4]; all of
this is new capability.  TP/EP are consciously out of scope (3x3 matrices,
no MoE — SURVEY.md §2.4); PP is subsumed by DP for this workload.

Ulysses-style ``all_to_all`` re-sharding (flipping between line-sharded and
sample-sharded layouts per stage) is consciously NOT used — the decision
SURVEY.md §2.4 asks to be documented: every FIR in the pipeline runs along
the sample axis and every stencil along the line axis, so the line-sharded
layout is optimal for *all* stages simultaneously; an ``all_to_all`` would
add two full-array transposes per stage to save halos that are only 1-4
lines deep.  The ring ``ppermute`` halo exchange (halo.py) moves ~1000x
fewer bytes at the target geometries.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAME_AXIS = "frame"
LINE_AXIS = "lineblk"


def make_mesh(
    frame: int | None = None,
    lineblk: int | None = None,
    devices=None,
) -> Mesh:
    """Build a ``(frame, lineblk)`` mesh over the given (or all) devices.

    With no arguments: all devices go to the frame axis (pure DP, the
    no-collective default).  Give ``lineblk`` to carve out context
    parallelism.  The cards of one host reach each other all to all at one
    rate, so the factoring follows the algorithm alone: the frame axis
    costs no steady-state traffic, the line axis a few halo lines per
    stage.  Across processes call :func:`init_distributed` first.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if frame is None and lineblk is None:
        frame, lineblk = n, 1
    elif frame is None:
        frame = n // lineblk
    elif lineblk is None:
        lineblk = n // frame
    if frame * lineblk > n or frame < 1 or lineblk < 1:
        raise ValueError(f"mesh {frame}x{lineblk} needs more than {n} devices")
    # both axes given explicitly may use a subset of the devices
    devices = devices[: frame * lineblk]
    dev_array = mesh_utils.create_device_mesh((frame, lineblk), devices=devices)
    return Mesh(dev_array, (FRAME_AXIS, LINE_AXIS))


def composite_sharding(mesh: Mesh) -> NamedSharding:
    """(frames, lines, samples): shard frames and line blocks, never samples.

    Keeping the sample axis unsharded is a deliberate design decision
    (SURVEY.md §5.7): all FIRs run along samples, so sharding it would force
    overlap-save halos on every filter; line-axis stencils are 1-4 lines
    deep, so halos on the line axis are tiny.
    """
    return NamedSharding(mesh, P(FRAME_AXIS, LINE_AXIS, None))


def rgb_sharding(mesh: Mesh) -> NamedSharding:
    """(frames, 3, lines, samples)."""
    return NamedSharding(mesh, P(FRAME_AXIS, None, LINE_AXIS, None))


def init_distributed(coordinator: str | None = None, **kw) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize`` passthrough.

    Guarded so single-process runs (and the CI fake-device mesh) never touch
    it; in a multi-process run each process calls this before
    :func:`make_mesh`
    (SURVEY.md §4.3 'Multi-host smoke').
    """
    # NOTE: do not probe jax.process_count() here — it initializes the XLA
    # backend, after which jax.distributed.initialize refuses to run (bug
    # found the first time this path actually executed, round 2)
    if jax.distributed.is_initialized():
        return  # already initialized by the launcher
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator, **kw)


def pad_to_multiple(x, axis: int, multiple: int):
    """Reflect-pad ``x`` along ``axis`` so its size divides the mesh axis.

    Returns (padded, original_size).  Sharded pipelines require the sharded
    axes to divide evenly; callers crop the output back.

    Reflect (not edge) padding on the LINE axis matters for correctness, not
    just shape: the bottom real line's comb/delay-line stencil reads the
    first padded line, and reflection supplies exactly the line the
    unsharded pipeline's edge reflection (separate.stencil.next_reflect)
    would read — so padded-then-cropped equals unpadded.  Edge padding would
    hand it a duplicate of itself and halve its chroma estimate.  For the
    frame axis both modes are fine (frames are independent).
    """
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    # reflect can pad at most size-1; only the first padded line is ever
    # read by a real line's stencil, so the fallback mode is inconsequential
    mode = "reflect" if 1 < size > rem else "edge"
    return np.pad(np.asarray(x), pad, mode=mode), size
