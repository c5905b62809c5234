"""Whether the timed path's output is correct: the comparison with the reference.

For every call kept from the window (a seeded sample, see ``generator``)
the float64 reference encodes the same input frames and decodes its own
composite.  Per frame it reads the mean squared error and the largest
absolute error of the program's composite and of its decoded RGB; a
number is the worst frame's.  The numbers a cell is held to are those with
a limit in its configuration file (``limits``), each set from the readings
that ``benchmark/control.py`` takes of sound runs and of the
lower-precision control (see PERF.md); a number whose control reading is
not three times its sound one has no limit and is not compared.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import modem as ref

NUMBERS = ("comp_mse", "comp_max_err", "rgb_mse", "rgb_max_err")


def frame_numbers(plan, rgb_in, frame0, comp, rgb, decoder) -> dict:
    """Per-frame numbers, each an array over the call's frames."""
    want_comp = ref.encode(plan, rgb_in, frame0)
    want_rgb = ref.decode(plan, want_comp, frame0, decoder)
    dc = np.asarray(comp, np.float64) - want_comp
    dr = np.asarray(rgb, np.float64) - want_rgb
    return {
        "comp_mse": np.mean(dc * dc, axis=(1, 2)),
        "comp_max_err": np.max(np.abs(dc), axis=(1, 2)),
        "rgb_mse": np.mean(dr * dr, axis=(1, 2, 3)),
        "rgb_max_err": np.max(np.abs(dr), axis=(1, 2, 3)),
    }


def compare(config: dict, calls: list) -> tuple[dict, int, int]:
    """``calls``: host ``(rgb_in, frame0, comp, rgb)`` per kept call.

    Returns ({number: worst frame's value}, frames compared, frames over a
    limit).  A number that is not finite counts as infinite.
    """
    plan = ref.make_plan(config)
    limits = config.get("limits", {})
    worst = {k: 0.0 for k in NUMBERS}
    compared = failed = 0
    for rgb_in, frame0, comp, rgb in calls:
        per = frame_numbers(plan, rgb_in, frame0, comp, rgb, config["decoder"])
        bad = np.zeros(len(rgb_in), bool)
        for k in NUMBERS:
            v = np.nan_to_num(per[k], nan=np.inf)
            if k in limits:
                bad |= v > limits[k]
            worst[k] = max(worst[k], float(v.max()))
        compared += len(rgb_in)
        failed += int(bad.sum())
    return worst, compared, failed


def verdict(config: dict, worst: dict, compared: int) -> bool:
    """Correct when frames were compared and every number with a limit is
    within it; a configuration with no limit is never correct."""
    limits = config.get("limits", {})
    return compared > 0 and bool(limits) and all(
        np.isfinite(worst[k]) and worst[k] <= lim for k, lim in limits.items())
