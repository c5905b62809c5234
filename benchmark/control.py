"""Readings that set a cell's limits: sound runs and the lower-precision control.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2

In one process: for each seed the cell's own set-up, a short window of its
own traffic and the comparison with the reference, first through the
program as the configuration states it (float32, FIR products at
``HIGHEST``), then through the program with its FIR precision lowered to
the next step down, three bf16 passes (``BF16_BF16_F32_X3``).  Prints each
number per seed and, per number, the lower reading (the largest of the
sound runs) and the upper one (the smallest of the control's).  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: The step below the configuration's stated precision.
CONTROL_PRECISION = "BF16_BF16_F32_X3"


def readings(cell, seeds, seconds: float) -> list[dict]:
    from benchmark import harness

    traffic = harness.build(cell)
    out = []
    for seed in seeds:
        traffic.setup(seed)
        win = traffic.run(seconds)
        worst, compared, _ = traffic.check(cell.config, traffic.host_calls(win.kept))
        out.append({"seed": seed, "frames": compared, **worst})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    from benchmark import check, harness, spec

    cell = spec.load_cell(args.workload)
    harness.configure_cache()
    harness.require_chips(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl = [int(s) for s in args.control_seeds.split(",")]
    sound = readings(cell, seeds, args.seconds)

    import jax
    from color_modem_tpu.dsp import apply

    apply.FIR_PRECISION = getattr(jax.lax.DotAlgorithmPreset, CONTROL_PRECISION)
    control = readings(cell, ctrl, args.seconds)
    summary = {"workload": cell.name, "control": CONTROL_PRECISION}
    limits = cell.config.get("limits", {})
    for k in check.NUMBERS:
        lo = max(r[k] for r in sound)
        hi = min(r[k] for r in control)
        summary[k] = {"lower": lo, "upper": hi, "ratio": hi / lo if lo else None,
                      "limit": limits.get(k)}
    # the control must fail one of the cell's numbers on every seed
    summary["control_fails"] = all(
        any(r[k] > lim for k, lim in limits.items()) for r in control)
    summary["sound_pass"] = all(
        all(r[k] <= lim for k, lim in limits.items()) for r in sound)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
