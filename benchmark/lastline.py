"""The result: one JSON object as the last line of standard output.

Keys: ``correct``, ``attempted``, ``failed``, ``metrics`` (name -> value and
unit), ``device``, in a traced run optionally ``breakdown``, and last
``check``: each number compared, with its limit.  The same numbers and
limits are the last lines of standard error.
"""

from __future__ import annotations

import json
import sys


def result(correct: bool, attempted: int, failed: int, metrics: dict,
           device: dict, check: dict, limits: dict,
           breakdown: dict | None = None) -> dict:
    """``metrics``: name -> (value, unit); ``check``: name -> value."""
    line = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": float(v), "unit": u} for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown:
        line["breakdown"] = breakdown
    line["check"] = {k: {"value": float(v), "limit": limits.get(k)}
                     for k, v in check.items()}
    return line


def emit(line: dict) -> None:
    for k, c in line["check"].items():
        print(f"check {k} = {c['value']!r}  limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
