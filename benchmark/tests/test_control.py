"""On the card: the lower-precision control fails the cell's limits and
sound runs of the program pass them (``benchmark/control.py``, short
windows of the cell's own traffic at its own size)."""

import json
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(gpu, workload):
    r = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", workload,
         "--seeds", "4242424242,4343434343", "--control-seeds", "4444444444",
         "--seconds", "0.3"],
        cwd=spec.ROOT, env=gpu, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["control_fails"] and summary["sound_pass"], summary
