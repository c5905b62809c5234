"""Card parity: the pipelines on the GPU vs the same process's CPU device.

The test process is pinned to the CPU by conftest, so the comparison runs
in a child process on the card: ``chip_smoke.parity_phase`` computes the
modems, receiver DSP, transmission hops and sound systems once on the GPU
and once on the CPU device and compares them at the tolerances stated in
``chip_smoke._parity_failures``.  Skips where no GPU is reachable.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_card_matches_cpu(gpu):
    code = (
        "import jax, chip_smoke\n"
        "chip_smoke.parity_phase('gpu parity', jax.devices()[0], "
        "jax.devices('cpu')[0])\n"
    )
    run = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=gpu,
        capture_output=True, text=True, timeout=1800,
    )
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
