"""The benchmark's CPU rehearsal tests.

They run on the CPU backend and write nothing into the checkout.  Tests
that need the card carry the ``gpu`` marker and take the ``gpu`` fixture,
which skips them where JAX finds no GPU; the card is looked for inside the
fixture, never at import or collection.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs the card (skips without one)")


@pytest.fixture(scope="session")
def gpu():
    """Environment for a child process on the card; skips without one."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("no GPU reachable from this machine")
    return env


@pytest.fixture
def cpu_run(monkeypatch):
    """``run.main`` on the CPU at a small size: the chip look, the peaks
    lookup, the compile cache and the matmul/copy probe are stood in for;
    the rest of a run -- set-up, window, readers, check, result -- is real.
    Returns f(workload, lines, trace, seconds) -> exit code."""
    from benchmark import harness, peaks, run, spec

    real = spec.load_cell

    def small(name, lines):
        c = real(name)
        cfg = dict(c.config, lines=lines)
        tr = dict(c.traffic, frames_per_call=min(2, c.traffic["frames_per_call"]), ring=2)
        return spec.Cell(c.name, c.chips, cfg, tr, c.end_to_end, c.per_layer)

    monkeypatch.setattr(harness, "require_chips", lambda n: jax.devices()[:n])
    monkeypatch.setattr(harness, "configure_cache", lambda: "disabled")
    monkeypatch.setattr(peaks, "peaks", lambda kind: peaks.PEAKS["NVIDIA H100 80GB HBM3"])
    monkeypatch.setattr(peaks, "probe", lambda: {"matmul_f32_flops": 1.0,
                                                 "copy_bytes_per_s": 1.0})

    def go(workload, lines=16, trace=0, seconds=0.5):
        monkeypatch.setattr(spec, "load_cell", lambda name: small(name, lines))
        return run.main(["--workload", workload, "--seed", str(2**33 + 7),
                         "--seconds", str(seconds), "--trace", str(trace)])

    return go
