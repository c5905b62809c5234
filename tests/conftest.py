"""Test configuration: force CPU with 8 virtual devices (SURVEY.md §4.3).

Tests run on the CPU backend with 8 virtual host devices, so the sharded
paths get a real multi-device mesh on any machine; the platform is set
*before any backend initializes*.

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them where no GPU is reachable.  The card is looked
for inside the fixture, never at import or collection, so every xdist
worker collects the same tests.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# the CLI entry point turns on the persistent compile cache; a test run
# writes nothing into the checkout
jax.config.update("jax_enable_compilation_cache", False)
# §5.2 sanitizer: fail any test whose pipeline produces NaN/Inf, loudly,
# at the op that produced it (the functional analog of a memory sanitizer)
jax.config.update("jax_debug_nans", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from color_modem_tpu.modem.plan import make_plan  # noqa: E402
from color_modem_tpu.standards import ALL_STANDARDS, NIIR, NTSC, PAL, SECAM  # noqa: E402

# Small-but-representative geometry: full 720-sample lines (the filters and
# fs depend on width), reduced line count for speed.
TEST_LINES = 64
TEST_SAMPLES = 720

_FACTORIES = dict(ALL_STANDARDS)
_PLAN_CACHE = {}


def get_plan(name: str):
    if name not in _PLAN_CACHE:
        _PLAN_CACHE[name] = make_plan(_FACTORIES[name](), TEST_SAMPLES)
    return _PLAN_CACHE[name]


@pytest.fixture(scope="session")
def scene():
    from color_modem_tpu.utils.testimages import smooth_scene

    return smooth_scene(TEST_LINES, TEST_SAMPLES, seed=1).astype(np.float32)


@pytest.fixture(scope="session")
def gpu():
    """Environment for a child process that runs on the card; skips the
    test where JAX finds no GPU.  This process is pinned to the CPU, so
    the card is looked for (and later used) by a child process."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform" not in f]
    env["XLA_FLAGS"] = " ".join(flags)
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("no GPU reachable from this machine")
    return env


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="run the full tier too (tests/_full_tier.txt — the slow "
        "physics cases skipped by the default fast tier)",
    )


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs the card (skips without one)")
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running (still in default run)"
    )
    config.addinivalue_line(
        "markers", "full: slow case, default tier skips it (--full runs all)"
    )


def _full_tier_ids():
    path = os.path.join(os.path.dirname(__file__), "_full_tier.txt")
    try:
        with open(path) as f:
            return {ln.strip() for ln in f
                    if ln.strip() and not ln.startswith("#")}
    except OSError:
        return set()


def pytest_collection_modifyitems(config, items):
    # Tiering (VERDICT r2 item 8): the generated tests/_full_tier.txt lists
    # the expensive cases; the default run skips them so iteration stays
    # < 3 min, `--full` runs everything (zero coverage loss — superset).
    # New/renamed tests are absent from the list, so they fail-safe into
    # the default tier.  Regenerate with scripts/retier_tests.py.
    if not config.getoption("--full"):
        full_ids = _full_tier_ids()
        skip_full = pytest.mark.skip(
            reason="full tier: run with --full (tests/_full_tier.txt)"
        )
        # explicit selection overrides the tier: naming a test (or its
        # function/file::function prefix) on the command line must RUN it,
        # not silently report '1 skipped' (round-3 review finding)
        explicit = {a.split("[", 1)[0] for a in config.args if "::" in a}
        for item in items:
            if item.nodeid in full_ids:
                if item.nodeid.split("[", 1)[0] in explicit:
                    continue
                item.add_marker(pytest.mark.full)
                item.add_marker(skip_full)
