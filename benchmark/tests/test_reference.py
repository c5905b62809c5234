"""The benchmark's reference against the program's frozen golden oracle.

The reference designs its own taps from the configuration file; here it
must give the oracle's taps and, per frame, the oracle's composite and RGB
to float64 rounding.  (The test may import the program; the reference
itself does not.)
"""

import json
import os

import numpy as np
import pytest

from benchmark import spec
from benchmark.reference import modem as ref

CONFIGS = [c["file"] for c in spec.load_benchmark()["configs"]]


@pytest.mark.parametrize("path", CONFIGS)
def test_reference_matches_golden_oracle(path):
    from color_modem_tpu import golden
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS
    from color_modem_tpu.utils.testimages import smooth_scene

    with open(os.path.join(spec.ROOT, path)) as f:
        cfg = json.load(f)
    plan = ref.make_plan(cfg)
    gp = make_plan(ALL_STANDARDS[cfg["standard"]](), cfg["samples"])
    for name, taps in plan.taps.items():
        np.testing.assert_array_equal(taps, getattr(gp, name))
    rgb = np.stack([smooth_scene(12, cfg["samples"], seed=s) for s in (3, 4)])
    frame0 = 987654
    comp = ref.encode(plan, rgb, frame0)
    out = ref.decode(plan, comp, frame0, cfg["decoder"])
    for f in range(2):
        gc = golden.encode_frame(gp, rgb[f], frame=frame0 + f)
        go = golden.decode_frame(gp, gc, frame=frame0 + f, decoder=cfg["decoder"])
        np.testing.assert_allclose(comp[f], gc, rtol=0, atol=1e-11)
        np.testing.assert_allclose(out[f], go, rtol=0, atol=1e-11)


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(spec.BENCH_DIR, "reference")):
        if name.endswith(".py"):
            with open(os.path.join(spec.BENCH_DIR, "reference", name)) as f:
                assert "color_modem_tpu" not in f.read().replace(
                    "of ``color_modem_tpu``", ""), name
