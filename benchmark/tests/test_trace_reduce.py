"""The trace reduction, on hand-made events and on a trace recorded on the
card (``fixtures/ntsc_batch_trace.json``, written by ``make_fixture.py``)."""

import json
import os

import pytest

from benchmark.trace_reduce import Reduction

GPU = "/device:GPU:0"
STREAM = "Stream #7(Compute)"
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ntsc_batch_trace.json")


def _host(name, t, d):
    return {"plane": "/host:CPU", "line": "python", "name": name, "t": t, "d": d}


def _op(t, d, module, line=STREAM, name="gemm"):
    return {"plane": GPU, "line": line, "name": name, "t": t, "d": d, "module": module}


EVENTS = [
    _host("bench.window", 1000, 10000),
    _host("bench.dispatch", 1000, 500),
    _host("bench.wait", 6000, 4000),
    _op(500, 300, "jit_encode"),             # before the window
    _op(1500, 1000, "jit_encode"),
    _op(2500, 1000, "jit_encode", name="fusion"),
    _op(3500, 2000, "jit_decode"),
    _op(9000, 3000, "jit_decode"),           # clipped at the window's end
    _op(1500, 7500, "jit_decode", line="XLA Ops"),  # a summary line
]


def test_hand_made_events():
    r = Reduction(EVENTS)
    assert r.window_s == pytest.approx(1e-5)
    # busy: [1500, 5500] and [9000, 11000] -> 6000 ns of 10000
    assert r.busy_s == pytest.approx(6e-6)
    assert r.module_seconds("jit_encode") == pytest.approx(2e-6)
    assert r.module_seconds("jit_decode") == pytest.approx(4e-6)
    assert r.module_seconds("jit_nothing") == 0.0
    assert r.idle_gaps() == [["wait", pytest.approx(3.5e-6)],
                             ["dispatch", pytest.approx(5e-7)]]
    assert r.top_ops() == [["gemm", pytest.approx(5e-6)], ["fusion", pytest.approx(1e-6)]]


def test_no_device_plane_reads_no_device():
    r = Reduction([_host("bench.window", 0, 100)])
    assert r.planes == [] and r.busy_s == 0.0
    assert r.idle_gaps() == [["no device operation", pytest.approx(1e-7)]]


def test_recorded_card_trace():
    """12 calls of 16 frames at 480x720 on one H100; the expected numbers
    were worked out from the same events by a per-nanosecond timeline."""
    with open(FIXTURE) as f:
        fx = json.load(f)
    r = Reduction(fx["events"])
    want = fx["expected"]
    assert r.planes == [GPU]
    assert r.busy_s == pytest.approx(want["busy_s"], rel=1e-12)
    assert r.window_s == pytest.approx(want["window_s"], rel=1e-12)
    assert r.module_seconds("jit_encode") == pytest.approx(want["encode_s"], rel=1e-12)
    assert r.module_seconds("jit_decode") == pytest.approx(want["decode_s"], rel=1e-12)
    assert 0.0 < r.busy_s < r.window_s
    labels = {g[0] for g in r.idle_gaps()}
    assert labels <= {"dispatch", "wait", "host outside any span"}
