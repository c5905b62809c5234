"""The result line: the contract's keys, ``check`` last, and the numbers
with their limits as the last lines of standard error."""

import json

from benchmark import lastline


def test_result_line_format(capsys):
    line = lastline.result(
        True, 400, 0, {"mpix_per_s": (2500.25, "Mpix/s"), "setup_s": (20.5, "s")},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 123},
        {"rgb_mse": 1e-15, "comp_mse": 2e-15}, {"rgb_mse": 1e-13, "comp_mse": 1e-13},
        breakdown={"device_ops": [["gemm", 0.5]], "idle_gaps": [["dispatch", 0.01]]})
    lastline.emit(line)
    out, err = capsys.readouterr()
    got = json.loads(out.strip().splitlines()[-1])
    assert list(got) == ["correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "check"]
    assert got["metrics"]["mpix_per_s"] == {"value": 2500.25, "unit": "Mpix/s"}
    assert got["check"]["rgb_mse"] == {"value": 1e-15, "limit": 1e-13}
    assert err.strip().splitlines()[-2:] == [
        "check rgb_mse = 1e-15  limit 1e-13", "check comp_mse = 2e-15  limit 1e-13"]


def test_no_breakdown_key_when_untraced():
    line = lastline.result(False, 1, 1, {}, {}, {"rgb_mse": 1.0}, {})
    assert "breakdown" not in line and list(line)[-1] == "check"
    assert line["check"]["rgb_mse"]["limit"] is None
