"""A whole run rehearsed on the CPU, and the refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _bench(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_gpu():
    r = _bench(spec.ROOT)
    assert r.returncode != 0
    assert "no GPU" in r.stderr and '"correct"' not in r.stdout


def test_refuses_in_a_directory_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _bench(tmp_path, {"PYTHONPATH": ""})
    assert r.returncode != 0 and '"correct"' not in r.stdout


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_is_correct(cpu_run, capsys, workload, trace):
    assert cpu_run(workload, trace=trace) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    cell = spec.load_cell(workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert line["correct"] is True, err[-2000:]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert list(line)[-1] == "check" and all(
        c["value"] <= c["limit"] for c in line["check"].values())
    if trace:
        # no device plane on the CPU: device readers find nothing and say so
        assert set(line["metrics"]) <= {m["name"] for m in want}
        assert "busy_s" in line["device"] and "breakdown" in line
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
