"""BENCHMARK.json: every cell loads by name, the file keeps the contract's
shape, and a cell defined only by new files loads with no edit here."""

import json
import os
import re

import pytest

from benchmark import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.load_reader(m["name"]))


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "new_cell")


def _fixture_tree(tmp_path):
    """A checkout whose cells, mixes, loop and metric come from the fixture,
    beside a copy of the benchmark's own code, none of it edited."""
    bench_dir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "loops"):
        (bench_dir / sub).mkdir(parents=True)
    cfg = json.load(open(os.path.join(spec.BENCH_DIR, "configs", "ntsc-comb3-480.json")))
    cfg.update(name="ntsc-notch-480", decoder="notch")
    (bench_dir / "configs" / "ntsc-notch-480.json").write_text(json.dumps(cfg))
    for sub, fname in (("traffic", "batch4.json"), ("traffic", "burst3.json"),
                       ("metrics", "calls_seen.py"), ("loops", "burst.py")):
        with open(os.path.join(FIXTURE, *(["loops"] if sub == "loops" else []), fname)) as f:
            (bench_dir / sub / fname).write_text(f.read())
    for sub in ("metrics", "loops"):  # the benchmark's own files, as committed
        for fname in os.listdir(os.path.join(spec.BENCH_DIR, sub)):
            if fname.endswith(".py"):
                with open(os.path.join(spec.BENCH_DIR, sub, fname)) as f:
                    (bench_dir / sub / fname).write_text(f.read())
    with open(os.path.join(FIXTURE, "BENCHMARK.json")) as f:
        (tmp_path / "BENCHMARK.json").write_text(f.read())
    return bench_dir


def test_cell_defined_only_by_new_files_loads(tmp_path):
    """A new configuration, traffic mix and metric are files and entries:
    nothing of the benchmark's own code is edited to run them."""
    bench_dir = _fixture_tree(tmp_path)
    bench = spec.load_benchmark(str(tmp_path))
    cell = spec.load_cell("ntsc-notch-480.batch4", bench=bench, root=str(tmp_path),
                          bench_dir=str(bench_dir))
    assert cell.config["decoder"] == "notch" and cell.traffic["frames_per_call"] == 4
    assert [m["name"] for m in cell.per_layer] == ["calls_seen"]
    read = spec.load_reader("calls_seen", bench_dir=str(bench_dir))

    class Ctx:
        class window:
            calls = 5
    assert read(Ctx) == 5.0


@pytest.mark.parametrize("trace", [0, 1])
def test_loop_defined_only_in_a_fixture_runs(tmp_path, monkeypatch, cpu_run, capsys, trace):
    """A new kind of traffic is a loop file: ``loops/burst.py`` exists only
    in the fixture, and a whole run of its cell comes out correct."""
    bench_dir = _fixture_tree(tmp_path)
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench_dir))
    assert cpu_run("ntsc-notch-480.burst3", trace=trace) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    want = {"calls_seen"} if trace else {"mpix_per_s", "setup_s"}
    assert set(line["metrics"]) == want
    if trace:  # three calls to a burst, two frames to a call
        assert line["metrics"]["calls_seen"]["value"] % 3 == 0
