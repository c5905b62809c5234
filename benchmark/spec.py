"""What a cell is, found by name from ``BENCHMARK.json`` and its own files.

Nothing here names a particular cell, traffic mix, loop or metric: a
workload entry names its configuration (``configs/<name>.json``, via the
``file`` of its ``configs`` entry) and its traffic mix
(``traffic/<name>.json``); the mix names the loop that drives it
(``loops/<loop>.py``), and each per-layer metric is read by
``metrics/<name>.py``.  A new cell, mix, loop or metric is new files and
entries, never an edit here.  The directories are looked up when a file is
loaded, so a test can point ``ROOT`` and ``BENCH_DIR`` at a tree of its own.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

#: The benchmark's own directory, and the checkout that holds it.
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple   # this cell's end-to-end metric entries
    per_layer: tuple    # this cell's per-layer metric entries


def load_benchmark(root: str | None = None) -> dict:
    with open(os.path.join(root or ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None, root: str | None = None,
              bench_dir: str | None = None) -> Cell:
    """The workload ``name`` with its configuration, traffic and metrics."""
    root, bench_dir = root or ROOT, bench_dir or BENCH_DIR
    bench = load_benchmark(root) if bench is None else bench
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, cfgs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = tuple(m for m in bench["end_to_end"] if _applies(m, name))
    moved = {m["name"] for m in e2e}
    per_layer = tuple(
        m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in moved
    )
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def _load_module(sub: str, name: str, bench_dir: str | None):
    path = os.path.join(bench_dir or BENCH_DIR, sub, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{sub}_" + name.replace(".", "_").replace("-", "_"), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, bench_dir: str | None = None):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _load_module("metrics", metric, bench_dir).read


def load_loop(loop: str, bench_dir: str | None = None):
    """The ``build(config, traffic)`` function of ``loops/<loop>.py``."""
    return _load_module("loops", loop, bench_dir).build
