"""A run with the timed path broken underneath comes out not correct.

Each fault a single-card modem cell can have is planted in the program's
encode or decode jit and the rest of a run is driven as on the card (see
the ``cpu_run`` fixture): an output that is not updated in time, half of a batch
left out, and one answer altered where it is produced.  The cells here run
on one card, so there is no exchange between cards to leave out.
"""

import json

import jax.numpy as jnp
import pytest

from benchmark import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _stale(enc, dec):
    last = {}

    def decode(comp, frame0=0):  # the output buffer one call behind
        out = dec(comp, frame0)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return enc, decode


def _half(enc, dec):
    def decode(comp, frame0=0):  # the first half decoded, copied over the rest
        out = dec(comp, frame0)
        h = max(1, out.shape[0] // 2)
        return jnp.concatenate([out[:h], out[:h]])[: out.shape[0]]
    return enc, decode


def _altered_answer(enc, dec):
    def decode(comp, frame0=0):
        return dec(comp, frame0).at[:, 1, 3, 5].add(0.01)
    return enc, decode


def _altered_composite(enc, dec):
    def encode(rgb, frame0=0):
        return enc(rgb, frame0).at[:, 2, 7].add(0.01)
    return encode, dec


FAULTS = {"stale": _stale, "half_batch": _half, "altered_rgb": _altered_answer,
          "altered_composite": _altered_composite}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(cpu_run, capsys, monkeypatch, workload, fault):
    from color_modem_tpu.frame import pipeline

    if fault == "half_batch" and spec.load_cell(workload).traffic["frames_per_call"] == 1:
        pytest.skip("one frame per call: no half of a batch to leave out")
    real = pipeline.make_pipeline

    def broken(plan, decoder="notch", raster=False):
        enc, dec, rt = real(plan, decoder, raster)
        return (*FAULTS[fault](enc, dec), rt)

    monkeypatch.setattr(pipeline, "make_pipeline", broken)
    assert cpu_run(workload) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False and line["failed"] > 0
