"""The essential work count: a hand count, and independence from the FIR
method the program happens to use (where XLA's own count changes)."""

import json
import os

import jax
import jax.numpy as jnp
import pytest

from benchmark import spec, work


def _config(name):
    with open(os.path.join(spec.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def test_ntsc_comb3_matches_hand_count():
    cfg = _config("ntsc-comb3-480")
    n = 720
    # encode: 3x3 matrix 18/px; two 129-tap FIRs 2*129 each; mixing 6
    assert work.flops_per_line(cfg, "encode") == 18 * n + 2 * 258 * n + 6 * n
    # decode: matrix 18/px; comb stencil 4, band-pass 258, luma 1, two
    # detectors 4, two low-passes 2*258, V sign 1
    assert work.flops_per_line(cfg, "decode") == 18 * n + (4 + 258 + 1 + 4 + 516 + 1) * n
    flops, nbytes = work.stage_work(cfg, "decode", 16)
    assert flops == 16 * 480 * work.flops_per_line(cfg, "decode")
    assert nbytes == 16 * 480 * 720 * (4 + 12)


def test_secam_counts_the_extended_lines():
    cfg = _config("secam-interp-576")
    flops = work.flops_per_line(cfg, "decode")
    assert flops > work.flops_per_line(cfg, "encode") > 0
    # 96 margin samples per line take every receiver FIR
    assert flops > (720 + 96) * 2 * (2 * 193 + 2 * 129 + 2 * 31 + 257 + 129)


@pytest.fixture
def method():
    from color_modem_tpu.dsp import apply

    yield apply.set_default_method
    apply.set_default_method("matmul")


def test_count_ignores_the_fir_method_where_xla_count_moves(method):
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS

    cfg = _config("ntsc-comb3-480")
    x = jnp.zeros((2, 3, 16, 720), jnp.float32)
    ours, xla = set(), set()
    for m in ("matmul", "conv", "fft"):
        method(m)
        plan = make_plan(ALL_STANDARDS["ntsc"](), 720)
        enc, _, _ = make_pipeline(plan, "comb3")
        cost = jax.jit(lambda v: enc(v, 0)).lower(x).compile().cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        xla.add(round(float(cost["flops"])))
        ours.add(work.stage_work(dict(cfg, lines=16), "encode", 2))
    assert len(ours) == 1
    assert len(xla) == 3
