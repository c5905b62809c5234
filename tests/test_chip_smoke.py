"""chip_smoke.py on the CPU: its refusal without a card, and a rehearsal of
every phase at a tiny size through the same code the card runs.

Also the entry points' shared set-up: the compile-cache rule, the peaks
table and the timing helper's refusal to time anything but the card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import chip_smoke
from color_modem_tpu.utils import profiling, runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABEL = "cpu rehearsal"


@pytest.fixture
def cpu_timing(monkeypatch):
    """Let ``time_calls`` time the CPU device: a rehearsal checks control
    flow and outputs, and its times are never reported as the card's."""
    monkeypatch.setattr(profiling, "require_gpu", lambda: jax.devices()[0])


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode != 0
    assert "no GPU" in run.stderr
    for line in run.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize(
    "standard,decoder,samples",
    [("ntsc", "comb3", 720), ("pal", "delayline", 720),
     ("secam", "interp", 720), ("secam", "interp", 1440)],
)
def test_modem_phase_rehearsal(cpu_timing, standard, decoder, samples):
    res = chip_smoke.modem_phase(LABEL, standard, decoder, 1, 128, samples,
                                 iters=1)
    assert res["psnr"] >= chip_smoke.ROUNDTRIP_BOUNDS[(standard, decoder)]
    assert min(res["parity"]) >= chip_smoke.PARITY_BOUND


def test_video_phase_rehearsal(tmp_path):
    res = chip_smoke.video_phase(LABEL, "pal", "delayline", 4, 2, 32, 720,
                                 str(tmp_path))
    assert res["summary"]["frames_processed_this_run"] == 4


def test_transmission_phase_rehearsal(cpu_timing):
    chip_smoke.transmission_phase(LABEL, 2, 64, 720)


def test_parity_phase_rehearsal():
    cpu = jax.devices("cpu")
    report = chip_smoke.parity_phase(LABEL, cpu[0], cpu[1])
    assert set(report) >= {"ntsc-comb3-rgb", "tx-rf", "nicam_l", "mts_l"}


def test_four_phase_rehearsal(tmp_path):
    chip_smoke.four_phase(LABEL, jax.devices()[:4], batch=16, lines=16,
                          pal_lines=16, video_lines=32, n_frames=8, chunk=4,
                          out_root=str(tmp_path))


def test_compile_cache_follows_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(runtime.CACHE_ENV, "/elsewhere/cache")
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_peaks_table_is_keyed_by_device_kind():
    h100 = profiling.chip_peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
                    "tf32_tflops": 495.0, "bf16_tflops": 989.0}
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.chip_peaks("cpu")


def test_timing_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        profiling.time_calls(lambda: np.zeros(1))
