"""Multi-process ``jax.distributed`` smoke (SURVEY.md §4.3 'Multi-host
smoke'; VERDICT r1 item 2 — the first actual execution of the multi-host
code path).

Two real OS processes, each with 4 virtual CPU devices, join through a
localhost coordinator and run the sharded flagship round trip over the
global (2, 4) (frame x lineblk) mesh — frame axis across processes, line
blocks within.  Cross-process halo exchange rides the
Gloo CPU collectives; a global PSNR reduction proves cross-process psum.

Equivalence bar: multi-process output is BIT-identical to the in-process
sharded pipeline on the same (2, 4) mesh factoring — the per-device program
is the same, so crossing process boundaries (Gloo collectives instead of
intra-process transfers) must change nothing at all.  Against the unsharded
pipeline the bound is the usual float 1e-6 (per-block shapes change XLA
CPU's fp scheduling; tests/test_sharding.py's bit-equality rows hold at
that suite's specific block geometry, not this one — measured 1.8e-7 here).
"""

import os
import pathlib
import socket
import time

import numpy as np
import pytest

from color_modem_tpu.parallel import multihost
from color_modem_tpu.parallel.multihost import launch_smoke


def test_dead_worker_surfaces_fast(tmp_path):
    """Failure detection (SURVEY.md §5.3): a worker that dies at startup is
    reported within seconds — naming the dead worker and its log — instead
    of the launcher blocking on the coordinator until its full timeout
    (what a sequential communicate() pinned on process 0 used to cost)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)
    env["CMTPU_MULTIHOST_FAIL_PID"] = "1"  # fault injection: kill worker 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = str(pathlib.Path(multihost.__file__).resolve().parents[2])
    t0 = time.monotonic()
    with pytest.raises(multihost._WorkerFailed) as ei:
        multihost._spawn_and_wait(
            2, 2, port, str(tmp_path), env, repo, timeout=300.0
        )
    elapsed = time.monotonic() - t0
    assert ei.value.process_id == 1
    assert ei.value.returncode == 3
    assert "fault injection" in ei.value.log
    # far below the 300 s coordinator timeout: detection is by polling,
    # not by waiting out process 0's jax.distributed.initialize
    assert elapsed < 60.0, f"dead worker took {elapsed:.0f}s to surface"


@pytest.mark.slow
def test_two_process_sharded_roundtrip_matches_single_process():
    r = launch_smoke(num_processes=2, devices_per_proc=4)
    # both processes computed the SAME global collective scalar
    assert r["psnr"][0] == pytest.approx(r["psnr"][1], abs=1e-4)
    assert r["psnr"][0] > 40.0, f"garbage roundtrip: {r['psnr']}"
    # vs IN-PROCESS SHARDED on the same mesh factoring: crossing process
    # boundaries changes nothing — bit-identical, encode and roundtrip
    np.testing.assert_array_equal(r["enc"], r["sharded_enc"])
    np.testing.assert_array_equal(r["out"], r["sharded_rt"])
    # vs UNSHARDED: the float composition bound (block shapes change
    # XLA CPU fp scheduling; measured max 1.8e-7 at this geometry)
    np.testing.assert_allclose(r["enc"], r["ref_enc"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(r["out"], r["ref"], atol=1e-6, rtol=0)
    # RF hop + joined-stream FM sound ACROSS PROCESSES (round 5): the
    # sound sharding's collectives — the exclusive-prefix all_gather and
    # the neighbor-frame ppermute ring over the flat grid — rode Gloo;
    # video and audio must match the unsharded joined chain at the
    # in-process tolerances (tests/test_sharding.py: 6.5e-6 / 1.6e-6)
    np.testing.assert_allclose(
        r["snd_out"], r["ref_snd_out"], atol=2e-5, rtol=0,
        err_msg="rf+sound video across processes")
    np.testing.assert_allclose(
        r["snd_aud"], r["ref_snd_aud"], atol=1e-5, rtol=0,
        err_msg="rf+sound audio across processes")
