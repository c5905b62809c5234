"""Multi-process (multi-host) execution smoke (SURVEY.md §4.3, §2.4).

``init_distributed`` (parallel/mesh.py) was, through round 1, a guarded
passthrough that no test ever executed — all multi-device evidence came
from single-process virtual meshes.  This module actually RUNS the
multi-process path (VERDICT r1 item 2): ``launch_smoke`` spawns N worker
processes on this machine, each owning ``devices_per_proc`` virtual CPU
devices; the workers form one global ``(frame, lineblk)`` mesh through a
localhost coordinator (JAX's distributed runtime + Gloo CPU collectives),
run ONE sharded round-trip step on a deterministic fixture, and write their
addressable output shards to disk.  The launcher reassembles the global
output and returns it next to the single-process unsharded reference so the
caller can assert equivalence — bit-identical on the QAM paths, the same
invariant tests/test_sharding.py enforces in-process.

On several real hosts the same worker body runs unchanged (one process
per host, the accelerator backend supplying local devices instead of
``xla_force_host_platform_device_count``); only the spawning differs.

Worker entry: ``python -m color_modem_tpu.parallel.multihost --process-id I
--num-processes N ...`` (used by ``launch_smoke`` and directly debuggable).
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

#: fixture geometry: 2 frames x 32 lines x 720 samples, NTSC comb3 —
#: the flagship config at smoke scale (line blocks of 8 >= the 2-line halo)
SMOKE_STANDARD = "ntsc"
SMOKE_DECODER = "comb3"
SMOKE_FRAMES = 2
SMOKE_LINES = 32


def smoke_frames(num_processes: int) -> int:
    """Fixture frame count: the frame mesh axis spans the processes, so it
    must divide the frame count.  max() keeps the historical 2-frame
    fixture for 1-2 processes and scales 1 frame/process beyond."""
    return max(SMOKE_FRAMES, num_processes)


def _fixture(frames: int, lines: int, samples: int = 720) -> np.ndarray:
    from color_modem_tpu.utils.testimages import smooth_scene

    return np.stack([
        smooth_scene(lines, samples, seed=100 + f) for f in range(frames)
    ]).astype(np.float32)


def _sound_fixture(plan, frames: int, lines: int) -> np.ndarray:
    """(frames, lines*N) two-tone soundtrack — consecutive frames of one
    broadcast stream, deterministic across processes."""
    t = np.arange(frames * lines * plan.n_samples) / plan.fs
    return (0.6 * np.sin(2 * np.pi * 700.0 * t)
            + 0.3 * np.sin(2 * np.pi * 4300.0 * t)).astype(
        np.float32).reshape(frames, lines * plan.n_samples)


def reference_outputs(frames: int = SMOKE_FRAMES,
                      lines: int = SMOKE_LINES):
    """Single-process unsharded (encode, roundtrip) for the smoke fixture."""
    import jax.numpy as jnp

    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS

    plan = make_plan(ALL_STANDARDS[SMOKE_STANDARD](), 720)
    enc, _, rt = make_pipeline(plan, SMOKE_DECODER)
    x = jnp.asarray(_fixture(frames, lines))
    return np.asarray(enc(x, 0)), np.asarray(rt(x, 0))


def sound_reference_outputs(frames: int, lines: int):
    """Single-process UNSHARDED RF-hop-with-sound (rgb, audio) reference
    for the sound fixture — the chain make_sharded_rf_sound_pipeline must
    reproduce across processes (float tolerance; the stream FFTs' fp
    schedule depends on the per-device batch shape)."""
    import jax.numpy as jnp

    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.frame.rf import (
        make_rf_plan, rf_demodulate, rf_modulate, sound_from_rf,
        sound_on_rf,
    )
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import ALL_STANDARDS

    plan = make_plan(ALL_STANDARDS[SMOKE_STANDARD](), 720)
    rfp = make_rf_plan(plan)
    enc, dec, _ = make_pipeline(plan, SMOKE_DECODER)
    x = jnp.asarray(_fixture(frames, lines))
    aud = jnp.asarray(_sound_fixture(plan, frames, lines))
    rf = rf_modulate(rfp, enc(x, 0), 0)
    rf = sound_on_rf(rfp, rf, 0, aud, 0.0)
    return (np.asarray(dec(rf_demodulate(rfp, rf, 0), 0)),
            np.asarray(sound_from_rf(rfp, rf, 0)))


def sharded_reference_outputs(frames: int, lines: int,
                              mesh_shape: tuple) -> tuple:
    """IN-PROCESS sharded (encode, roundtrip) on the same mesh factoring.

    The strongest multi-process equivalence claim is against THIS pair:
    the per-device program is identical, so crossing process boundaries
    (Gloo collectives instead of intra-process transfers) must change
    nothing at all — measured BIT-identical.  Against the unsharded
    pipeline the bound is the usual float-1e-6 (per-block shapes change
    XLA CPU's fp scheduling; tests/test_sharding.py's bit-equality rows
    hold at that suite's specific block geometry)."""
    from color_modem_tpu.frame.pipeline import make_pipeline  # noqa: F401
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.parallel import make_mesh, make_sharded_pipeline
    from color_modem_tpu.standards import ALL_STANDARDS

    plan = make_plan(ALL_STANDARDS[SMOKE_STANDARD](), 720)
    mesh = make_mesh(*mesh_shape)
    enc, _, rt = make_sharded_pipeline(plan, mesh, SMOKE_DECODER)
    x = _fixture(frames, lines)
    return np.asarray(enc(x, 0)), np.asarray(rt(x, 0))


def worker_main(process_id: int, num_processes: int, port: int,
                outdir: str, devices_per_proc: int = 4) -> None:
    """One smoke process: join the cluster, run the sharded step, dump shards.

    Must run in a FRESH process (before any JAX backend initializes): it
    pins the CPU platform and the virtual device count, then calls
    ``jax.distributed.initialize`` via ``parallel.mesh.init_distributed``.
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={devices_per_proc}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if os.environ.get("CMTPU_DEBUG_NANS"):
        # bitwise encode equality vs a reference process requires BOTH
        # sides to compile identically — debug_nans changes fusion, so the
        # launcher propagates the parent's setting (launch_smoke docstring)
        jax.config.update("jax_debug_nans", True)

    from color_modem_tpu.parallel.mesh import init_distributed

    init_distributed(
        f"localhost:{port}",
        num_processes=num_processes,
        process_id=process_id,
        # keep the coordinator from scanning network interfaces
        local_device_ids=list(range(devices_per_proc)),
    )
    assert jax.process_count() == num_processes, (
        jax.process_count(), num_processes)
    assert jax.device_count() == num_processes * devices_per_proc

    import jax.numpy as jnp

    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.parallel import make_mesh, make_sharded_pipeline
    from color_modem_tpu.parallel.mesh import rgb_sharding
    from color_modem_tpu.standards import ALL_STANDARDS
    from color_modem_tpu.utils.metrics import psnr_jnp

    # frame axis spans the processes (no steady-state traffic, mesh.py);
    # line blocks stay within each process
    mesh = make_mesh(num_processes, devices_per_proc)
    plan = make_plan(ALL_STANDARDS[SMOKE_STANDARD](), 720)
    encode, _, roundtrip = make_sharded_pipeline(plan, mesh, SMOKE_DECODER)

    data = _fixture(smoke_frames(num_processes), SMOKE_LINES)
    sharding = rgb_sharding(mesh)
    x = jax.make_array_from_callback(
        data.shape, sharding, lambda idx: data[idx]
    )

    # standalone encode: the path the in-process invariant holds BIT-exact
    # on QAM standards (tests/test_sharding.py); roundtrip composition is
    # the 1e-6 bound (jit fuses enc+dec differently than separate calls)
    comp = encode(x, 0)
    out = roundtrip(x, 0)
    # one GLOBAL collective scalar: proves cross-process reductions work,
    # not just the sharded compute
    quality = jax.jit(psnr_jnp, out_shardings=None)(
        out, jnp.asarray(data, dtype=jnp.float32)
    )
    jax.block_until_ready(out)

    def _shards(arr, tag):
        d = {}
        for s in arr.addressable_shards:
            # key = the shard's global start offsets; extent is its shape
            d[tag + ";".join(str(sl.start or 0) for sl in s.index)] = (
                np.asarray(s.data)
            )
        return d

    # --- RF hop + joined-stream FM sound across the processes ----------
    # The round-5 sound sharding's collectives (the exclusive-prefix
    # all_gather and the neighbor-frame ppermute ring over the FLAT
    # device grid) must ride Gloo across process boundaries like the
    # video halos do.  One frame per device (the factory needs the batch
    # to divide the flat grid).
    from jax.sharding import NamedSharding, PartitionSpec as P

    from color_modem_tpu.frame.rf import make_rf_plan
    from color_modem_tpu.parallel.mesh import FRAME_AXIS, LINE_AXIS
    from color_modem_tpu.parallel.sharded import (
        make_sharded_rf_sound_pipeline,
    )

    rfp = make_rf_plan(plan)
    b_snd = num_processes * devices_per_proc
    snd_rgb = _fixture(b_snd, SMOKE_LINES)
    snd_aud = _sound_fixture(plan, b_snd, SMOKE_LINES)
    xs = jax.make_array_from_callback(
        snd_rgb.shape, sharding, lambda idx: snd_rgb[idx]
    )
    aud_sharding = NamedSharding(mesh, P((FRAME_AXIS, LINE_AXIS), None))
    xa = jax.make_array_from_callback(
        snd_aud.shape, aud_sharding, lambda idx: snd_aud[idx]
    )
    _, _, rt_snd = make_sharded_rf_sound_pipeline(
        plan, mesh, rfp, SMOKE_DECODER
    )
    out_s, aud_s = rt_snd(xs, xa, 0)
    jax.block_until_ready(aud_s)

    od = pathlib.Path(outdir)
    od.mkdir(parents=True, exist_ok=True)
    np.savez(
        od / f"proc{process_id}.npz",
        psnr=np.float32(float(quality)),
        **_shards(out, "rt:"),
        **_shards(comp, "enc:"),
        **_shards(out_s, "rfs:"),
        **_shards(aud_s, "aud:"),
    )
    print(f"multihost worker {process_id}/{num_processes}: "
          f"psnr={float(quality):.2f} dB, "
          f"{len(out.addressable_shards)} local shards", flush=True)


class _WorkerFailed(Exception):
    """A worker exited nonzero; carries which one and its combined log."""

    def __init__(self, process_id: int, returncode: int, log: str):
        super().__init__(f"worker {process_id} rc={returncode}")
        self.process_id = process_id
        self.returncode = returncode
        self.log = log


def _spawn_and_wait(
    num_processes: int,
    devices_per_proc: int,
    port: int,
    od: str,
    env: dict,
    repo: str,
    timeout: float,
) -> list[str]:
    """Spawn the workers and poll them ALL: a worker that dies early (import
    error, bad env, port race) surfaces within ~0.2 s instead of after the
    coordinator's full timeout, which is what a sequential communicate()
    loop pinned on process 0 would cost."""
    import time

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "color_modem_tpu.parallel.multihost",
             "--process-id", str(i), "--num-processes", str(num_processes),
             "--port", str(port), "--outdir", od,
             "--devices-per-proc", str(devices_per_proc)],
            env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(num_processes)
    ]
    logs: list[str | None] = [None] * num_processes
    deadline = time.monotonic() + timeout
    try:
        pending = set(range(num_processes))
        while pending:
            for i in sorted(pending):
                if procs[i].poll() is None:
                    continue
                logs[i] = procs[i].stdout.read()
                procs[i].stdout.close()
                pending.discard(i)
                if procs[i].returncode != 0:
                    raise _WorkerFailed(i, procs[i].returncode, logs[i])
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"multihost workers {sorted(pending)} still running "
                        f"after {timeout:.0f}s"
                    )
                time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def launch_smoke(
    num_processes: int = 2,
    devices_per_proc: int = 4,
    outdir: str | None = None,
    timeout: float = 600.0,
) -> dict:
    """Spawn the workers, wait, reassemble; returns
    ``{"out": global_output, "ref": unsharded_reference, "psnr": [...]}``."""
    import tempfile

    od = outdir or tempfile.mkdtemp(prefix="cmtpu_multihost_")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_proc}"
    )
    env.pop("JAX_PLATFORMS", None)  # worker pins cpu itself
    try:
        import jax

        if jax.config.jax_debug_nans:
            # match the parent's compile config so the bit-equality
            # comparison compares equal executables (worker_main docstring)
            env["CMTPU_DEBUG_NANS"] = "1"
    except Exception:
        pass
    repo = str(pathlib.Path(__file__).resolve().parents[2])
    # The port comes from a bind-then-close probe, so another process can
    # grab it between the close and the coordinator's own bind (TOCTOU).
    # A coordinator that dies on a bind error is retried on a fresh port;
    # any other worker failure (or a timeout) propagates immediately.
    for attempt in range(3):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        try:
            logs = _spawn_and_wait(
                num_processes, devices_per_proc, port, od, env, repo, timeout
            )
            break
        except _WorkerFailed as e:
            bind_race = e.process_id == 0 and (
                "address in use" in e.log.lower() or "bind" in e.log.lower()
            )
            if not (bind_race and attempt < 2):
                raise RuntimeError(
                    f"multihost worker {e.process_id} failed "
                    f"(rc={e.returncode}):\n{e.log}"
                ) from None

    frames = smoke_frames(num_processes)
    ref_enc, ref_rt = reference_outputs(frames, SMOKE_LINES)
    b_snd = num_processes * devices_per_proc
    ref_snd_rgb, ref_snd_aud = sound_reference_outputs(b_snd, SMOKE_LINES)
    out = np.full_like(ref_rt, np.nan)
    enc = np.full_like(ref_enc, np.nan)
    out_s = np.full_like(ref_snd_rgb, np.nan)
    aud = np.full_like(ref_snd_aud, np.nan)
    dsts = {"rt": out, "enc": enc, "rfs": out_s, "aud": aud}
    psnrs = []
    for i in range(num_processes):
        z = np.load(pathlib.Path(od) / f"proc{i}.npz")
        psnrs.append(float(z["psnr"]))
        for key in z.files:
            if key == "psnr":
                continue
            tag, _, idx = key.partition(":")
            dst = dsts[tag]
            starts = [int(a) for a in idx.split(";")]
            sls = tuple(
                slice(st, st + ext) for st, ext in zip(starts, z[key].shape)
            )
            dst[sls] = z[key]
    for tag, dst in dsts.items():
        assert not np.isnan(dst).any(), (
            f"reassembly left holes in {tag} — bad shard index")
    senc, srt = sharded_reference_outputs(
        frames, SMOKE_LINES, (num_processes, devices_per_proc)
    )
    return {"out": out, "ref": ref_rt, "enc": enc, "ref_enc": ref_enc,
            "sharded_enc": senc, "sharded_rt": srt,
            "snd_out": out_s, "snd_aud": aud,
            "ref_snd_out": ref_snd_rgb, "ref_snd_aud": ref_snd_aud,
            "psnr": psnrs, "logs": logs}


def _cli() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    a = ap.parse_args()
    # Fault-injection hook (SURVEY.md §5.3): lets the failure-detection test
    # kill a chosen worker at startup and assert the launcher surfaces it
    # fast instead of burning the coordinator timeout.
    if os.environ.get("CMTPU_MULTIHOST_FAIL_PID") == str(a.process_id):
        print("fault injection: worker dying at startup", flush=True)
        sys.exit(3)
    worker_main(a.process_id, a.num_processes, a.port, a.outdir,
                a.devices_per_proc)


if __name__ == "__main__":
    _cli()
