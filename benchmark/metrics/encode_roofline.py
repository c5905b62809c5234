"""Transmitter kernels' share of the roofline: the least time the card could
take for the essential work of one encode call (``benchmark/work.py``) over
the device time of one ``jit_encode`` run (its operations in the
traced window over the calls the window made)."""

from benchmark import peaks, work


def read(ctx):
    secs = ctx.reduction.module_seconds("jit_encode")
    runs = ctx.window.calls
    if secs <= 0 or not runs:
        return None
    flops, nbytes = work.stage_work(ctx.config, "encode", ctx.frames_per_call)
    share, bound = peaks.roofline(flops, nbytes, secs / runs, ctx.kind)
    ctx.note(f"encode_roofline: {bound}-bound, {flops} flops, {nbytes} bytes, "
             f"{secs / runs!r} s per run")
    return share
