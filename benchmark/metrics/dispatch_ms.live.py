"""Jit-entry layer: host time per frame spent handing the frame over --
the upload and the encode and decode calls, until both are queued -- from
the benchmark's own clock readings around those calls, in the window run
without the profiler (whose host work would be counted in it)."""


def read(ctx):
    d = ctx.plain_window.dispatch_s
    return sum(d) / len(d) * 1e3 if d else None
