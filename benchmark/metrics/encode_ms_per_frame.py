"""Transmitter layer: device time of the encode jit (``jit_encode``) per frame."""


def read(ctx):
    secs = ctx.reduction.module_seconds("jit_encode")
    return secs / ctx.window.frames * 1e3 if secs > 0 and ctx.window.frames else None
