"""Receiver layer: device time of the decode jit (``jit_decode``) per frame."""


def read(ctx):
    secs = ctx.reduction.module_seconds("jit_decode")
    return secs / ctx.window.frames * 1e3 if secs > 0 and ctx.window.frames else None
