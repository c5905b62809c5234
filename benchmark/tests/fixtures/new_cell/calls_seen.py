"""A per-layer metric that exists only in a test fixture."""


def read(ctx):
    return float(ctx.window.calls)
