"""Device layer: share of the traced window with no operation on the card."""


def read(ctx):
    r = ctx.reduction
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.planes else None
