"""The share of the traced stretch of batch calls in which no activity
ran on the card: one minus the union of device activity over the
stretch's wall."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.events:
        return None
    return 1.0 - ctx.busy_us / ctx.window_us
