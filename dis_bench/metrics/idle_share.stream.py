"""The share of the traced stretch of warm steps in which no activity ran
on the card: one minus the union of device activity over the stretch's
wall."""


def read(ctx):
    if ctx.kind != "stream" or not ctx.events:
        return None
    return 1.0 - ctx.busy_us / ctx.window_us
