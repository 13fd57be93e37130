"""Device activities (kernels, copies, fills) launched per batch call, from
the traced stretch: the host's dispatch work, which paces a call where the
card waits for it."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.events:
        return None
    return len(ctx.events) / ctx.calls
