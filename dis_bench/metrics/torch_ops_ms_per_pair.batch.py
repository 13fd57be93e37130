"""Device ms per pair of every activity of a batch call that is not a
hand-written kernel of the program (plain torch: pyramid, templates,
densify, the TV derivative stack, copies), from the traced stretch."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.events:
        return None
    us = sum(e.dur_us for e, c in zip(ctx.events, ctx.categories)
             if not c.startswith("hand: "))
    return us / 1e3 / (ctx.calls * ctx.pairs_per_call)
