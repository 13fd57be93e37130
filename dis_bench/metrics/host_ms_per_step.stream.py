"""The host's ms from a warm step's dispatch until `dis_step_warm`
returns, before the synchronize: the median over the window's steps (the
benchmark's own spans)."""

import statistics


def read(ctx):
    if ctx.kind != "stream" or not ctx.spans:
        return None
    return statistics.median(e - s for s, e in ctx.spans) * 1e3
