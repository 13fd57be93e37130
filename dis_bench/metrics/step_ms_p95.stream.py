"""The 95th percentile, in ms, of every warm step of the window, each
from its dispatch to the synchronize that makes every stream's flow
ready (the benchmark's own clock)."""

import numpy as np


def read(ctx):
    if ctx.kind != "stream" or not ctx.steps:
        return None
    return float(np.percentile(ctx.steps, 95)) * 1e3
