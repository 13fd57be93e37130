"""K6's share of its roofline: the least time of the GN work of the
large levels of a call (`work/k6.py`) over the device time of
`csrc/gn_tiled.cu`'s kernels a call, in %."""


def read(ctx):
    return ctx.roofline("k6")
