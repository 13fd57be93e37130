"""K1's share of its roofline: the least time of the GN work of the
small levels of a call (`work/k1.py`, bytes against the HBM rate and
operations against the float32 rate, the larger) over the device time of
`csrc/gn_fused.cu`'s kernels a call, in %."""


def read(ctx):
    return ctx.roofline("k1")
