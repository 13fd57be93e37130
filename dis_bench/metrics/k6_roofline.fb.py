"""K6's share of its roofline with the forward-backward merge: the least
time of both grids' GN work of the large levels of a call
(`work/k6_fb.py`) over the device time of `csrc/gn_tiled.cu`'s kernels a
call, in %. `k6_roofline` counts one grid, so it would read half of this
in a cell with the merge."""


def read(ctx):
    return ctx.roofline("k6_fb")
