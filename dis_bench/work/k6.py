"""K6 (`csrc/gn_tiled.cu`): the GN loop, templates built in the kernel, of
the levels of more than 512 patches a pair, over one call of b pairs."""

from dis_bench.work.gn import levels_work

LIBRARY = "gn_tiled"


def work(b: int, full_w: int, full_h: int, params):
    """(bytes, flops) of K6's levels of one call."""
    return levels_work(b, full_w, full_h, params, tiled=True)
