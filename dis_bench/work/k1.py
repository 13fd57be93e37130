"""K1 (`csrc/gn_fused.cu`): the GN loop of the levels of up to 512
patches a pair, over one call of b pairs."""

from dis_bench.work.gn import levels_work

LIBRARY = "gn_fused"


def work(b: int, full_w: int, full_h: int, params):
    """(bytes, flops) of K1's levels of one call."""
    return levels_work(b, full_w, full_h, params, tiled=False)
