"""K6 (`csrc/gn_tiled.cu`) with the forward-backward merge: both patch
grids run the GN loop of the levels of more than 512 patches a pair, the
backward grid on the swapped pair over the same level geometry, so the
work is twice `work/k6.py`'s count of one grid."""

from dis_bench.work.gn import levels_work

LIBRARY = "gn_tiled"


def work(b: int, full_w: int, full_h: int, params):
    """(bytes, flops) of both grids' K6 levels of one call."""
    nbytes, flops = levels_work(b, full_w, full_h, params, tiled=True)
    return 2.0 * nbytes, 2.0 * flops
