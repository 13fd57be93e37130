"""The bytes and operations of one GN level of a call, from its shapes:
the arithmetic of the port's `chip_smoke.py::check_gn`, fed from the
benchmark's own level geometry. A patch of an op-point whose first and
last trip count are equal (min_iter = max_iter) runs every trip unless it
starts out of bounds or is reset; the count takes every patch's trips,
the most the inputs can need (resets are rare on smooth motion)."""

from __future__ import annotations


def level_work(b: int, spec, params, tiled: bool, n_trips: float = None):
    """(bytes, flops) of one GN level over b pairs: inputs read once,
    outputs written once; per patch element 15 operations an extraction,
    2 a trip and projection; K6 also builds the templates (the mean, the
    Hessian) and extracts once more for the weight. `n_trips`, the trips
    the patches ran, defaults to every patch running every trip."""
    c, hp, wp = params.noc, spec.padded_height, spec.padded_width
    n, nop, d = spec.nopatches, params.nop, params.novals
    nh = 3 if nop == 2 else 1
    if n_trips is None:
        n_trips = float(b * n * params.max_iter)
    nbytes = 4 * (b * c * hp * wp + nop * b * n + 2 * n
                  + nop * b * n + b * (d // c) * n + 1)
    if not tiled:
        nbytes += 4 * ((1 + nop) * b * d * n + nh * b * n)
        flops = d * (15.0 * (b * n + n_trips) + 2.0 * nop * n_trips)
    else:
        nbytes += 4 * (1 + nop) * b * c * hp * wp
        flops = d * (15.0 * (2 * b * n + n_trips)
                     + 2.0 * nop * (b * n + n_trips)
                     + (2.0 + 2.0 * nh) * b * n)
    return float(nbytes), float(flops)


def levels_work(b: int, full_w: int, full_h: int, params, tiled: bool):
    """(bytes, flops) summed over the levels of a call that run the small-
    level loop (tiled False, K1) or the large-level one (tiled True, K6)."""
    from dis_bench.geometry import make_level_spec, uses_tiled

    nbytes = flops = 0.0
    for sl in params.levels:
        spec = make_level_spec(sl, full_w, full_h, params)
        if uses_tiled(spec) == tiled:
            bb, ff = level_work(b, spec, params, tiled)
            nbytes += bb
            flops += ff
    return nbytes, flops
