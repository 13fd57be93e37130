"""K8 (`csrc/fb_splat.cu`): the forward-backward merge's splats over one
call of b pairs. At every level the backward grid's patches splat into
the forward flow; above the last level the forward grid's also splat
into the backward flow (oflow.cpp:266). A splat reads each patch's
pweight (psz^2 floats), p (nop floats) and pt (2 floats) once and writes
the 1 + nop float32 planes of its level once; its operations are four
taps x (1 + nop) multiply-adds a footprint pixel, counted over every
footprint pixel of every patch (the valid ones are fewer only at the
border). The bytes bind: ~6 operations a byte against the card's ~20."""

from __future__ import annotations

from dis_bench.geometry import make_level_spec

LIBRARY = "fb_splat"


def work(b: int, full_w: int, full_h: int, params):
    """(bytes, flops) of K8's splats of one call."""
    planes = 1 + params.nop
    pix = params.p_samp_s * params.p_samp_s
    nbytes = flops = 0.0
    for sl in params.levels:
        spec = make_level_spec(sl, full_w, full_h, params)
        merges = 2 if sl > params.sc_l else 1
        n = spec.nopatches
        nbytes += 4.0 * merges * b * (n * (pix + params.nop + 2)
                                      + planes * spec.height * spec.width)
        flops += 2.0 * merges * b * n * pix * 4 * planes
    return nbytes, flops
