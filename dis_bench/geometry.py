"""Level geometry of DIS, frozen here so that the reference and the work
counts take their shapes from the benchmark and never from the port.

A copy of the reference's arithmetic (lordnn/OF_DIS): the coarsest scale
chosen from the width (run_dense.cpp:181-184), the op-point's parameters
(run_dense.cpp:226-268, read from a configuration file), the per-scale
sizes (oflow.cpp:142-149) and the patch grid (patchgrid.cpp:41-75).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# the keys of a configuration file that are parameters of the algorithm
PARAM_KEYS = ("p_samp_s", "patove", "max_iter", "min_iter", "dp_thresh",
              "dr_thresh", "res_thresh", "usefbcon", "patnorm", "costfct",
              "usetvref", "tv_alpha", "tv_gamma", "tv_delta", "tv_innerit",
              "tv_solverit", "tv_sor", "nop", "noc")


def auto_first_scale(width: int, fratio: int, patchsz: int) -> int:
    """The coarsest scale for a frame `width` wide (run_dense.cpp:181-184)."""
    return max(0, int(math.floor(math.log2((2.0 * float(width))
                                           / (float(fratio) * float(patchsz))))))


@dataclasses.dataclass(frozen=True)
class Params:
    """One op-point's parameters at one frame width (the fields of the
    reference's `optparam`, oflow.h:45-91)."""
    sc_f: int
    sc_l: int
    p_samp_s: int
    patove: float
    max_iter: int
    min_iter: int
    dp_thresh: float
    dr_thresh: float
    res_thresh: float
    usefbcon: bool
    patnorm: int
    costfct: int
    usetvref: bool
    tv_alpha: float
    tv_gamma: float
    tv_delta: float
    tv_innerit: int
    tv_solverit: int
    tv_sor: float
    nop: int
    noc: int

    @property
    def steps(self) -> int:
        return max(1, int(math.floor(self.p_samp_s * (1.0 - self.patove))))

    @property
    def novals(self) -> int:
        return self.noc * self.p_samp_s * self.p_samp_s

    @property
    def outlierthresh(self) -> float:
        return float(self.p_samp_s) / 2.0

    @property
    def dp_thresh_sq(self) -> float:
        return self.dp_thresh * self.dp_thresh

    @property
    def levels(self) -> range:
        """The scales run, coarse to fine."""
        return range(self.sc_f, self.sc_l - 1, -1)


def params_for(config: dict, width: int) -> Params:
    """The parameters of a configuration file at frame width `width`: the
    coarsest scale from the width (`fratio`), the finest `levels_below`
    scales under it (floored at 0)."""
    sc_f = auto_first_scale(width, config["fratio"], config["p_samp_s"])
    sc_l = max(sc_f - config["levels_below"], 0)
    return Params(sc_f=sc_f, sc_l=sc_l,
                  **{k: config[k] for k in PARAM_KEYS})


def padded_size(h: int, w: int, sc: int) -> Tuple[int, int]:
    """(H, W) padded up to multiples of 2^sc (run_dense.cpp:299-311)."""
    k = 2 ** sc
    return h + (k - h % k) % k, w + (k - w % k) % k


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One scale's sizes and patch grid (camparam, oflow.h:30-43)."""
    level: int
    width: int
    height: int
    pad: int
    steps: int
    nopw: int
    noph: int
    offsetw: int
    offseth: int
    tmp_lb: float
    tmp_ubw: float
    tmp_ubh: float

    @property
    def nopatches(self) -> int:
        return self.nopw * self.noph

    @property
    def padded_width(self) -> int:
        return self.width + 2 * self.pad

    @property
    def padded_height(self) -> int:
        return self.height + 2 * self.pad


def make_level_spec(level: int, full_width: int, full_height: int,
                    params: Params) -> LevelSpec:
    """Scale `level` of a frame padded to full_width x full_height
    (oflow.cpp:142-149, patchgrid.cpp:41-75)."""
    sc_fct = 2.0 ** (-level)
    w = int(full_width * sc_fct)
    h = int(full_height * sc_fct)
    steps = params.steps
    nopw = int(math.ceil(float(w) / float(steps)))
    noph = int(math.ceil(float(h) / float(steps)))
    psz = params.p_samp_s
    return LevelSpec(
        level=level, width=w, height=h, pad=psz, steps=steps,
        nopw=nopw, noph=noph,
        offsetw=int(math.floor((w - (nopw - 1) * steps) / 2)),
        offseth=int(math.floor((h - (noph - 1) * steps) / 2)),
        tmp_lb=-float(psz) / 2.0,
        tmp_ubw=float(w + psz // 2 - 2),
        tmp_ubh=float(h + psz // 2 - 2))


# A level with more patches than this runs the GN loop that builds its
# templates itself (the large-level kernel K6); the others the small-level
# loop (K1). The two sum a patch in different orders.
TILED_MIN_PATCHES = 512


def uses_tiled(spec: LevelSpec) -> bool:
    return spec.nopatches > TILED_MIN_PATCHES
