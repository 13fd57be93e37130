"""Parameter system of the PyTorch DIS optical-flow port (a copy of the
JAX package's params.py, so the port imports nothing of that package).

Reproduces the reference's parameter surface:
  - the full 20-parameter explicit form (reference: run_dense.cpp:270-295),
  - operating-point presets 1-4 (reference: run_dense.cpp:240-268),
  - the derived optimization parameters of `optparam` (reference: oflow.h:45-91,
    oflow.cpp:74-107) and per-scale `camparam` (reference: oflow.h:30-43,
    oflow.cpp:139-158),
  - patch-grid geometry (reference: patchgrid.cpp:41-75).

Everything here is static Python (hashable frozen dataclasses); nothing in
this module touches torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


# Fixed algorithm constants (reference: oflow.h:76-77).
MINERRVAL = 2.0        # densification weight floor: w = 1/max(MINERRVAL, err)
NORMOUTLIER = 5.0      # pseudo-Huber norm scale b

# Cost function ids (reference: oflow.h:59).
COST_L2 = 0
COST_L1 = 1
COST_HUBER = 2


def auto_first_scale(width: int, fratio: int = 5, patchsz: int = 8) -> int:
    """Coarsest-scale auto-selection (reference: run_dense.cpp:181-184).

    1/fratio * width is the maximum expected motion magnitude in the image.
    """
    return max(0, int(math.floor(math.log2((2.0 * float(width)) / (float(fratio) * float(patchsz))))))


@dataclasses.dataclass(frozen=True)
class DISParams:
    """Full parameter set; mirrors `optparam` (reference: oflow.h:45-91).

    `dp_thresh` is stored un-squared here; the solver squares it on use
    (the reference squares on ingest, oflow.cpp:87).
    """

    # Explicit parameters (reference CLI params 5..20, run_dense.cpp:270-295)
    sc_f: int = 5              # first (coarsest) scale
    sc_l: int = 3              # last (finest) scale
    max_iter: int = 12
    min_iter: int = 12
    dp_thresh: float = 0.05    # min rate of change of delta-p before descending
    dr_thresh: float = 0.95    # min rate of change of residual
    res_thresh: float = 0.0    # terminate if mean abs residual below this
    p_samp_s: int = 8          # patch edge length (pixels)
    patove: float = 0.4        # patch overlap fraction
    usefbcon: bool = False     # forward-backward merging
    patnorm: int = 1           # patch mean-normalization
    costfct: int = COST_L2     # 0 L2, 1 L1, 2 pseudo-Huber
    usetvref: bool = True      # TV refinement on/off
    tv_alpha: float = 10.0
    tv_gamma: float = 10.0
    tv_delta: float = 5.0
    tv_innerit: int = 1
    tv_solverit: int = 3
    tv_sor: float = 1.6
    verbosity: int = 0

    # Mode parameters (replace the reference's compile-time SELECTMODE /
    # SELECTCHANNEL; they only change tensor shapes)
    nop: int = 2               # parameters per pixel: 2 flow, 1 depth
    noc: int = 1               # channels: 1 gray, 3 RGB

    # Spatial (row-sharded) TV routing (`with_spatial_tv`): a level whose TV
    # working set reaches spatial_tv_min_bytes is split by rows over
    # spatial_tv_mesh, a `parallel.mesh.Mesh` (one axis of devices; the
    # axis name is kept for the reference package's field set). The Mesh
    # is a frozen dataclass, so a routed set stays hashable and differs
    # from the unrouted one.
    spatial_tv_mesh: object = None
    spatial_tv_min_bytes: int = 4 << 30
    spatial_tv_axis: str = "rows"

    @property
    def steps(self) -> int:
        # reference: oflow.cpp:90
        return max(1, int(math.floor(self.p_samp_s * (1.0 - self.patove))))

    @property
    def novals(self) -> int:
        # reference: oflow.cpp:91
        return self.noc * self.p_samp_s * self.p_samp_s

    @property
    def outlierthresh(self) -> float:
        # reference: oflow.cpp:81
        return float(self.p_samp_s) / 2.0

    @property
    def noscales(self) -> int:
        return self.sc_f - self.sc_l + 1

    @property
    def dp_thresh_sq(self) -> float:
        # reference: oflow.cpp:87
        return self.dp_thresh * self.dp_thresh


def with_spatial_tv(params: DISParams, mesh, min_bytes: int = None,
                    axis_name: str = "rows") -> DISParams:
    """A parameter set that routes large-level TV refinement through the
    row-sharded spatial path over `mesh` (mesh=None clears the route)
    (the JAX package's params.with_spatial_tv, params.py:111-122). The
    route travels inside the parameter set, so every entry point that
    takes it routes."""
    return dataclasses.replace(
        params, spatial_tv_mesh=mesh,
        spatial_tv_min_bytes=(4 << 30) if min_bytes is None else min_bytes,
        spatial_tv_axis=axis_name)


def op_point_params(width: int, sel_oppoint: int = 2, *, nop: int = 2,
                    noc: int = 1, verbosity: int = 0) -> DISParams:
    """Operating-point presets (reference: run_dense.cpp:226-268).

    `width` is the *unpadded* original image width (used for the automatic
    coarsest-scale selection, run_dense.cpp:244).
    """
    fratio = 5
    common = dict(
        dp_thresh=0.05, dr_thresh=0.95, res_thresh=0.0,
        usefbcon=False, patnorm=1, costfct=COST_L2,
        tv_alpha=10.0, tv_gamma=10.0, tv_delta=5.0,
        tv_innerit=1, tv_solverit=3, tv_sor=1.6,
        nop=nop, noc=noc, verbosity=verbosity,
    )
    if sel_oppoint == 1:
        psz, pov = 8, 0.3
        lv_f = auto_first_scale(width, fratio, psz)
        return DISParams(sc_f=lv_f, sc_l=max(lv_f - 2, 0), max_iter=16, min_iter=16,
                         p_samp_s=psz, patove=pov, usetvref=False, **common)
    if sel_oppoint == 3:
        psz, pov = 12, 0.75
        lv_f = auto_first_scale(width, fratio, psz)
        return DISParams(sc_f=lv_f, sc_l=max(lv_f - 4, 0), max_iter=16, min_iter=16,
                         p_samp_s=psz, patove=pov, usetvref=True, **common)
    if sel_oppoint == 4:
        psz, pov = 12, 0.75
        lv_f = auto_first_scale(width, fratio, psz)
        return DISParams(sc_f=lv_f, sc_l=max(lv_f - 5, 0), max_iter=128, min_iter=128,
                         p_samp_s=psz, patove=pov, usetvref=True, **common)
    # op-point 2 (default; reference: run_dense.cpp:260-266)
    psz, pov = 8, 0.4
    lv_f = auto_first_scale(width, fratio, psz)
    return DISParams(sc_f=lv_f, sc_l=max(lv_f - 2, 0), max_iter=12, min_iter=12,
                     p_samp_s=psz, patove=pov, usetvref=True, **common)


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Per-scale static geometry; mirrors `camparam` (reference: oflow.h:30-43)
    plus the patch-grid layout (reference: patchgrid.cpp:41-75)."""

    level: int          # pyramid level (sl in the reference)
    width: int          # level width, without the 2*pad patch padding
    height: int
    pad: int            # image padding on all sides (= p_samp_s)
    # patch grid
    steps: int
    nopw: int
    noph: int
    offsetw: int
    offseth: int
    # patch-position validity bounds (reference: oflow.cpp:147-149)
    tmp_lb: float
    tmp_ubw: float
    tmp_ubh: float
    camlr: int = 0      # 0 left camera, 1 right (depth only)

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
                    params: DISParams, camlr: int = 0) -> LevelSpec:
    """Build the static per-scale spec.

    `full_width`/`full_height` are the padded-to-divisible full-resolution
    dimensions; level dims follow oflow.cpp:142-145 (float-scale truncation).
    """
    sc_fct = 2.0 ** (-level)
    w = int(full_width * sc_fct)
    h = int(full_height * sc_fct)
    steps = params.steps
    nopw = int(math.ceil(float(w) / float(steps)))
    noph = int(math.ceil(float(h) / float(steps)))
    offsetw = int(math.floor((w - (nopw - 1) * steps) / 2))
    offseth = int(math.floor((h - (noph - 1) * steps) / 2))
    psz = params.p_samp_s
    return LevelSpec(
        level=level, width=w, height=h, pad=psz,
        steps=steps, nopw=nopw, noph=noph, offsetw=offsetw, offseth=offseth,
        tmp_lb=-float(psz) / 2.0,
        tmp_ubw=float(w + psz // 2 - 2),
        tmp_ubh=float(h + psz // 2 - 2),
        camlr=camlr,
    )


def grid_points(spec: LevelSpec) -> Tuple[list, list]:
    """Patch reference positions, column-major order i = x*noph + y
    (reference: patchgrid.cpp:61-75). Returns (xs, ys) int lists of length N."""
    xs, ys = [], []
    for x in range(spec.nopw):
        for y in range(spec.noph):
            xs.append(x * spec.steps + spec.offsetw)
            ys.append(y * spec.steps + spec.offseth)
    return xs, ys


def pad_amounts(width: int, height: int, lv_f: int) -> Tuple[int, int, int, int]:
    """Divisibility padding split (reference: run_dense.cpp:299-311).
    Returns (top, bottom, left, right)."""
    scfct = 2 ** lv_f
    padw = (scfct - width % scfct) % scfct
    padh = (scfct - height % scfct) % scfct
    return (int(math.floor(padh / 2.0)), int(math.ceil(padh / 2.0)),
            int(math.floor(padw / 2.0)), int(math.ceil(padw / 2.0)))
