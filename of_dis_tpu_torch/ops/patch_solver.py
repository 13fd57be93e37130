"""Batched inverse-compositional Gauss-Newton patch optimizer (the DIS core).

Port of the JAX package's patch_solver for the PyTorch/CUDA build. The
patch grid is a batch dimension: all N patches of a level advance through
masked Gauss-Newton iterations, and per-patch early stopping is an `active`
mask that reproduces the reference's convergence predicate
(patch.cpp:287-293, with min_iter gating).

On CUDA tensors the whole per-level loop is one hand-written kernel, for
flow (nop 2) and depth (nop 1), gray and RGB: `kernels.gn_fused`
(csrc/gn_fused.cu: one warp per patch, templates read from device memory,
the bilinear window read straight from the target planes) for small
levels, `kernels.gn_tiled` (csrc/gn_tiled.cu: the same loop with the
templates built in the kernel from the source planes) for large ones;
`uses_tiled` is the rule between them. `_gn_plain` and `_gn_tiled_plain`
below are their plain PyTorch twins, used for CPU tensors and held against
the kernels on the card. A patch too large for either kernel
(`uses_unfused`) takes the unfused route `gn_unfused`: the loop in
PyTorch, its extraction the kernel `kernels.bilerp_extract`
(csrc/bilerp_extract.cu), whose plain twin is `extract_bilinear`.

Numerics replicated from the reference:
  - template + gradient extraction at integer positions, optional patch
    mean-normalization (patch.cpp:298-343),
  - 2x2 (flow) / 1x1 (depth) Hessian from template gradients with the
    det==0 (h00==0) -> +1e-10 guard (patch.cpp:69-86), the determinant and
    the solve's numerators as the JAX package's XLA computes a * b - c * d:
    one fused multiply-add (`_fms`), so that a Hessian singular in float32
    (bilevel frames: h00 * h11 == h01^2 to rounding) gives JAX's finite
    step and not 0 / 0,
  - steepest-descent projection + closed-form SPD solve and p -= dp update
    (patch.cpp:170-184), the depth disparity clamped to the camera's sign
    before the reset test (patch.cpp:186-191),
  - outlier/bounds reset to the start parameters (patch.cpp:196-206),
  - bilinear patch extraction with ceil(pt+1e-5)/floor anchoring in float32
    (patch.cpp:346-413),
  - L2 / L1 / pseudo-Huber residual + weight kernels (patch.cpp:221-273).

Known deviation (as in the JAX package): a patch whose *initial* position is
out of bounds takes pweight from the cost-weight formula applied to its
template (the reference leaves it uninitialized).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from of_dis_tpu_torch import trace
from of_dis_tpu_torch.kernels import bilerp_extract, gn_fused, gn_tiled
from of_dis_tpu_torch.params import (COST_HUBER, COST_L1, COST_L2, DISParams,
                                     LevelSpec, MINERRVAL, NORMOUTLIER,
                                     grid_points)


class PatchTemplates(NamedTuple):
    """Per-level static patch data (outputs of InitializeGrid).

    D = psz*psz*noc flattened patch pixels (row-major j, i, c); N patches on
    the trailing axis; any leading batch axes."""
    tmpl: torch.Tensor   # (..., D, N) template patch (mean-normalized if patnorm)
    tdx: torch.Tensor    # (..., D, N) template x-gradient (never normalized)
    tdy: torch.Tensor    # (..., D, N) template y-gradient
    hes: torch.Tensor    # (..., 3, N) [H00, H01, H11]; depth: (..., 1, N)


class PatchResult(NamedTuple):
    """Per-level optimization result (inputs to densification)."""
    p: torch.Tensor        # (..., N, nop) final displacement parameters
    pt: torch.Tensor       # (..., N, 2) final patch position
    # (..., P, P, N) per-pixel splat-weight denominators max(w, MINERRVAL)
    # (patchgrid.cpp:253-260)
    pweight: torch.Tensor
    # () int32: Gauss-Newton iterations that ran with at least one active
    # patch in the batch
    iters: torch.Tensor


@lru_cache(maxsize=128)
def _grid_tables(spec: LevelSpec, device: str):
    """Static per-level tables on `device`, built once per level and device
    (a level of 51,300 patches costs tens of host milliseconds to list):
    the (N, 2) float32 reference positions and the (N,) row / column
    indices of each patch's pixel in the next coarser level's flow. Read
    only; 128 entries hold a call's at two shapes on four devices (op-4
    with the merge: 12 a shape, both grids at every level)."""
    xs, ys = (np.asarray(v) for v in grid_points(spec))
    ref = trace.upload(np.stack([xs, ys], axis=1), device, torch.float32)
    return (ref, trace.upload(ys // 2, device),
            trace.upload(xs // 2, device))


def grid_ref_points(spec: LevelSpec, device="cpu") -> torch.Tensor:
    """(N, 2) float32 patch reference positions, column-major patch order
    i = x*noph + y (patchgrid.cpp:61-75). Shared between calls: read only."""
    return _grid_tables(spec, str(device))[0]


@lru_cache(maxsize=128)
def _template_indices(spec: LevelSpec, psz: int, device: str):
    """Rows (psz*noph,) j-major and columns (psz*nopw,) i-major of every
    template pixel in the padded level image, on `device`: built once per
    level and device, shared by every call, read only."""
    lb = -psz // 2
    ybase = spec.offseth + lb + spec.pad
    xbase = spec.offsetw + lb + spec.pad
    j = np.arange(psz)[:, None]
    rows = ybase + np.arange(spec.noph)[None, :] * spec.steps + j
    cols = xbase + np.arange(spec.nopw)[None, :] * spec.steps + j
    return (trace.upload(rows.reshape(-1), device),
            trace.upload(cols.reshape(-1), device))


def _gather_templates(spec: LevelSpec, psz: int,
                      field: torch.Tensor) -> torch.Tensor:
    """(..., C, Hp, Wp) -> (..., D, N) template windows, D = (j, i, c) and
    N = (x, y) column-major, by two index gathers."""
    rows, cols = _template_indices(spec, psz, str(field.device))
    lead = field.shape[:-3]
    c = field.shape[-3]
    g = field.index_select(-2, rows).index_select(-1, cols)
    g = g.reshape(lead + (c, psz, spec.noph, psz, spec.nopw))
    nd = len(lead)
    # (c, j, y, i, x) -> (j, i, c, x, y)
    perm = tuple(range(nd)) + tuple(nd + k for k in (1, 3, 0, 4, 2))
    return g.permute(perm).reshape(lead + (psz * psz * c,
                                           spec.nopw * spec.noph))


def extract_templates(spec: LevelSpec, params: DISParams, im: torch.Tensor,
                      dx: torch.Tensor, dy: torch.Tensor) -> PatchTemplates:
    """InitializeGrid: template patches + gradients and the Hessians.

    im/dx/dy: (..., C, Hp, Wp) padded level images (patch.cpp:55-86)."""
    psz = params.p_samp_s
    tmpl = _gather_templates(spec, psz, im)
    tdx = _gather_templates(spec, psz, dx)
    tdy = _gather_templates(spec, psz, dy)
    # The template mean and the Hessian's sums accumulate in float64 and
    # round once, the Hessian's entries in one reduction: a float32 sum's
    # order follows the number of outputs on CUDA (how torch splits the
    # reduction), so a pair's templates, and its flow, would depend on the
    # pairs batched with it (the mean only where its float32 sum rounds:
    # 192 values of an RGB patch, or 144 of a 12-pixel one, at the coarse
    # levels' fine value steps).
    if params.patnorm > 0:
        tmpl = tmpl - tmpl.mean(dim=-2, keepdim=True,
                                dtype=torch.float64).to(torch.float32)

    prods = [tdx * tdx] + ([tdx * tdy, tdy * tdy] if params.nop == 2 else [])
    sums = torch.sum(torch.stack(prods, dim=-3), dim=-2,
                     dtype=torch.float64).to(torch.float32)
    h00 = sums[..., 0, :]
    if params.nop == 2:
        h01, h11 = sums[..., 1, :], sums[..., 2, :]
        guard = _det_zero(h00, h01, h11).to(h00.dtype) * 1e-10
        hes = torch.stack([h00 + guard, h01, h11 + guard], dim=-2)
    else:
        guard = (h00 == 0.0).to(h00.dtype) * 1e-10
        hes = (h00 + guard).unsqueeze(-2)
    return PatchTemplates(tmpl, tdx, tdy, hes)


def _det_zero(h00: torch.Tensor, h01: torch.Tensor,
              h11: torch.Tensor) -> torch.Tensor:
    """Whether fma(h00, h11, -(h01 * h01)), the determinant as the kernels
    and `_fms` compute it, is 0: h00 * h11 is exact in float64, and so is
    its comparison with the float32 h01 * h01 (as many launches as the
    float32 determinant's test; a difference below float32's least
    subnormal, which no Hessian of image gradients reaches, counts as
    nonzero here)."""
    return h00 * h11.double() == h01 * h01


def _fms(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         d: torch.Tensor) -> torch.Tensor:
    """a * b - c * d of float32 tensors as fma(a, b, -(c * d)) computes it
    (as XLA:CPU contracts the JAX package's expression, and the kernels'
    fmaf): c * d rounded to float32, then the exact a * b less it rounded
    once. a * b is exact in float64; the difference is rounded to float64
    to odd (its last bit set wherever it is inexact, the error from
    TwoSum), from which the rounding to float32 is that of the exact
    difference."""
    s = a.double() * b
    p = c * d
    r = s - p
    t = r - s
    err = (s - (r - t)) - (p + t)            # s - p == r + err, exactly
    toward = torch.nextafter(r, r + torch.sign(err) * r.abs())
    odd = (r.view(torch.int64) & 1) == 1
    return torch.where(odd, r, toward).float()


def _true_div(t: torch.Tensor, den: float) -> torch.Tensor:
    """t / den as a true division, as the kernel divides (on CUDA,
    `Tensor / float` multiplies by the reciprocal, which rounds differently
    unless den is a power of two: 192 = 8*8*3 is not)."""
    return torch.div(t, torch.full_like(t, den))


def loss_error_image(diff: torch.Tensor, costfct: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual transform + weights per cost function (patch.cpp:221-273).
    diff = extracted_patch - template. Returns (pdiff, pweight)."""
    if costfct == COST_L2:
        return diff, torch.abs(diff)
    if costfct == COST_L1:
        w = torch.sqrt(torch.abs(diff))
        return torch.where(diff >= 0.0, w, -w), w
    if costfct == COST_HUBER:
        bsq = NORMOUTLIER * NORMOUTLIER
        w = torch.sqrt(2.0 * bsq * (torch.sqrt(
            1.0 + _true_div(diff * diff, bsq)) - 1.0))
        return torch.where(diff >= 0.0, w, -w), w
    # outside {0,1,2} the reference computes nothing; defined as zeros
    return torch.zeros_like(diff), torch.zeros_like(diff)


def _pw_dense(pw: torch.Tensor, psz: int, noc: int) -> torch.Tensor:
    """Raw per-element cost weights (..., D, N) -> the densify splat-weight
    denominator (..., psz*psz, N): sum_c max(w_c, MINERRVAL), channels
    added in order as the `gn_fused` kernel adds them
    (patchgrid.cpp:253-260)."""
    if noc == 1:
        return torch.clamp(pw, min=MINERRVAL)
    shp = pw.shape
    p3 = torch.clamp(pw.reshape(shp[:-2] + (psz * psz, noc, shp[-1])),
                     min=MINERRVAL)
    dense = p3[..., 0, :]
    for c in range(1, noc):
        dense = dense + p3[..., c, :]
    return dense


def _solve_step(hes: torch.Tensor, rhs: torch.Tensor, nop: int
                ) -> torch.Tensor:
    """Closed-form SPD solve of H dp = rhs (Eigen .llt().solve,
    patch.cpp:182). hes (B, 3, N) or (B, 1, N); rhs (B, nop, N)."""
    if nop == 2:
        # the determinant and the two numerators in one `_fms` call: on the
        # card (`gn_unfused`'s loop) each call costs 18 launches a trip
        h00, h01, h11 = hes[:, 0:1], hes[:, 1:2], hes[:, 2:3]
        r0, r1 = rhs[:, 0:1], rhs[:, 1:2]
        v = _fms(torch.cat([h00, h11, h00], 1), torch.cat([h11, r0, r1], 1),
                 h01, torch.cat([h01, r1, r0], 1))
        return v[:, 1:] / v[:, :1]
    return rhs / hes


def extract_bilinear(im: torch.Tensor, pts: torch.Tensor, psz: int,
                     pad: int) -> torch.Tensor:
    """Bilinear patch extraction at float positions by direct gathers
    (getPatchStaticBil, patch.cpp:346-413).

    im (B, C, Hp, Wp); pts (B, N, 2). Returns (B, D, N), D = (j, i, c).
    Anchor = ceil(pt + 1e-5) and residual against floor(pt), both in
    float32; patch(j, i) = x-lerp of the y-lerped (psz+1)^2 window.
    Out-of-range window indices (only inactive patches reach them) clamp."""
    b, c, hp, wp = im.shape
    n = pts.shape[1]
    w1 = psz + 1
    pos_c = torch.ceil(pts + 1e-5).to(torch.int64)
    resid = pts - torch.floor(pts)
    rx = resid[:, :, 0][:, None, None, :]                # (B,1,1,N)
    ry = resid[:, :, 1][:, None, None, :]
    sx = pos_c[:, :, 0] - psz // 2 - 1 + pad             # (B, N)
    sy = pos_c[:, :, 1] - psz // 2 - 1 + pad
    off = torch.arange(w1, device=im.device)
    ys = (sy[:, None, :] + off[None, :, None]).clamp(0, hp - 1)   # (B,w1,N)
    xs = (sx[:, None, :] + off[None, :, None]).clamp(0, wp - 1)
    flat = im.reshape(b, c, hp * wp)
    idx = ys[:, :, None, :] * wp + xs[:, None, :, :]      # (B, w1y, w1x, N)
    win = torch.gather(flat, 2, idx.reshape(b, 1, -1).expand(b, c, -1))
    win = win.reshape(b, c, w1, w1, n)                    # (B, C, y, x, N)
    # y-lerp (rows j, j+1), then x-lerp (columns i, i+1), as the one-hot
    # extraction of the JAX package orders them
    gy = (1.0 - ry[:, :, None]) * win[:, :, :-1] + ry[:, :, None] * win[:, :, 1:]
    px = rx[:, :, None] * gy[:, :, :, 1:] + (1.0 - rx[:, :, None]) * gy[:, :, :, :-1]
    # (B, C, j, i, N) -> (B, j, i, C, N)
    return px.permute(0, 2, 3, 1, 4).reshape(b, psz * psz * c, n)


def _lane_sum(x: torch.Tensor, noc: int = 1) -> torch.Tensor:
    """Sum over the patch axis of (B, D, N), D = (pixel, channel), in the
    `gn_fused` kernel's float32 order: each of 32 lanes owns the pixels
    lane + 32k and adds their elements in (k, channel) order, then a
    butterfly halves the 32 partial sums. GN trips amplify rounding
    differences (a few patches of a level drift apart over 12 trips), so
    the twin sums exactly as the kernel does."""
    b, d, n = x.shape
    pix = d // noc
    k = -(-pix // 32)
    x = x.reshape(b, pix, noc, n)
    if k * 32 != pix:
        x = torch.cat([x, x.new_zeros((b, k * 32 - pix, noc, n))], dim=1)
    x = x.reshape(b, k, 32, noc, n)
    s = x[:, 0, :, 0]
    for j in range(k):
        for c in range(noc):
            if j or c:
                s = s + x[:, j, :, c]
    w = 32
    while w > 1:
        w //= 2
        s = s[:, :w] + s[:, w:2 * w]
    return s[:, 0]


def column_segment(psz: int) -> int:
    """The lanes of one patch in the `gn_tiled` kernel: the smallest power
    of two above psz (lane i holds column i of the patch's window)."""
    seg = 2
    while seg <= psz:
        seg *= 2
    return seg


def _column_sum(x: torch.Tensor, noc: int = 1) -> torch.Tensor:
    """Sum over the patch axis of (B, D, N), D = (row j, column i, channel
    c) of a psz x psz patch, in the `gn_tiled` kernel's float32 order: lane
    i of the patch's `column_segment(psz)` lanes holds column i and adds
    its elements in (j, c) order from the first; the lanes beyond psz hold
    0; then a butterfly halves the segment's partial sums."""
    b, d, n = x.shape
    psz = math.isqrt(d // noc)
    seg = column_segment(psz)
    x = x.reshape(b, psz, psz, noc, n)
    s = x[:, 0, :, 0]
    for j in range(psz):
        for c in range(noc):
            if j or c:
                s = s + x[:, j, :, c]
    s = torch.cat([s, s.new_zeros((b, seg - psz, n))], dim=1)
    w = seg
    while w > 1:
        w //= 2
        s = s[:, :w] + s[:, w:2 * w]
    return s[:, 0]


def _to_pt(pt_ref_t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Patch positions (B, 2, N) of parameters p (B, nop, N): the depth
    parameter moves a patch along x only."""
    if p.shape[1] == 2:
        return pt_ref_t + p
    return pt_ref_t + torch.cat([p, torch.zeros_like(p)], dim=1)


def _gn_plain(spec: LevelSpec, params: DISParams, im_b: torch.Tensor,
              tpl: PatchTemplates, p_init_t: torch.Tensor,
              pt_ref_t: torch.Tensor, carry_pweight: bool = True,
              extract=None, patch_sum=None):
    """Plain PyTorch masked Gauss-Newton loop with the semantics of the JAX
    package's `_gn_xla_path` (the twin of the `gn_fused` kernel).

    im_b (B, C, Hp, Wp); tpl fields (B, D, N); p_init_t (B, nop, N);
    pt_ref_t (1, 2, N). Returns (p (B, nop, N), pweight (B, psz*psz, N),
    iters () int32, trips (B, N) int32 — the trips each patch ran active).

    With carry_pweight the loop carries each patch's splat weight from its
    last active trip, as `gn_fused` does; without, the weight comes from one
    extraction at the final position after the loop, as `gn_tiled` takes it.
    Extraction is a pure function of the position, so both give the same
    bits. `extract` is the patch extraction, `extract_bilinear` unless the
    unfused route hands in the kernel's wrapper; `patch_sum` the sum over a
    patch in its kernel's order, `_lane_sum` (`gn_fused`) unless
    `_gn_tiled_plain` hands in `_column_sum`."""
    psz, pad, nop, noc = params.p_samp_s, spec.pad, params.nop, params.noc
    extract = extract or extract_bilinear
    patch_sum = patch_sum or _lane_sum
    novals = float(params.novals)
    b, n = im_b.shape[0], tpl.tmpl.shape[-1]

    def oob(pt):
        return ((pt[:, 0] < spec.tmp_lb) | (pt[:, 1] < spec.tmp_lb)
                | (pt[:, 0] > spec.tmp_ubw) | (pt[:, 1] > spec.tmp_ubh))

    def compute_err(pt):
        patch = extract(im_b, pt.transpose(1, 2).contiguous(), psz, pad)
        if params.patnorm > 0:
            mean = _true_div(patch_sum(patch, noc), float(patch.shape[1]))
            patch = patch - mean[:, None]
        pdiff, pweight = loss_error_image(patch - tpl.tmpl, params.costfct)
        mares = _true_div(patch_sum(pweight, noc), novals)
        return pdiff, pweight, mares

    def dense(pweight):
        return _pw_dense(pweight, psz, noc)

    # OptimizeStart (patch.cpp:118-154)
    pt0 = _to_pt(pt_ref_t, p_init_t)
    init_oob = oob(pt0)                                   # (B, N)
    pt0_safe = torch.where(init_oob[:, None, :], pt_ref_t, pt0)
    pdiff, pw_raw, mares = compute_err(pt0_safe)
    tmpl_pw = dense(loss_error_image(tpl.tmpl, params.costfct)[1])
    m = init_oob[:, None, :]
    pdiff = torch.where(m, tpl.tmpl, pdiff)
    pweight = torch.where(m, tmpl_pw, dense(pw_raw)) if carry_pweight \
        else None
    active = (~init_oob) & (params.max_iter > 0) & (mares > params.res_thresh)
    p = p_init_t
    dpn_init = torch.full((b, n), 1e-10, dtype=torch.float32,
                          device=im_b.device)
    trips = torch.zeros((b, n), dtype=torch.int32, device=im_b.device)
    it = 0
    while it < params.max_iter and bool(active.any()):
        act = active
        it += 1
        trips += act.to(torch.int32)
        # steepest-descent projection (patch.cpp:175-180)
        rhs = [patch_sum(tpl.tdx * pdiff, noc)]
        if nop == 2:
            rhs.append(patch_sum(tpl.tdy * pdiff, noc))
        dp = _solve_step(tpl.hes, torch.stack(rhs, dim=1), nop)
        p_new = p - dp
        if nop == 1:  # depth disparity sign clamp (patch.cpp:186-191)
            p_new = (p_new.clamp(max=0.0) if spec.camlr == 0
                     else p_new.clamp(min=0.0))
        pt_new = _to_pt(pt_ref_t, p_new)
        # outlier / out-of-bounds reset (patch.cpp:196-206)
        moved = torch.sqrt(torch.sum((pt_new - pt0) ** 2, dim=1))
        reset = (moved > params.outlierthresh) | oob(pt_new)
        p_new = torch.where(reset[:, None, :], p_init_t, p_new)
        pdiff_new, pw_raw, mares_new = compute_err(_to_pt(pt_ref_t, p_new))
        dp_sqnorm = torch.sum(dp * dp, dim=1)
        dpn_new = dp_sqnorm if it == 1 else dpn_init
        # convergence predicate (patch.cpp:290-293)
        gate = it < params.min_iter
        keep = ((it < params.max_iter) & (mares_new > params.res_thresh)
                & (gate | (dp_sqnorm / dpn_new >= params.dp_thresh_sq))
                & (gate | (mares_new / mares <= params.dr_thresh)))
        a3 = act[:, None, :]
        p = torch.where(a3, p_new, p)
        pdiff = torch.where(a3, pdiff_new, pdiff)
        if carry_pweight:
            pweight = torch.where(a3, dense(pw_raw), pweight)
        mares = torch.where(act, mares_new, mares)
        dpn_init = torch.where(act, dpn_new, dpn_init)
        active = act & keep & (~reset)
    if not carry_pweight:
        pt_fin = torch.where(m, pt_ref_t, _to_pt(pt_ref_t, p))
        pweight = torch.where(m, tmpl_pw, dense(compute_err(pt_fin)[1]))
    iters = torch.full((), it, dtype=torch.int32, device=im_b.device)
    return p, pweight, iters, trips


def _tiled_templates(spec: LevelSpec, params: DISParams, src
                     ) -> PatchTemplates:
    """Templates, gradients and Hessians from src = (im_a, dx_a, dy_a), each
    (B, C, Hp, Wp), as the `gn_tiled` kernel builds them: the same integer
    gathers as `extract_templates`, with the template mean and the Hessian
    entries summed in the kernel's column order (`_column_sum`) and the
    mean a true division. nop 1 reads no y-gradient (tdy is zero)."""
    psz, noc = params.p_samp_s, params.noc
    tmpl = _gather_templates(spec, psz, src[0])
    tdx = _gather_templates(spec, psz, src[1])
    if params.patnorm > 0:
        mean = _true_div(_column_sum(tmpl, noc), float(tmpl.shape[-2]))
        tmpl = tmpl - mean[:, None]
    h00 = _column_sum(tdx * tdx, noc)
    if params.nop == 2:
        tdy = _gather_templates(spec, psz, src[2])
        h01 = _column_sum(tdx * tdy, noc)
        h11 = _column_sum(tdy * tdy, noc)
        guard = _det_zero(h00, h01, h11).to(h00.dtype) * 1e-10
        hes = torch.stack([h00 + guard, h01, h11 + guard], dim=-2)
    else:
        tdy = torch.zeros_like(tdx)
        guard = (h00 == 0.0).to(h00.dtype) * 1e-10
        hes = (h00 + guard).unsqueeze(-2)
    return PatchTemplates(tmpl, tdx, tdy, hes)


def _gn_tiled_plain(spec: LevelSpec, params: DISParams, im_b: torch.Tensor,
                    src, p_init_t: torch.Tensor, pt_ref_t: torch.Tensor):
    """The plain twin of the `gn_tiled` kernel: templates from the source
    planes, the loop of `_gn_plain` without a carried splat weight, the
    weight from one extraction at the final position, every patch sum in
    the kernel's column order (`_column_sum`). Arguments as
    `kernels.gn_tiled.gn_tiled`; returns as `_gn_plain`."""
    return _gn_plain(spec, params, im_b, _tiled_templates(spec, params, src),
                     p_init_t, pt_ref_t, carry_pweight=False,
                     patch_sum=_column_sum)


# A level with more patches than this a pair runs `gn_tiled`, the others
# `gn_fused`. `gn_fused` reads templates that plain gathers have written to
# device memory: three (D, N) float32 arrays a pair, psz^2 / steps^2 times
# the source planes (16 times at op-3/4's patch size 12, overlap 0.75 — 88
# MB a pair at 1024x436 level 0); `gn_tiled` reads the source planes
# instead. Measured on an H100 (chip_smoke.py, `check_routes`, both routes
# on the same inputs at 1024x436): `gn_tiled` is the faster route at every
# level size tried, 32 to 51,300 patches a pair — 0.08-0.21 ms against
# 0.78-1.16 ms up to 817 patches (the gathers' dozen small launches and
# their index uploads cost more than either kernel), 1.25 to 3 times
# faster from 3,268 patches on — so no crossover sets this mark. It keeps
# op-1 / op-2 on `gn_fused`, the kernel written for them (their largest
# level has 448 patches at 1024x436, 480 at 192x160), and sends every
# larger level to `gn_tiled`: op-3/4's levels 3 to 0 at 1024x436 (817 to
# 51,300 patches) and levels 1 and 0 of a 192x160 frame (864 and 3,456).
TILED_MIN_PATCHES = 512


def uses_tiled(spec: LevelSpec) -> bool:
    """Whether `optimize_level_batched` sends this level to `gn_tiled`: a
    function of the level's static patch count alone."""
    return spec.nopatches > TILED_MIN_PATCHES


# Both GN kernels keep a patch in a warp's registers, at most 5 pixels a
# lane: 160 pixels, patch sizes up to 12 (every op-point). A larger patch
# (the 20-parameter form takes any size) runs the unfused route.
FUSED_MAX_PIXELS = 32 * 5


def uses_unfused(params: DISParams) -> bool:
    """Whether a level of these parameters takes `gn_unfused`: a function
    of the patch size alone."""
    return params.p_samp_s * params.p_samp_s > FUSED_MAX_PIXELS


def gn_unfused(spec: LevelSpec, params: DISParams, im_b: torch.Tensor,
               tpl: PatchTemplates, p_init_t: torch.Tensor,
               pt_ref_t: torch.Tensor):
    """The unfused GN route, for patches no fused kernel holds: the masked
    loop of `_gn_plain` in PyTorch, one host round trip per trip, with
    every patch extraction — one at the start, one per trip — the
    `bilerp_extract` kernel (as the JAX package's `_gn_xla_path` calls its
    extraction kernel). Arguments and results as `kernels.gn_fused
    .gn_fused`. CPU tensors make it `_gn_plain`: the kernel's wrapper runs
    its plain twin there."""
    return _gn_plain(spec, params, im_b, tpl, p_init_t, pt_ref_t,
                     extract=bilerp_extract.bilerp_extract)[:3]


def builds_templates(spec: LevelSpec, params: DISParams) -> bool:
    """Whether `optimize_level_batched`, given the source planes, sends
    this level to `gn_tiled`, which builds the templates in the kernel;
    every other route reads templates extracted beforehand."""
    return uses_tiled(spec) and not uses_unfused(params)


def optimize_level_batched(spec: LevelSpec, params: DISParams,
                           im_b: torch.Tensor, tpl, p_init: torch.Tensor,
                           src=None) -> PatchResult:
    """Optimize all patches of one level for a batch of frame pairs.

    im_b (B, C, Hp, Wp) padded target level; p_init (B, N, nop); tpl
    fields (B, D, N), or None when src = (im_a, dx_a, dy_a) — the source
    level and its gradients, each (B, C, Hp, Wp) — is given instead. A
    large level (`uses_tiled`) with src runs `gn_tiled`, which builds its
    templates itself; any other level runs `gn_fused` on tpl, extracted
    from src here when it is None; patches above 12 pixels a side
    (`uses_unfused`) run `gn_unfused` on tpl at any level size. CUDA
    tensors launch the kernels, CPU tensors their plain twins."""
    psz = params.p_samp_s
    b, n = im_b.shape[0], spec.nopatches
    pt_ref_t = grid_ref_points(spec, im_b.device).T[None].contiguous()
    p_init_t = p_init.transpose(1, 2).contiguous()        # (B, nop, N)
    if src is not None and builds_templates(spec, params):
        p_fin, pw, iters = gn_tiled.gn_tiled(spec, params, im_b, src,
                                             p_init_t, pt_ref_t)
    else:
        if tpl is None:
            if src is None:
                raise ValueError("optimize_level_batched needs tpl or src")
            tpl = extract_templates(spec, params, *src)
        route = gn_unfused if uses_unfused(params) else gn_fused.gn_fused
        p_fin, pw, iters = route(spec, params, im_b, tpl, p_init_t, pt_ref_t)
    return PatchResult(p=p_fin.transpose(1, 2),
                       pt=_to_pt(pt_ref_t, p_fin).transpose(1, 2),
                       pweight=pw.reshape(b, psz, psz, n),
                       iters=iters)


def init_from_coarser(spec: LevelSpec, params: DISParams,
                      flow_prev: torch.Tensor) -> torch.Tensor:
    """InitializeFromCoarserOF (patchgrid.cpp:195-211): nearest-pixel lookup
    of the coarser level's dense flow (..., h/2, w/2, nop), scaled x2.
    Returns (..., N, nop)."""
    _, py, px = _grid_tables(spec, str(flow_prev.device))
    return flow_prev[..., py, px, :] * 2.0
