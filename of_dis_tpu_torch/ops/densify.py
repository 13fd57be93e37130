"""Densification: patch displacements -> dense flow, deterministic
(PatGridClass::AggregateFlowDense, patchgrid.cpp:213-397).

Forward: each valid patch splats its displacement over its p x p integer
footprint, weighted per pixel by 1/max(minerrval, residual)
(patchgrid.cpp:223-275). The grid is regular, so coverage is separable per
axis: two contractions against static 0/1 cover matrices.

Backward merge (`usefbcon`): the complementary grid's patches splat their
NEGATED displacement bilinearly at their converged position
(patchgrid.cpp:278-375). On CUDA kernel K8 (`kernels/fb_splat.py`)
gathers each pixel's terms from the patches sorted by anchor cell, in
float64 and a fixed order; its plain twin `_backward_splat`, which the
CPU runs, builds soft one-hot matrices from the run-time positions (the
two bilinear taps of an axis folded in) and places the patches with two
contractions.

The contractions take float32 values and accumulate in float64, rounded
once. In float32 a product's sum order follows the batch size (one pair
alone takes another matrix-product route), so a pair's dense flow would
depend on the pairs batched with it; in float64 another order moves a sum
by about 2^-53 of its terms' magnitude, which changes the float32 result
only where the sum lies that close to a float32 rounding boundary. So a
batch split gives the same bits in practice, not by construction; K8's
merge gives them by construction (each pixel sums its own pair's terms in
one order). Nothing scatters or uses atomics: two runs give the same
bits. Every pixel is finally normalised by its accumulated weight
(patchgrid.cpp:377-394).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from of_dis_tpu_torch import trace
from of_dis_tpu_torch.kernels import fb_splat
from of_dis_tpu_torch.ops.patch_solver import PatchResult
from of_dis_tpu_torch.params import DISParams, LevelSpec


def _axis_slots(size: int, n_axis: int, off: int, steps: int, psz: int):
    """Static per-coordinate contributor table along one axis: for each
    output coordinate v in [0, size), the (at most K) grid indices whose
    psz-wide footprint covers v, the within-patch offset, and validity.
    K = floor((psz-1)/steps)+1. Returns (idx, offset, valid), each (size, K)."""
    k = (psz - 1) // steps + 1
    v = np.arange(size)
    # patch center c = i*steps + off covers v iff v - c + psz//2 in [0, psz)
    lo = v + psz // 2 - psz + 1 - off            # min center value
    i_min = -((-lo) // steps)                    # ceil division
    slots = i_min[:, None] + np.arange(k)[None, :]
    centers = slots * steps + off
    offset = v[:, None] - centers + psz // 2
    valid = (slots >= 0) & (slots < n_axis) & (offset >= 0) & (offset < psz)
    idx = np.clip(slots, 0, n_axis - 1).astype(np.int32)
    offset = np.clip(offset, 0, psz - 1).astype(np.int32)
    return idx, offset, valid


def _cover_matrix(size: int, n_axis: int, off: int, steps: int, psz: int
                  ) -> np.ndarray:
    """(size, psz*n_axis) static 0/1 matrix: row v has a 1 at column
    offset*n_axis + idx for every grid slot covering coordinate v."""
    idx, offset, valid = _axis_slots(size, n_axis, off, steps, psz)
    m = np.zeros((size, psz * n_axis), np.float32)
    for a in range(idx.shape[1]):
        rows = np.arange(size)[valid[:, a]]
        m[rows, offset[valid[:, a], a] * n_axis + idx[valid[:, a], a]] = 1.0
    return m


@lru_cache(maxsize=128)
def _cover_pair(spec: LevelSpec, psz: int, device: str):
    """The level's two cover matrices as float64 tensors on `device`: the
    (H, psz, noph) vertical one and the transposed (psz*nopw, W)
    horizontal one. Read only; 128 entries hold a call's at two shapes on
    four devices (op-4 with the merge: 11 a shape, both grids' levels but
    the last backward one)."""
    u = _cover_matrix(spec.height, spec.noph, spec.offseth, spec.steps, psz)
    v = _cover_matrix(spec.width, spec.nopw, spec.offsetw, spec.steps, psz)
    u4 = trace.upload(u.reshape(spec.height, psz, spec.noph), device,
                      torch.float64)
    return u4, trace.upload(np.ascontiguousarray(v.T), device, torch.float64)


# Bytes a pair of the backward merge's soft one-hot operands held at once;
# more patches than fit are merged in chunks.
_MERGE_CHUNK_BYTES = 8 << 20


def _merge_chunk(n: int, psz: int, h: int, w: int) -> int:
    """Patches per chunk of the backward merge: a pair's float32 operands
    are the (n, psz, H) row and the two (n, psz, W) column arrays (their
    float64 copies for the products take twice that again). Sized per
    pair, so the chunks, and the order their sums take, do not follow the
    batch size."""
    return max(1, min(n, _MERGE_CHUNK_BYTES // (4 * psz * (h + 2 * w))))


def _backward_splat(spec: LevelSpec, params: DISParams, compl: PatchResult
                    ) -> torch.Tensor:
    """(B, 1 + nop, H, W): the accumulated weight and the weighted negated
    displacements of the complementary grid's patches, each splat
    bilinearly at its converged position (patchgrid.cpp:278-375).

    Per patch: anchor ceil(pt + 1e-5) and residual against floor(pt) in
    float32; footprint pixel (j, i) lands on the cell (anchor + j - psz/2,
    anchor + i - psz/2) and is valid for 1 <= x < W-1, 1 <= y < H-1; its
    weight 1 / pweight goes to that cell and its upper / left neighbours
    by the bilinear weights. Both taps of an axis fold into one soft
    one-hot matrix, so the placement is `rows^T @ (weights @ columns)`.
    The products take float32 operands and accumulate in float64 across
    the chunks, rounded once (see the module docstring); a term is a
    product of three or four float32 factors, so the float64 sums round
    too, and equal bits across batch sizes hold in practice only."""
    psz, nop = params.p_samp_s, params.nop
    h, w = spec.height, spec.width
    dev = compl.p.device
    b, n = compl.p.shape[:2]
    lb = -psz // 2
    ar = torch.arange(psz, device=dev)
    yio = torch.arange(h, device=dev)
    xio = torch.arange(w, device=dev)
    out = torch.zeros((b, 1 + nop, h, w), dtype=torch.float64, device=dev)
    step = _merge_chunk(n, psz, h, w)
    for lo in range(0, n, step):
        pt = compl.pt[:, lo:lo + step]                       # (B, n, 2)
        pos_c = torch.ceil(pt + 1e-5).to(torch.int64)
        resid = pt - torch.floor(pt)
        rx, ry = resid[..., 0, None, None], resid[..., 1, None, None]
        xt = pos_c[..., 0, None] + ar + lb                   # (B, n, P)
        yt = pos_c[..., 1, None] + ar + lb
        xv = ((xt >= 1) & (xt < w - 1)).to(torch.float32)
        yv = ((yt >= 1) & (yt < h - 1)).to(torch.float32)
        # (B, n, j, i) weights of the valid footprint pixels
        wgt = (torch.reciprocal(compl.pweight[..., lo:lo + step])
               .permute(0, 3, 1, 2) * yv[..., :, None] * xv[..., None, :])
        # cell t takes the pixel weighted (1 - r) at t - 1 and r at t
        ycell = (yt - 1)[..., None]
        xcell = (xt - 1)[..., None]
        ysoft = ((yio == ycell).to(torch.float32) * (1.0 - ry)
                 + (yio == ycell + 1).to(torch.float32) * ry)  # (B,n,P,H)
        xsoft = ((xio == xcell).to(torch.float32) * (1.0 - rx)
                 + (xio == xcell + 1).to(torch.float32) * rx)  # (B,n,P,W)
        vrow = torch.matmul(wgt.double(), xsoft.double())      # (B,n,P,W)
        ysoft_t = ysoft.double().reshape(b, -1, h).transpose(1, 2)
        p_neg = -compl.p[:, lo:lo + step].double()             # (B, n, nop)
        for f in range(1 + nop):
            rows = vrow if f == 0 else vrow * p_neg[..., f - 1, None, None]
            out[:, f] += torch.matmul(ysoft_t, rows.reshape(b, -1, w))
    return out.to(torch.float32)


def _dense_sums(spec: LevelSpec, params: DISParams,
                res: PatchResult) -> torch.Tensor:
    """(1 + nop, B, H, W) float32: the accumulated weight and weighted
    parameters of per-patch results with fields p (B, N, nop) and pweight
    (B, P, P, N), before the normalisation (patchgrid.cpp:223-275).

    pweight (P, P, N) with the column-major patch axis N = ix*noph + iy
    reshapes for free to (oy, (ox, ix), iy): the vertical contraction runs
    over (oy, iy) against the (H, psz, noph) cover tensor, the horizontal
    one over (ox, ix) against the (W, psz*nopw) cover matrix."""
    psz, nop = params.p_samp_s, params.nop
    nopw, noph = spec.nopw, spec.noph
    b = res.p.shape[0]
    u4, vt = _cover_pair(spec, psz, str(res.p.device))
    q = torch.reciprocal(res.pweight).reshape(b, psz, psz * nopw, noph)
    p4 = res.p.reshape(b, nopw, noph, nop)
    # the weight and each weighted parameter, (1 + nop, B, oy, (ox,ix), iy)
    fields = torch.stack([q] + [
        q * p4[:, None, :, :, ch].expand(b, psz, nopw, noph)
        .reshape(b, 1, psz * nopw, noph) for ch in range(nop)])
    # -> (1 + nop, B, H, psz*nopw) -> (1 + nop, B, H, W), both contractions
    # in float64 and rounded once (see the module docstring). Each output
    # sums at most ((psz-1)//steps+1)^2 float32 terms, which float64 holds
    # exactly unless their magnitudes lie more than about 2^24 apart.
    return torch.matmul(torch.einsum("hoy,kbozy->kbhz", u4, fields.double()),
                        vt).to(torch.float32)


def _normalise(dense: torch.Tensor,
               back: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense flow (B, H, W, nop) from `_dense_sums`, with a merge's splat
    (B, 1 + nop, H, W) added first where one is given: each pixel's
    weighted parameters over its weight, where that is positive
    (patchgrid.cpp:377-394)."""
    we = dense[0]
    flow = dense[1:].movedim(0, -1)
    if back is not None:
        we = we + back[:, 0]
        flow = flow + back[:, 1:].movedim(1, -1)
    we = we[..., None]
    return torch.where(we > 0, flow / we, flow)


def aggregate_flow_dense(spec: LevelSpec, params: DISParams,
                         res: PatchResult) -> torch.Tensor:
    """Dense flow (B, H, W, nop) from per-patch results with fields
    p (B, N, nop) and pweight (B, P, P, N) (patchgrid.cpp:213-397)."""
    return _normalise(_dense_sums(spec, params, res))


def merge_flows(spec: LevelSpec, params: DISParams, res: PatchResult,
                res_bw: PatchResult, spec_bw: Optional[LevelSpec] = None,
                span: Optional[str] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward-backward merge of a level (patchgrid.cpp:213-397):
    (flow, flow_bw), each (B, H, W, nop). `flow` is the forward grid's
    dense flow with the backward grid's patches (`res_bw`, pt (B, N, 2)
    too) splat into it; where `spec_bw`, the backward grid's level, is
    given, `flow_bw` is the backward grid's with the forward grid's
    patches splat into it, else None. Both grids' sums first, then both
    splats in one K8 launch (`fb_splat.backward_splat`; the CPU runs the
    twin `_backward_splat`), inside the span `span` where one is named."""
    # the splats after both contractions, whose float64 operands are the
    # level's largest
    sums = [_dense_sums(spec, params, res)]
    if spec_bw is not None:
        sums.append(_dense_sums(spec_bw, params, res_bw))
    if span is not None:
        t = trace.begin(span, spec.level)
    back = fb_splat.backward_splat(spec, params, (res_bw, res)[:len(sums)])
    if span is not None:
        trace.end(span, t)
    flow = _normalise(sums[0], back[0])
    flow_bw = _normalise(sums[1], back[1]) if spec_bw is not None else None
    return flow, flow_bw
