"""Plain PyTorch reference of DIS optical flow, gray frames (nop 2, noc 1),
L2 cost, no forward-backward merge: a frozen copy of the algorithm that
the benchmark holds the port's outputs against. It imports nothing of the
port; every table it needs it builds again from the level geometry.

Per scale, coarse to fine (oflow.cpp:31-338): the image pyramid with its
Sobel gradients (run_dense.cpp:131-179), the patch templates, the start
from the coarser scale's flow (patchgrid.cpp:195-211), the masked
inverse-compositional Gauss-Newton loop (patch.cpp:118-293), the
densification (patchgrid.cpp:213-397) and the variational refinement
(refine_variational.cpp, FDF1.0.1's opticalflow_aux.c and solver.c, as a
red-black SOR); then the INTER_LINEAR upscale (run_dense.cpp:408-412). A
warm start reads the coarsest scale from a carry, the box mean of the
previous flow (run_dense.cpp:373-376).

Sums that decide a patch's trajectory are taken in a fixed order: the
template mean and Hessian in float64; within the GN loop, a small level
(K1's) sums each patch as 32 lanes over its pixels and then a butterfly, a
large level (K6's) per column of the patch and then a butterfly; the
densification's contractions in float64. Every float32 matrix product
runs with TF32 off unless the caller turns it on (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from dis_bench.geometry import LevelSpec, Params, make_level_spec, uses_tiled

MINERRVAL = 2.0
DATANORM = 0.1 * 0.1
EPS = 0.001 * 0.001


def check_supported(params: Params) -> None:
    if (params.nop, params.noc, params.costfct, params.usefbcon) != \
            (2, 1, 0, False):
        raise ValueError("the reference computes gray flow with the L2 cost "
                         "and no merge only")


# ------------------------------------------------------------- pyramid

def _lerp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """cv::INTER_LINEAR weights: half-pixel centres, edge clamp."""
    m = np.zeros((n_out, n_in), np.float32)
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x).astype(np.int64)
    f = (x - x0).astype(np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, np.clip(x0, 0, n_in - 1)), 1.0 - f)
    np.add.at(m, (rows, np.clip(x0 + 1, 0, n_in - 1)), f)
    return m


def _box_matrix(n_in: int, k: int) -> np.ndarray:
    n_out = n_in // k
    m = np.zeros((n_out, n_in), np.float32)
    for j in range(k):
        m[np.arange(n_out), np.arange(n_out) * k + j] = 1.0 / k
    return m


def _resize(img: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """Rows of (..., H, W) through mw, then columns through mh."""
    mh = torch.as_tensor(mh, device=img.device)
    mw = torch.as_tensor(mw, device=img.device)
    return torch.matmul(mh, torch.matmul(img.to(torch.float32), mw.T))


def _edge_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    h, w = img.shape[-2:]
    rows = torch.arange(-pad, h + pad, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=img.device).clamp(0, w - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def _sep3(img: torch.Tensor, kh, kv) -> torch.Tensor:
    """3-tap separable filter, reflect-101 border: kv down, then kh across."""
    s = img.shape
    p = F.pad(img.reshape(-1, s[-2], s[-1]), (1, 1, 1, 1),
              mode="reflect").reshape(s[:-2] + (s[-2] + 2, s[-1] + 2))
    v = kv[0] * p[..., :-2, :] + kv[1] * p[..., 1:-1, :] + kv[2] * p[..., 2:, :]
    return kh[0] * v[..., :-2] + kh[1] * v[..., 1:-1] + kh[2] * v[..., 2:]


def pyramid(img: torch.Tensor, params: Params, grad: bool):
    """{level: (image, dx, dy)} of the scales run, each padded by the patch
    size (replicate for the image, zeros for the gradients). The finest
    scale run comes from the frame in one 2^sc_l box contraction."""
    h, w = img.shape[-2:]
    k = 2 ** params.sc_l
    base = (_resize(img, _box_matrix(h, k), _box_matrix(w, k)) if k > 1
            else img.to(torch.float32))
    pad = params.p_samp_s
    out = {}
    for lv in range(params.sc_l, params.sc_f + 1):
        if lv > params.sc_l:
            hh, ww = base.shape[-2:]
            base = _resize(base, _lerp_matrix(hh // 2, hh),
                           _lerp_matrix(ww // 2, ww))
        dx = dy = None
        if grad:
            dx = F.pad(_sep3(base, (-0.125, 0.0, 0.125), (1.0, 2.0, 1.0)),
                       (pad,) * 4)
            dy = F.pad(_sep3(base, (1.0, 2.0, 1.0), (-0.125, 0.0, 0.125)),
                       (pad,) * 4)
        out[lv] = (_edge_pad(base, pad), dx, dy)
    return out


# ------------------------------------------------------- patch templates

def _grid(spec: LevelSpec, device):
    """(N, 2) float32 reference positions, column-major i = x*noph + y."""
    xs = np.repeat(np.arange(spec.nopw) * spec.steps + spec.offsetw,
                   spec.noph)
    ys = np.tile(np.arange(spec.noph) * spec.steps + spec.offseth, spec.nopw)
    return xs, ys, torch.as_tensor(np.stack([xs, ys], 1), dtype=torch.float32,
                                   device=device)


def _gather(spec: LevelSpec, psz: int, field: torch.Tensor) -> torch.Tensor:
    """(B, 1, Hp, Wp) -> (B, psz*psz, N) integer windows, pixel j-major."""
    lb = -psz // 2
    j = np.arange(psz)[:, None]
    rows = spec.offseth + lb + spec.pad + np.arange(spec.noph)[None] * spec.steps + j
    cols = spec.offsetw + lb + spec.pad + np.arange(spec.nopw)[None] * spec.steps + j
    g = field[:, 0].index_select(1, torch.as_tensor(rows.reshape(-1),
                                                    device=field.device))
    g = g.index_select(2, torch.as_tensor(cols.reshape(-1),
                                          device=field.device))
    g = g.reshape(-1, psz, spec.noph, psz, spec.nopw)
    return g.permute(0, 1, 3, 4, 2).reshape(-1, psz * psz,
                                            spec.nopw * spec.noph)


def _div(t: torch.Tensor, den: float) -> torch.Tensor:
    """A true division (CUDA multiplies by the reciprocal otherwise)."""
    return torch.div(t, torch.full_like(t, den))


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of (B, D, N): 32 lanes, lane l adding pixels
    l, l + 32, ... in turn, then a butterfly."""
    b, d, n = x.shape
    k = -(-d // 32)
    if k * 32 != d:
        x = torch.cat([x, x.new_zeros((b, k * 32 - d, n))], 1)
    x = x.reshape(b, k, 32, n)
    s = x[:, 0]
    for j in range(1, k):
        s = s + x[:, j]
    w = 32
    while w > 1:
        w //= 2
        s = s[:, :w] + s[:, w:2 * w]
    return s[:, 0]


def _column_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of (B, psz*psz, N): lane i adds column i's pixels
    row by row, lanes up to the next power of two above psz hold 0, then a
    butterfly."""
    b, d, n = x.shape
    psz = math.isqrt(d)
    seg = 2
    while seg <= psz:
        seg *= 2
    x = x.reshape(b, psz, psz, n)
    s = x[:, 0]
    for j in range(1, psz):
        s = s + x[:, j]
    s = torch.cat([s, s.new_zeros((b, seg - psz, n))], 1)
    while seg > 1:
        seg //= 2
        s = s[:, :seg] + s[:, seg:2 * seg]
    return s[:, 0]


def _hessian(h00, h01, h11):
    """[H00, H01, H11] with the reference's det == 0 guard (patch.cpp:
    69-86), the determinant as one fused multiply-add."""
    guard = (h00 * h11.double() == h01 * h01).to(h00.dtype) * 1e-10
    return torch.stack([h00 + guard, h01, h11 + guard], 1)


def templates(spec: LevelSpec, params: Params, src, tiled: bool):
    """(tmpl, tdx, tdy, hes) of a level: the integer windows of the source
    image and its gradients, the template less its mean, the 2x2 Hessian."""
    psz = params.p_samp_s
    tmpl, tdx, tdy = (_gather(spec, psz, f) for f in src)
    if tiled:
        tmpl = tmpl - _div(_column_sum(tmpl), float(tmpl.shape[1]))[:, None]
        hes = _hessian(_column_sum(tdx * tdx), _column_sum(tdx * tdy),
                       _column_sum(tdy * tdy))
    else:
        tmpl = tmpl - tmpl.mean(1, keepdim=True,
                                dtype=torch.float64).to(torch.float32)
        sums = torch.sum(torch.stack([tdx * tdx, tdx * tdy, tdy * tdy], 1),
                         2, dtype=torch.float64).to(torch.float32)
        hes = _hessian(sums[:, 0], sums[:, 1], sums[:, 2])
    return tmpl, tdx, tdy, hes


# ---------------------------------------------------------- Gauss-Newton

def _fms(a, b, c, d) -> torch.Tensor:
    """a * b - c * d of float32 tensors rounded once, as fma(a, b, -(c*d)):
    the exact a * b in float64, less c * d, rounded to odd, then to
    float32."""
    s = a.double() * b
    p = c * d
    r = s - p
    t = r - s
    err = (s - (r - t)) - (p + t)
    toward = torch.nextafter(r, r + torch.sign(err) * r.abs())
    return torch.where((r.view(torch.int64) & 1) == 1, r, toward).float()


def extract(im: torch.Tensor, pts: torch.Tensor, psz: int,
            pad: int) -> torch.Tensor:
    """Bilinear patches (B, psz*psz, N) of im (B, 1, Hp, Wp) at float
    positions pts (B, N, 2): anchor ceil(pt + 1e-5), weights from
    floor(pt) (patch.cpp:346-413); y first, then x."""
    b, _, hp, wp = im.shape
    n = pts.shape[1]
    pos = torch.ceil(pts + 1e-5).to(torch.int64)
    res = pts - torch.floor(pts)
    rx = res[:, :, 0][:, None, None, :]
    ry = res[:, :, 1][:, None, None, :]
    off = torch.arange(psz + 1, device=im.device)
    ys = ((pos[:, :, 1] - psz // 2 - 1 + pad)[:, None, :]
          + off[None, :, None]).clamp(0, hp - 1)
    xs = ((pos[:, :, 0] - psz // 2 - 1 + pad)[:, None, :]
          + off[None, :, None]).clamp(0, wp - 1)
    idx = ys[:, :, None, :] * wp + xs[:, None, :, :]
    win = torch.gather(im.reshape(b, hp * wp), 1,
                       idx.reshape(b, -1)).reshape(b, psz + 1, psz + 1, n)
    gy = (1.0 - ry) * win[:, :-1] + ry * win[:, 1:]
    px = rx * gy[:, :, 1:] + (1.0 - rx) * gy[:, :, :-1]
    return px.reshape(b, psz * psz, n)


def gauss_newton(spec: LevelSpec, params: Params, im_b: torch.Tensor, tpl,
                 p_init: torch.Tensor, tiled: bool):
    """The masked GN loop over every patch: p_init (B, 2, N) -> (p (B, 2,
    N), the densify weight denominators (B, psz*psz, N)). A small level
    carries each patch's weights from its last active trip; a large level
    takes them from one extraction at the final position."""
    psz, pad = params.p_samp_s, spec.pad
    psum = _column_sum if tiled else _lane_sum
    tmpl, tdx, tdy, hes = tpl
    _, _, ref = _grid(spec, im_b.device)
    ref = ref.T[None]
    b, n = im_b.shape[0], tmpl.shape[-1]

    def oob(pt):
        return ((pt[:, 0] < spec.tmp_lb) | (pt[:, 1] < spec.tmp_lb)
                | (pt[:, 0] > spec.tmp_ubw) | (pt[:, 1] > spec.tmp_ubh))

    def error(pt):
        patch = extract(im_b, pt.transpose(1, 2).contiguous(), psz, pad)
        if params.patnorm > 0:
            patch = patch - _div(psum(patch), float(patch.shape[1]))[:, None]
        diff = patch - tmpl
        return diff, diff.abs(), _div(psum(diff.abs()), float(params.novals))

    pt0 = ref + p_init
    init_oob = oob(pt0)
    m = init_oob[:, None, :]
    pdiff, pw_raw, mares = error(torch.where(m, ref, pt0))
    tmpl_pw = tmpl.abs().clamp(min=MINERRVAL)
    pdiff = torch.where(m, tmpl, pdiff)
    pweight = torch.where(m, tmpl_pw, pw_raw.clamp(min=MINERRVAL))
    active = (~init_oob) & (params.max_iter > 0) & (mares > params.res_thresh)
    p = p_init
    dpn = torch.full((b, n), 1e-10, dtype=torch.float32, device=im_b.device)
    it = 0
    while it < params.max_iter and bool(active.any()):
        act = active
        it += 1
        r0, r1 = psum(tdx * pdiff)[:, None], psum(tdy * pdiff)[:, None]
        h00, h01, h11 = hes[:, 0:1], hes[:, 1:2], hes[:, 2:3]
        v = _fms(torch.cat([h00, h11, h00], 1), torch.cat([h11, r0, r1], 1),
                 h01, torch.cat([h01, r1, r0], 1))
        dp = v[:, 1:] / v[:, :1]
        p_new = p - dp
        pt_new = ref + p_new
        moved = torch.sqrt(torch.sum((pt_new - pt0) ** 2, 1))
        reset = (moved > params.outlierthresh) | oob(pt_new)
        p_new = torch.where(reset[:, None], p_init, p_new)
        pdiff_new, pw_raw, mares_new = error(ref + p_new)
        dp_sq = torch.sum(dp * dp, 1)
        dpn_new = dp_sq if it == 1 else dpn
        gate = it < params.min_iter
        keep = ((it < params.max_iter) & (mares_new > params.res_thresh)
                & (gate | (dp_sq / dpn_new >= params.dp_thresh_sq))
                & (gate | (mares_new / mares <= params.dr_thresh)))
        a3 = act[:, None]
        p = torch.where(a3, p_new, p)
        pdiff = torch.where(a3, pdiff_new, pdiff)
        if not tiled:
            pweight = torch.where(a3, pw_raw.clamp(min=MINERRVAL), pweight)
        mares = torch.where(act, mares_new, mares)
        dpn = torch.where(act, dpn_new, dpn)
        active = act & keep & (~reset)
    if tiled:
        pt_fin = torch.where(m, ref, ref + p)
        pweight = torch.where(m, tmpl_pw,
                              error(pt_fin)[1].clamp(min=MINERRVAL))
    return p, pweight


# --------------------------------------------------------- densification

def _cover(size: int, n_axis: int, off: int, steps: int,
           psz: int) -> np.ndarray:
    """(size, psz*n_axis) 0/1: row v has a 1 at offset*n_axis + i for every
    patch i whose footprint covers coordinate v."""
    k = (psz - 1) // steps + 1
    v = np.arange(size)
    lo = v + psz // 2 - psz + 1 - off
    slots = (-((-lo) // steps))[:, None] + np.arange(k)[None]
    offset = v[:, None] - (slots * steps + off) + psz // 2
    valid = (slots >= 0) & (slots < n_axis) & (offset >= 0) & (offset < psz)
    m = np.zeros((size, psz * n_axis), np.float32)
    for a in range(k):
        r = valid[:, a]
        m[v[r], offset[r, a] * n_axis + slots[r, a]] = 1.0
    return m


def densify(spec: LevelSpec, params: Params, p: torch.Tensor,
            pweight: torch.Tensor) -> torch.Tensor:
    """Dense flow (B, H, W, 2): each patch's displacement over its
    footprint, weighted per pixel by 1 / pweight, summed in float64,
    normalised by the summed weight."""
    psz = params.p_samp_s
    b = p.shape[0]
    dev = p.device
    u = torch.as_tensor(_cover(spec.height, spec.noph, spec.offseth,
                               spec.steps, psz).reshape(spec.height, psz,
                                                        spec.noph),
                        dtype=torch.float64, device=dev)
    vt = torch.as_tensor(np.ascontiguousarray(
        _cover(spec.width, spec.nopw, spec.offsetw, spec.steps, psz).T),
        dtype=torch.float64, device=dev)
    q = torch.reciprocal(pweight).reshape(b, psz, psz * spec.nopw, spec.noph)
    p4 = p.reshape(b, 2, spec.nopw, spec.noph)
    fields = torch.stack([q] + [
        q * p4[:, None, ch].expand(b, psz, spec.nopw, spec.noph)
        .reshape(b, 1, psz * spec.nopw, spec.noph) for ch in range(2)])
    dense = torch.matmul(torch.einsum("hoy,kbozy->kbhz", u, fields.double()),
                         vt).to(torch.float32)
    we = dense[0][..., None]
    flow = dense[1:].movedim(0, -1)
    return torch.where(we > 0, flow / we, flow)


# ------------------------------------------------ variational refinement

def _nbr(x: torch.Tensor, axis: int, k: int, zero: bool = True):
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device) + k
    y = x.index_select(axis, idx.clamp(0, n - 1))
    if not zero:
        return y
    shape = [1] * x.ndim
    shape[axis] = n
    return torch.where(((idx >= 0) & (idx < n)).reshape(shape), y,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _d5(x, axis):
    return ((_nbr(x, axis, -2, False) - 8.0 * _nbr(x, axis, -1, False)
             + 8.0 * _nbr(x, axis, 1, False) - _nbr(x, axis, 2, False))
            * (1.0 / 12.0))


def _d3(x, axis):
    return 0.5 * (_nbr(x, axis, 1, False) - _nbr(x, axis, -1, False))


def _sdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    return torch.div(torch.full_like(t, num), t)


def warp(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """Bilinear backward warp of (B, H, W) by (wx, wy), clamped samples,
    and the in-bounds mask (opticalflow_aux.c:33-75)."""
    h, w = src.shape[-2:]
    xx = torch.arange(w, dtype=torch.float32, device=src.device)[None] + wx
    yy = torch.arange(h, dtype=torch.float32,
                      device=src.device)[:, None] + wy
    mask = ((xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)).float()
    x0, y0 = torch.floor(xx), torch.floor(yy)
    dx, dy = xx - x0, yy - y0
    x0i = x0.clamp(-1, w).long()
    y0i = y0.clamp(-1, h).long()
    flat = src.reshape(src.shape[0], h * w)

    def take(iy, ix):
        return torch.gather(flat, 1, (iy.clamp(0, h - 1) * w
                                      + ix.clamp(0, w - 1)).reshape(
                                          src.shape[0], -1)).reshape(src.shape)

    out = (take(y0i, x0i) * (1 - dx) * (1 - dy)
           + take(y0i, x0i + 1) * dx * (1 - dy)
           + take(y0i + 1, x0i) * (1 - dx) * dy
           + take(y0i + 1, x0i + 1) * dx * dy)
    return out, mask


def _smoothness(uu, vv, quarter_alpha):
    ux, uy, vx, vy = _d3(uu, -1), _d3(uu, -2), _d3(vv, -1), _d3(vv, -2)
    s = _sdiv(quarter_alpha, torch.sqrt(EPS + ux * ux + uy * uy
                                        + vx * vx + vy * vy))
    horiz = s + _nbr(s, -1, 1)
    horiz[..., :, -1] = 0.0
    vert = s + _nbr(s, -2, 1)
    vert[..., -1, :] = 0.0
    return horiz, vert


def _sub_laplacian(b, src, wh, wv):
    th = wh * (_nbr(src, -1, 1) - src)
    b = b + th - _nbr(th, -1, -1)
    tv = wv * (_nbr(src, -2, 1) - src)
    return b + tv - _nbr(tv, -2, -1)


def _data(mask, du, dv, d, hd3, hg3):
    """The gray data term with the x3 scaling (opticalflow_aux.c:408-594)."""
    ix, iy, iz, ixx, ixy, iyy, ixz, iyz = d
    t2 = iz + ix * du + iy * dv
    n1 = DATANORM + ix * ix + iy * iy
    t = mask * hd3 / torch.sqrt(EPS + 3.0 * (t2 * t2 / n1))
    t3 = t / n1
    tx, ty = t3 * ix, t3 * iy
    zero = torch.zeros_like(mask)
    a11, a12, a22 = zero + tx * ix, zero + tx * iy, zero + ty * iy
    b1, b2 = zero - tx * iz, zero - ty * iz
    t2 = ixz + ixx * du + ixy * dv
    t3 = iyz + ixy * du + iyy * dv
    xy2 = ixy * ixy
    n1 = xy2 + DATANORM + ixx * ixx
    n2 = xy2 + DATANORM + iyy * iyy
    t = mask * hg3 / torch.sqrt(EPS + 3.0 * (t2 * t2 / n1 + t3 * t3 / n2))
    tn2, tn1 = t / n2, t / n1
    a12 = a12 + (tn1 * ixx + tn2 * iyy) * ixy
    b1 = b1 - tn1 * ixx * ixz - tn2 * ixy * iyz
    b2 = b2 - tn2 * iyy * iyz - tn1 * ixy * ixz
    a11 = a11 + tn1 * ixx * ixx + tn2 * xy2
    a22 = a22 + tn2 * iyy * iyy + tn1 * xy2
    return 3.0 * a11, 3.0 * a12, 3.0 * a22, 3.0 * b1, 3.0 * b2


def _sor(du, dv, a11, a12, a22, b1, b2, wh, wv, iterations, omega):
    """Coupled 2x2 SOR, red-black with row parity: du, then dv from the
    fresh du (solver.c:34-78)."""
    h, w = du.shape[-2:]
    red = ((torch.arange(h, device=du.device)[:, None]
            + torch.arange(w, device=du.device)[None]) % 2) == 0
    up_w, left_w = _nbr(wv, -2, -1), _nbr(wh, -1, -1)
    wsum = up_w + left_w + wv + wh
    om11, om22 = _sdiv(omega, a11 + wsum), _sdiv(omega, a22 + wsum)

    def nsum(x):
        return (up_w * _nbr(x, -2, -1) + left_w * _nbr(x, -1, -1)
                + wv * _nbr(x, -2, 1) + wh * _nbr(x, -1, 1))

    for _ in range(iterations):
        for mask in (red, ~red):
            b1n, b2n = b1 + nsum(du), b2 + nsum(dv)
            du = torch.where(mask, (1.0 - omega) * du
                             + om11 * (b1n - a12 * dv), du)
            dv = torch.where(mask, (1.0 - omega) * dv
                             + om22 * (b2n - a12 * du), dv)
    return du, dv


def refine(flow: torch.Tensor, im1: torch.Tensor, im2: torch.Tensor,
           level: int, params: Params) -> torch.Tensor:
    """One scale's variational refinement of flow (B, H, W, 2) on the
    unpadded images (B, H, W) (refine_variational.cpp:25-247)."""
    wx, wy = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    quarter_alpha = 0.25 * params.tv_alpha
    hd3, hg3 = params.tv_delta * 0.5 / 3.0, params.tv_gamma * 0.5 / 3.0
    w_im2, mask = warp(im2, wx, wy)
    tmp = 0.5 * (im1 + w_im2)
    iz = w_im2 - im1
    ix, iy = _d5(tmp, -1), _d5(tmp, -2)
    d = (ix, iy, iz, _d5(ix, -1), _d5(ix, -2), _d5(iy, -2), _d5(iz, -1),
         _d5(iz, -2))
    du, dv = torch.zeros_like(wx), torch.zeros_like(wx)
    uu, vv = wx, wy
    for _ in range(params.tv_innerit * (level + 1)):
        wh, wv = _smoothness(uu, vv, quarter_alpha)
        a11, a12, a22, b1, b2 = _data(mask, du, dv, d, hd3, hg3)
        b1 = _sub_laplacian(b1, wx, wh, wv)
        b2 = _sub_laplacian(b2, wy, wh, wv)
        du, dv = _sor(du, dv, a11, a12, a22, b1, b2, wh, wv,
                      params.tv_solverit, params.tv_sor)
        uu, vv = wx + du, wy + dv
    return torch.stack([uu, vv], -1)


# ----------------------------------------------------------- the whole

def upscale(flow: torch.Tensor, sc_l: int, out_h: int,
            out_w: int) -> torch.Tensor:
    """(B, h, w, 2) -> (B, out_h, out_w, 2): values times 2^sc_l, then
    the INTER_LINEAR resize."""
    if sc_l == 0:
        return flow
    f = (flow * float(2 ** sc_l)).movedim(-1, -3)
    h, w = f.shape[-2:]
    return _resize(f, _lerp_matrix(out_h, h),
                   _lerp_matrix(out_w, w)).movedim(-3, -1)


def carry_of(flow_full: torch.Tensor, sc_f: int,
             acc: torch.dtype = torch.float64) -> torch.Tensor:
    """The warm start of the next pair from a full-resolution flow
    (B, H, W, 2): values over k = 2^(sc_f+1), then the k x k box mean,
    summed in `acc` (float64: exact for these sums, so one rounding)."""
    k = 2 ** (sc_f + 1)
    b, h, w, c = flow_full.shape
    f = flow_full[:, : (h // k) * k, : (w // k) * k] * (1.0 / k)
    f = f.reshape(b, h // k, k, w // k, k, c)
    return (f.sum(dim=(2, 4), dtype=acc) / (k * k)).float()


def flow(im_a: torch.Tensor, im_b: torch.Tensor, params: Params,
         carry: torch.Tensor = None) -> torch.Tensor:
    """Full-resolution flow (B, H, W, 2) of u8 gray pairs (B, 1, H, W),
    padded to multiples of 2^sc_f; `carry` (B, H/2^(sc_f+1),
    W/2^(sc_f+1), 2) warm-starts the coarsest scale."""
    check_supported(params)
    full_h, full_w = im_a.shape[-2:]
    pyr_a = pyramid(im_a, params, grad=True)
    pyr_b = pyramid(im_b, params, grad=False)
    prev = carry
    for sl in params.levels:
        spec = make_level_spec(sl, full_w, full_h, params)
        xs, ys, _ = _grid(spec, im_a.device)
        if prev is None:
            p_init = torch.zeros((im_a.shape[0], 2, spec.nopatches),
                                 dtype=torch.float32, device=im_a.device)
        else:
            p_init = (prev[:, torch.as_tensor(ys // 2, device=prev.device),
                           torch.as_tensor(xs // 2, device=prev.device)]
                      * 2.0).transpose(1, 2).contiguous()
        tiled = uses_tiled(spec)
        tpl = templates(spec, params, pyr_a[sl], tiled)
        p, pweight = gauss_newton(spec, params, pyr_b[sl][0], tpl, p_init,
                                  tiled)
        prev = densify(spec, params, p, pweight)
        if params.usetvref:
            pad = spec.pad
            prev = refine(prev, pyr_a[sl][0][:, 0, pad:-pad, pad:-pad],
                          pyr_b[sl][0][:, 0, pad:-pad, pad:-pad], sl, params)
    return upscale(prev, params.sc_l, full_h, full_w)
