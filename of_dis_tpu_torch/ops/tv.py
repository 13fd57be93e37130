"""TV (DeepFlow-style) variational refinement of optical flow and of stereo
disparity, gray or RGB, in PyTorch.

Port of the JAX package's tv.py (the reference's refine_variational.{h,cpp}
+ FDF1.0.1 opticalflow_aux.c / solver.c):

  - bilinear backward warp + in-bounds mask (opticalflow_aux.c:33-75),
  - 5-tap derivative convolutions [1,-8,0,8,-1]/12 with replicate borders
    (refine_variational.cpp:45-48, image.cpp:578-624),
  - TV diffusivity / smoothness edge weights (opticalflow_aux.c:138-187),
  - robust data terms assembling the per-pixel system: 2x2 for flow
    (opticalflow_aux.c:408-594), one unknown for depth
    (opticalflow_aux.c:601-747), each gray or RGB,
  - sub_laplacian residual update (opticalflow_aux.c:194-223),
  - coupled SOR as a red-black (checkerboard) sweep with row parity: du
    first, then dv from the fresh du; the depth solver has du alone.
    Red-black replaces the reference's raster sweep exactly as in the JAX
    package (the golden budget depends on the order).

Fields are (..., H, W) with any leading batch axes; images (..., C, H, W).
On CUDA tensors the warp is kernel K3 (`kernels.warp`) and the fixed-point
loop kernel K2 (`kernels.tv_of_inner`, flow) or K5 (`kernels.tv_de_inner`,
depth), batched or for one pair; the functions here are their plain twins
and the CPU path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from of_dis_tpu_torch.kernels import tv_de_inner, tv_of_inner
from of_dis_tpu_torch.kernels.warp import warp_image_batched

DATANORM = 0.1 * 0.1          # opticalflow_aux.c:25
EPS_COLOR = 0.001 * 0.001
EPS_GRAD = 0.001 * 0.001
EPS_SMOOTH = 0.001 * 0.001


# ---------------------------------------------------------------- warping

def warp_image(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
               row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear backward warp with clamped sampling + in-bounds mask
    (image_warp, opticalflow_aux.c:33-75). src (..., C, Hs, W); wx/wy
    (..., H, W), whose row y lies at global row row0 + y of src (a block
    of a row-sharded level, the JAX package's spatial._warp_global; the
    whole frame at row0 = 0, H = Hs). Returns (out (..., C, H, W), mask
    (..., H, W))."""
    hs, w = src.shape[-2], src.shape[-1]
    h = wx.shape[-2]
    gy = torch.arange(row0, row0 + h, dtype=torch.float32,
                      device=src.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=src.device)[None, :]
    xx = gx + wx
    yy = gy + wy
    mask = ((xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= hs - 1)
            ).to(torch.float32)
    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    dx = (xx - x0)[..., None, :, :]
    dy = (yy - y0)[..., None, :, :]
    x0i = x0.clamp(-1, w).to(torch.int64)
    y0i = y0.clamp(-1, hs).to(torch.int64)
    x1 = x0i.clamp(0, w - 1)
    x2 = (x0i + 1).clamp(0, w - 1)
    y1 = y0i.clamp(0, hs - 1)
    y2 = (y0i + 1).clamp(0, hs - 1)
    flat = src.reshape(src.shape[:-2] + (hs * w,))
    out_shape = src.shape[:-2] + (h, w)

    def take(iy, ix):
        idx = (iy * w + ix).reshape(iy.shape[:-2] + (1, h * w))
        idx = idx.expand(flat.shape[:-1] + (h * w,))
        return torch.gather(flat, -1, idx).reshape(out_shape)

    v11 = take(y1, x1)
    v12 = take(y1, x2)
    v21 = take(y2, x1)
    v22 = take(y2, x2)
    out = (v11 * (1 - dx) * (1 - dy) + v12 * dx * (1 - dy)
           + v21 * (1 - dx) * dy + v22 * dx * dy)
    return out, mask


def _sdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t as a true division (Python's `float / Tensor` is a
    reciprocal times num, which rounds differently)."""
    return torch.div(torch.full_like(t, num), t)


# ----------------------------------------------------- derivative filters

def _nbr(x: torch.Tensor, axis: int, k: int, zero: bool = True
         ) -> torch.Tensor:
    """out[i] = x[i+k] along `axis`; out-of-range reads give 0 (zero=True)
    or the clamped edge value (zero=False)."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device) + k
    y = x.index_select(axis, idx.clamp(0, n - 1))
    if not zero:
        return y
    valid = (idx >= 0) & (idx < n)
    shape = [1] * x.ndim
    shape[axis] = n
    return torch.where(valid.reshape(shape), y, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def _d5(x: torch.Tensor, axis: int) -> torch.Tensor:
    """5-tap derivative [1,-8,0,8,-1]/12 along `axis`, replicate border
    (refine_variational.cpp:45-46, image.cpp:578-624)."""
    return ((_nbr(x, axis, -2, zero=False) - 8.0 * _nbr(x, axis, -1, zero=False)
             + 8.0 * _nbr(x, axis, 1, zero=False)
             - _nbr(x, axis, 2, zero=False)) * (1.0 / 12.0))


def _d3(x: torch.Tensor, axis: int) -> torch.Tensor:
    """3-tap central difference [-0.5,0,0.5], replicate border
    (refine_variational.cpp:47-48)."""
    return 0.5 * (_nbr(x, axis, 1, zero=False) - _nbr(x, axis, -1, zero=False))


def get_derivatives(im1: torch.Tensor, w_im2: torch.Tensor):
    """Spatio-temporal derivatives on the mean of im1 and the warped im2
    (get_derivatives, opticalflow_aux.c:78-132). Inputs (..., C, H, W).
    Returns (Ix, Iy, Iz, Ixx, Ixy, Iyy, Ixz, Iyz), each (..., C, H, W)."""
    tmp = 0.5 * (im1 + w_im2)
    iz = w_im2 - im1
    ix = _d5(tmp, -1)
    iy = _d5(tmp, -2)
    ixx = _d5(ix, -1)
    ixy = _d5(ix, -2)
    iyy = _d5(iy, -2)
    ixz = _d5(iz, -1)
    iyz = _d5(iz, -2)
    return ix, iy, iz, ixx, ixy, iyy, ixz, iyz


# ----------------------------------------------------------- smoothness

def compute_smoothness(uu: torch.Tensor, vv: torch.Tensor,
                       quarter_alpha: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TV diffusivity -> horizontal/vertical edge weights
    (compute_smoothness, opticalflow_aux.c:138-187). uu/vv (..., H, W).
    horiz[j,i] couples (j,i)<->(j,i+1), last column zero; vert[j,i]
    couples (j,i)<->(j+1,i), last row zero."""
    ux = _d3(uu, -1)
    uy = _d3(uu, -2)
    vx = _d3(vv, -1)
    vy = _d3(vv, -2)
    s = _sdiv(quarter_alpha, torch.sqrt(EPS_SMOOTH + ux * ux + uy * uy
                                        + vx * vx + vy * vy))
    horiz = s + _nbr(s, -1, 1)
    horiz[..., :, -1] = 0.0
    vert = s + _nbr(s, -2, 1)
    vert[..., -1, :] = 0.0
    return horiz, vert


def sub_laplacian(b: torch.Tensor, src: torch.Tensor, wh: torch.Tensor,
                  wv: torch.Tensor) -> torch.Tensor:
    """b += div(w * grad(src)) flux update (sub_laplacian,
    opticalflow_aux.c:194-223). wh/wv carry zeroed last col/row."""
    th = wh * (_nbr(src, -1, 1) - src)
    b = b + th - _nbr(th, -1, -1)
    tv = wv * (_nbr(src, -2, 1) - src)
    b = b + tv - _nbr(tv, -2, -1)
    return b


# ------------------------------------------------------------ data term

def compute_data_gray(mask, du, dv, I, half_delta_over3, half_gamma_over3):
    """Robust data term, single channel (compute_data, opticalflow_aux.c:
    408-594, SELECTCHANNEL==1 path, with the x3 system scaling of lines
    572-578). I = (ix, iy, iz, ixx, ixy, iyy, ixz, iyz), each with a
    leading channel axis of size 1. Returns (a11, a12, a22, b1, b2)."""
    ix, iy, iz, ixx, ixy, iyy, ixz, iyz = [c[0] for c in I]
    zero = torch.zeros_like(mask)
    a11 = zero
    a12 = zero
    a22 = zero
    b1 = zero
    b2 = zero
    if half_delta_over3:  # color constancy
        t2 = iz + ix * du + iy * dv
        n1 = DATANORM + ix * ix + iy * iy
        tsum = t2 * t2 / n1
        t = mask * half_delta_over3 / torch.sqrt(EPS_COLOR + 3.0 * tsum)
        t3 = t / n1
        tx = t3 * ix
        ty = t3 * iy
        a11 = a11 + tx * ix
        a12 = a12 + tx * iy
        a22 = a22 + ty * iy
        b1 = b1 - tx * iz
        b2 = b2 - ty * iz
    # gradient constancy
    t2 = ixz + ixx * du + ixy * dv
    t3 = iyz + ixy * du + iyy * dv
    xy2 = ixy * ixy
    n1 = xy2 + DATANORM + ixx * ixx
    n2 = xy2 + DATANORM + iyy * iyy
    tsum = t2 * t2 / n1 + t3 * t3 / n2
    t = mask * half_gamma_over3 / torch.sqrt(EPS_GRAD + 3.0 * tsum)
    tn2 = t / n2
    tn1 = t / n1
    a12 = a12 + (tn1 * ixx + tn2 * iyy) * ixy
    b1 = b1 - tn1 * ixx * ixz - tn2 * ixy * iyz
    b2 = b2 - tn2 * iyy * iyz - tn1 * ixy * ixz
    a11 = a11 + tn1 * ixx * ixx + tn2 * xy2
    a22 = a22 + tn2 * iyy * iyy + tn1 * xy2
    return 3.0 * a11, 3.0 * a12, 3.0 * a22, 3.0 * b1, 3.0 * b2


def compute_data_rgb(mask, du, dv, I, half_delta_over3, half_gamma_over3):
    """Robust data term, RGB (compute_data, opticalflow_aux.c:408-594,
    SELECTCHANNEL==3 path; no x3 scaling). I entries (3, ..., H, W). Two
    upstream quirks are kept, as the run_OF_RGB binary has them:
      1. channel 0's colour term uses Iy of channel 1
         (opticalflow_aux.c:496),
      2. the gradient term's robust weight comes from channel 2's residuals
         alone (opticalflow_aux.c:529, 538)."""
    ix, iy, iz, ixx, ixy, iyy, ixz, iyz = I
    zero = torch.zeros_like(mask)
    a11 = zero
    a12 = zero
    a22 = zero
    b1 = zero
    b2 = zero
    if half_delta_over3:
        n = [DATANORM + ix[c] * ix[c] + iy[c] * iy[c] for c in range(3)]
        tsum = zero
        for c in range(3):
            t2 = iz[c] + ix[c] * du + iy[c] * dv
            tsum = tsum + t2 * t2 / n[c]
        t = mask * half_delta_over3 / torch.sqrt(EPS_COLOR + tsum)
        for c, iy_used in ((2, iy[2]), (1, iy[1]), (0, iy[1])):  # quirk 1
            t3 = t / n[c]
            tx = t3 * ix[c]
            ty = t3 * iy_used
            a11 = a11 + tx * ix[c]
            a12 = a12 + tx * iy_used
            a22 = a22 + ty * iy_used
            b1 = b1 - tx * iz[c]
            b2 = b2 - ty * iz[c]
    nx = [ixy[c] * ixy[c] + DATANORM + ixx[c] * ixx[c] for c in range(3)]
    ny = [ixy[c] * ixy[c] + DATANORM + iyy[c] * iyy[c] for c in range(3)]
    t2 = ixz[2] + ixx[2] * du + ixy[2] * dv                      # quirk 2
    t3 = iyz[2] + ixy[2] * du + iyy[2] * dv
    tsum = t2 * t2 / nx[2] + t3 * t3 / ny[2]
    t = mask * half_gamma_over3 / torch.sqrt(EPS_GRAD + tsum)
    for c in (2, 1, 0):
        tn2 = t / ny[c]
        tn1 = t / nx[c]
        a12 = a12 + (tn1 * ixx[c] + tn2 * iyy[c]) * ixy[c]
        b1 = b1 - tn1 * ixx[c] * ixz[c] - tn2 * ixy[c] * iyz[c]
        b2 = b2 - tn2 * iyy[c] * iyz[c] - tn1 * ixy[c] * ixz[c]
        a11 = a11 + tn1 * ixx[c] * ixx[c] + tn2 * ixy[c] * ixy[c]
        a22 = a22 + tn2 * iyy[c] * iyy[c] + tn1 * ixy[c] * ixy[c]
    return a11, a12, a22, b1, b2


def compute_data_de_gray(mask, du, I, half_delta_over3, half_gamma_over3):
    """Depth data term (one unknown), single channel (compute_data_DE,
    opticalflow_aux.c:601-747, SELECTCHANNEL==1 path with the x3 scaling).
    Returns (a11, b1)."""
    ix, iy, iz, ixx, ixy, iyy, ixz, iyz = [c[0] for c in I]
    zero = torch.zeros_like(mask)
    a11 = zero
    b1 = zero
    if half_delta_over3:
        t2 = iz + ix * du
        n1 = DATANORM + iy * iy + ix * ix
        tsum = t2 * t2 / n1
        t = mask * half_delta_over3 / torch.sqrt(EPS_COLOR + 3.0 * tsum)
        tx = (t / n1) * ix
        a11 = a11 + tx * ix
        b1 = b1 - tx * iz
    xy2 = ixy * ixy + DATANORM
    n1 = xy2 + ixx * ixx
    n2 = xy2 + iyy * iyy
    t2y = iyz + ixy * du
    t2x = ixz + ixx * du
    tsum = t2y * t2y / n2 + t2x * t2x / n1
    t = mask * half_gamma_over3 / torch.sqrt(EPS_GRAD + 3.0 * tsum)
    t2 = (t / n2) * ixy
    t3 = (t / n1) * ixx
    a11 = a11 + t3 * ixx + t2 * ixy
    b1 = b1 - t3 * ixz - t2 * iyz
    return 3.0 * a11, 3.0 * b1


def compute_data_de_rgb(mask, du, I, half_delta_over3, half_gamma_over3):
    """Depth data term, RGB (compute_data_DE, opticalflow_aux.c:601-747,
    SELECTCHANNEL==3 path): no x3 scaling, and both robust weights
    accumulate all three channels (unlike the flow variant)."""
    ix, iy, iz, ixx, ixy, iyy, ixz, iyz = I
    zero = torch.zeros_like(mask)
    a11 = zero
    b1 = zero
    if half_delta_over3:
        n = [DATANORM + iy[c] * iy[c] + ix[c] * ix[c] for c in range(3)]
        tsum = zero
        for c in range(3):
            t2 = iz[c] + ix[c] * du
            tsum = tsum + t2 * t2 / n[c]
        t = mask * half_delta_over3 / torch.sqrt(EPS_COLOR + tsum)
        for c in (2, 1, 0):
            tx = (t / n[c]) * ix[c]
            a11 = a11 + tx * ix[c]
            b1 = b1 - tx * iz[c]
    nx = [ixy[c] * ixy[c] + DATANORM + ixx[c] * ixx[c] for c in range(3)]
    ny = [ixy[c] * ixy[c] + DATANORM + iyy[c] * iyy[c] for c in range(3)]
    tsum = zero
    for c in range(3):
        t2y = iyz[c] + ixy[c] * du
        t2x = ixz[c] + ixx[c] * du
        tsum = tsum + t2y * t2y / ny[c] + t2x * t2x / nx[c]
    t = mask * half_gamma_over3 / torch.sqrt(EPS_GRAD + tsum)
    for c in (2, 1, 0):
        t2 = (t / ny[c]) * ixy[c]
        t3 = (t / nx[c]) * ixx[c]
        a11 = a11 + t3 * ixx[c] + t2 * ixy[c]
        b1 = b1 - t3 * ixz[c] - t2 * iyz[c]
    return a11, b1


# ------------------------------------------------------------------- SOR

def _weight_shifts(wh: torch.Tensor, wv: torch.Tensor):
    """Iteration-invariant neighbour weights (up_w, left_w, wsum)
    (the dpsis sums of solver.c:42-64)."""
    up_w = _nbr(wv, -2, -1)
    left_w = _nbr(wh, -1, -1)
    wsum = up_w + left_w + wv + wh
    return up_w, left_w, wsum


def _neighbor_sum(x, wh, wv, up_w, left_w):
    """Sum of weighted 4-neighbourhood values (sigma of solver.c:42-64)."""
    return (up_w * _nbr(x, -2, -1) + left_w * _nbr(x, -1, -1)
            + wv * _nbr(x, -2, 1) + wh * _nbr(x, -1, 1))


def _red_mask(du: torch.Tensor, row_parity: int) -> torch.Tensor:
    """(H, W) checkerboard: True where (y + x + row_parity) is even."""
    h, w = du.shape[-2], du.shape[-1]
    ii = (torch.arange(h, device=du.device)[:, None]
          + torch.arange(w, device=du.device)[None, :])
    return (ii + row_parity) % 2 == 0


def sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv, iterations: int,
                   omega: float, row_parity: int = 0):
    """Coupled 2x2 SOR on the 5-point stencil, red-black ordering
    (sor_coupled_slow_but_readable, solver.c:34-78, per pixel: du then dv
    from the fresh du). row_parity offsets the checkerboard's colour for a
    block that starts at an odd global row."""
    red = _red_mask(du, row_parity)
    up_w, left_w, wsum = _weight_shifts(wh, wv)
    om_a11 = _sdiv(omega, a11 + wsum)
    om_a22 = _sdiv(omega, a22 + wsum)

    def one_color(du, dv, mask):
        b1n = b1 + _neighbor_sum(du, wh, wv, up_w, left_w)
        b2n = b2 + _neighbor_sum(dv, wh, wv, up_w, left_w)
        du_new = (1.0 - omega) * du + om_a11 * (b1n - a12 * dv)
        du = torch.where(mask, du_new, du)
        dv_new = (1.0 - omega) * dv + om_a22 * (b2n - a12 * du)
        dv = torch.where(mask, dv_new, dv)
        return du, dv

    for _ in range(iterations):
        du, dv = one_color(du, dv, red)
        du, dv = one_color(du, dv, ~red)
    return du, dv


def sor_de_rb(du, a11, b1, wh, wv, iterations: int, omega: float,
              row_parity: int = 0):
    """Depth SOR, one unknown (sor_coupled_slow_but_readable_DE,
    solver.c:439-471), red-black ordering; row_parity as in
    sor_coupled_rb."""
    red = _red_mask(du, row_parity)
    up_w, left_w, wsum = _weight_shifts(wh, wv)
    om_a11 = _sdiv(omega, a11 + wsum)
    for _ in range(iterations):
        for mask in (red, ~red):
            b1n = b1 + _neighbor_sum(du, wh, wv, up_w, left_w)
            du = torch.where(mask, (1.0 - omega) * du + om_a11 * b1n, du)
    return du


# ------------------------------------------------------------ level glue

def _of_inner_loop(wx, wy, mask, I, *, noc, quarter_alpha, hd3, hg3,
                   n_inner, n_solver, omega, row_parity=0):
    """The per-level fixed-point iteration of RefLevelOF
    (refine_variational.cpp:182-224): the plain twin of kernel K2. All
    fields (..., H, W); I entries (C, ..., H, W)."""
    data = compute_data_gray if noc == 1 else compute_data_rgb
    du = torch.zeros_like(wx)
    dv = torch.zeros_like(wx)
    uu, vv = wx, wy
    for _ in range(n_inner):
        wh, wv = compute_smoothness(uu, vv, quarter_alpha)
        a11, a12, a22, b1, b2 = data(mask, du, dv, I, hd3, hg3)
        b1 = sub_laplacian(b1, wx, wh, wv)
        b2 = sub_laplacian(b2, wy, wh, wv)
        du, dv = sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv,
                                n_solver, omega, row_parity)
        uu, vv = wx + du, wy + dv
    return uu, vv


def _de_inner_loop(wx, mask, I, *, noc, camlr, quarter_alpha, hd3, hg3,
                   n_inner, n_solver, omega, row_parity=0):
    """The per-level fixed-point iteration of RefLevelDE
    (refine_variational.cpp:251-342): the plain twin of kernel K5. The
    disparity uu = wx + du is clamped to the camera's sign after every
    inner iteration (<= 0 for camlr 0, >= 0 for camlr 1); du itself is
    not. Fields (..., H, W); I entries (C, ..., H, W)."""
    data = compute_data_de_gray if noc == 1 else compute_data_de_rgb
    wy0 = torch.zeros_like(wx)
    du = torch.zeros_like(wx)
    uu = wx
    for _ in range(n_inner):
        wh, wv = compute_smoothness(uu, wy0, quarter_alpha)
        a11, b1 = data(mask, du, I, hd3, hg3)
        b1 = sub_laplacian(b1, wx, wh, wv)
        du = sor_de_rb(du, a11, b1, wh, wv, n_solver, omega, row_parity)
        uu = wx + du
        uu = uu.clamp(max=0.0) if camlr == 0 else uu.clamp(min=0.0)
    return uu


def tv_coefficients(alpha: float, gamma: float, delta: float):
    """(quarter_alpha, hd3, hg3) of RefLevelOF's weights
    (refine_variational.cpp:40-43)."""
    return 0.25 * alpha, delta * 0.5 / 3.0, gamma * 0.5 / 3.0


def _warp_and_derivatives(wx, wy, im1, im2):
    """Warp im2 (K3), then the derivative stack (B, 8, C, H, W) in the
    order ix, iy, iz, ixx, ixy, iyy, ixz, iyz, and the in-bounds mask."""
    w_im2, mask = warp_image_batched(im2, wx, wy)
    deriv = torch.stack(get_derivatives(im1, w_im2), dim=1)
    return mask, deriv


def ref_level_of_batched(wx, wy, im1, im2, *, alpha, gamma, delta, n_inner,
                         n_solver, omega):
    """Batched flow refinement of one level: wx/wy (B, H, W), im1/im2
    (B, C, H, W) unpadded level images, C 1 or 3. Returns (uu, vv)
    (B, H, W). Warp (K3) and fixed-point loop (K2) run as kernels on CUDA
    tensors."""
    quarter_alpha, hd3, hg3 = tv_coefficients(alpha, gamma, delta)
    mask, deriv = _warp_and_derivatives(wx, wy, im1, im2)
    return tv_of_inner.of_inner(
        wx, wy, mask, deriv, quarter_alpha=quarter_alpha, hd3=hd3, hg3=hg3,
        n_inner=n_inner, n_solver=n_solver, omega=omega)


def ref_level_de_batched(wx, im1, im2, *, alpha, gamma, delta, n_inner,
                         n_solver, omega, camlr: int):
    """Batched depth refinement of one level: wx (B, H, W) disparity,
    im1/im2 (B, C, H, W). Returns uu (B, H, W). Warp (K3, wy = 0) and
    fixed-point loop (K5) run as kernels on CUDA tensors."""
    quarter_alpha, hd3, hg3 = tv_coefficients(alpha, gamma, delta)
    mask, deriv = _warp_and_derivatives(wx, torch.zeros_like(wx), im1, im2)
    return tv_de_inner.de_inner(
        wx, mask, deriv, camlr=camlr, quarter_alpha=quarter_alpha, hd3=hd3,
        hg3=hg3, n_inner=n_inner, n_solver=n_solver, omega=omega)


def ref_level_of(wx, wy, im1, im2, *, alpha, gamma, delta, n_inner,
                 n_solver, omega):
    """One pair's flow refinement of one level (RefLevelOF,
    refine_variational.cpp:152-247): wx/wy (H, W), im1/im2 (C, H, W)
    de-padded. Returns (uu, vv) (H, W). On CUDA tensors the loop is the
    single-pair launch of kernel K2 (the batched kernel at B = 1)."""
    quarter_alpha, hd3, hg3 = tv_coefficients(alpha, gamma, delta)
    mask, deriv = _warp_and_derivatives(wx[None], wy[None], im1[None],
                                        im2[None])
    return tv_of_inner.of_inner_single(
        wx, wy, mask[0], deriv[0], quarter_alpha=quarter_alpha, hd3=hd3,
        hg3=hg3, n_inner=n_inner, n_solver=n_solver, omega=omega)


def ref_level_de(wx, im1, im2, *, alpha, gamma, delta, n_inner, n_solver,
                 omega, camlr: int):
    """One pair's depth refinement of one level (RefLevelDE,
    refine_variational.cpp:250-342): wx (H, W), im1/im2 (C, H, W). Returns
    uu (H, W). On CUDA tensors the loop is the single-pair launch of
    kernel K5."""
    quarter_alpha, hd3, hg3 = tv_coefficients(alpha, gamma, delta)
    mask, deriv = _warp_and_derivatives(wx[None], torch.zeros_like(wx)[None],
                                        im1[None], im2[None])
    return tv_de_inner.de_inner_single(
        wx, mask[0], deriv[0], camlr=camlr, quarter_alpha=quarter_alpha,
        hd3=hd3, hg3=hg3, n_inner=n_inner, n_solver=n_solver, omega=omega)
