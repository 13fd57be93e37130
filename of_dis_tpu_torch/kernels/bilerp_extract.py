"""K7: bilinear patch extraction at float positions as one CUDA kernel
(csrc/bilerp_extract.cu), gray or RGB, replacing `_bilerp_select_pallas`
of the JAX package together with the one-hot column product before it.
The unfused Gauss-Newton route (`ops.patch_solver.gn_unfused`) calls it
once at the start of a level and once per trip.

Plain twin: `ops.patch_solver.extract_bilinear`."""

from __future__ import annotations

import ctypes

import torch

from of_dis_tpu_torch.kernels import build

NAME = "bilerp_extract"
launches = 0

_i, _p = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_p] * 3 + [_i] * 7 + [_p]


def bilerp_extract(im: torch.Tensor, pts: torch.Tensor, psz: int,
                   pad: int) -> torch.Tensor:
    """Bilinear patches of `im` (B, C, Hp, Wp) padded level planes at the
    float positions `pts` (B, N, 2), (x, y) in unpadded level coordinates:
    anchor ceil(pt + 1e-5), residual against floor(pt), float32. Returns
    (B, psz^2 C, N), patch pixels in (row, column, channel) order; any
    batch and patch size, one launch. CPU tensors run the plain twin."""
    global launches
    if im.device.type == "cpu":
        from of_dis_tpu_torch.ops.patch_solver import extract_bilinear
        return extract_bilinear(im, pts, psz, pad)
    if im.ndim != 4 or pts.ndim != 3:
        raise ValueError(f"{NAME}: im must be (B, C, Hp, Wp) and pts "
                         f"(B, N, 2), got {tuple(im.shape)} and "
                         f"{tuple(pts.shape)}")
    b, c, hp, wp = im.shape
    n = pts.shape[1]
    if psz < 1:
        raise ValueError(f"{NAME}: patch size {psz} below 1")
    build.check_tensor(NAME, "im", im, (b, c, hp, wp))
    build.check_tensor(NAME, "pts", pts, (b, n, 2))
    out = torch.empty((b, psz * psz * c, n), dtype=torch.float32,
                      device=im.device)
    p = build.ptr
    build.launch(im.device, NAME, "of_bilerp_extract", _ARGTYPES, p(im),
                 p(pts), p(out), b, c, hp, wp, n, psz, pad)
    launches += 1
    return out
