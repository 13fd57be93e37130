"""K3: backward bilinear warp + in-bounds mask on a 3-D grid, one or (on
large calls) four pixels of a row a thread (csrc/warp.cu), replacing
`warp_image_banded_pallas` and `_warp_coeffs_pallas` of the JAX package.
A row origin lets a block of rows of a row-sharded level sample the whole
frame (`parallel.spatial`, the JAX package's `spatial._warp_global`).

Plain twin: `ops.tv.warp_image`."""

from __future__ import annotations

import ctypes

import torch

from of_dis_tpu_torch.kernels import build

NAME = "warp"
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def warp_image_batched(src: torch.Tensor, wx: torch.Tensor,
                       wy: torch.Tensor, row0: int = 0):
    """src (B, C, Hs, W) warped by (wx, wy) (B, H, W), whose row y lies at
    global row row0 + y of src (0 <= row0 <= Hs - H): returns (out
    (B, C, H, W), mask (B, H, W)). CPU tensors run the plain twin."""
    global launches
    b, c, hs, w = src.shape
    h = wx.shape[-2]
    if not 0 <= row0 <= hs - h:
        raise ValueError(f"{NAME}: rows [{row0}, {row0 + h}) are not rows "
                         f"of a source of {hs}")
    if src.device.type == "cpu":
        from of_dis_tpu_torch.ops.tv import warp_image
        return warp_image(src, wx, wy, row0)
    build.check_tensor(NAME, "src", src, (b, c, hs, w))
    build.check_tensor(NAME, "wx", wx, (b, h, w))
    build.check_tensor(NAME, "wy", wy, (b, h, w))
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=src.device)
    mask = torch.empty_like(wx)
    p = build.ptr
    build.launch(src.device, NAME, "of_warp", _ARGTYPES, p(src), p(wx),
                 p(wy), p(out), p(mask), b, c, h, w, row0, hs)
    launches += 1
    return out, mask


def vec_min_pixels(device) -> int:
    """The fewest pixels (B H W) of a call on `device` that the kernel runs
    4 to a thread (with widths a multiple of 4 and aligned fields): two
    full blocks on every SM, from csrc/warp.cu."""
    return build.query(device, NAME, "of_warp_vec_min_pixels")
