"""Image pyramid + gradient construction, OpenCV-numerics-compatible, in PyTorch.

Port of the reference's `ConstructImgPyramide` (run_dense.cpp:131-179):
  - per level: x0.5 downscale with cv::INTER_LINEAR semantics (run_dense.cpp:151)
    which at an exact half scale is the 2x2 box mean,
  - 3x3 Sobel dx/dy scaled by 1/8 with BORDER_DEFAULT = reflect-101
    (run_dense.cpp:157-158),
  - border padding by the patch size: replicate for images, zero for gradients
    (run_dense.cpp:167-173),
and the original divisibility padding (run_dense.cpp:299-311).

Layout: images are (..., C, H, W); every function takes any number of
leading batch dimensions. Resizes are two float32 matrix products against
constant interpolation matrices (the JAX package's bf16 hi/lo split is a
TPU device and is not ported: for u8-sourced levels both are exact).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from of_dis_tpu_torch import trace


def _lerp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, cv::INTER_LINEAR
    convention: half-pixel centers, edge clamp. Exact box mean at integer
    downscale factors (e.g. x0.5 -> rows [.., 0.5, 0.5, ..])."""
    m = np.zeros((n_out, n_in), np.float32)
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x).astype(np.int64)
    f = (x - x0).astype(np.float32)
    i0 = np.clip(x0, 0, n_in - 1)
    i1 = np.clip(x0 + 1, 0, n_in - 1)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - f)
    np.add.at(m, (rows, i1), f)
    return m


def _box_matrix(n_in: int, k: int) -> np.ndarray:
    """(n_in/k, n_in) k-tap box-mean matrix (the product of log2(k)
    successive x0.5 INTER_LINEAR halvings)."""
    n_out = n_in // k
    m = np.zeros((n_out, n_in), np.float32)
    for j in range(k):
        m[np.arange(n_out), np.arange(n_out) * k + j] = 1.0 / k
    return m


def _resize_mm(img: torch.Tensor, out_h: int, out_w: int,
               box: int = 0) -> torch.Tensor:
    """Resize (..., C, H, W) as two constant-matrix float32 products,
    horizontal first (cv::resize's evaluation order). box=k uses the k-tap
    box-mean matrices; box=0 the bilinear cv::INTER_LINEAR matrices."""
    h, w = img.shape[-2], img.shape[-1]
    if box:
        mh, mw = _box_matrix(h, box), _box_matrix(w, box)
    else:
        mh, mw = _lerp_matrix(out_h, h), _lerp_matrix(out_w, w)
    mh = trace.upload(mh, img.device)
    mw = trace.upload(mw, img.device)
    t = torch.matmul(img.to(torch.float32), mw.T)         # (..., H, out_w)
    return torch.matmul(mh, t)                            # (..., out_h, out_w)


def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


def _edge_pad(img: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Replicate-pad the last two axes by index gathers (works for any
    dtype, u8 included)."""
    h, w = img.shape[-2], img.shape[-1]
    rows = _edge_index(h, top, bottom, img.device)
    cols = _edge_index(w, left, right, img.device)
    return img.index_select(-2, rows).index_select(-1, cols)


def pad_to_divisible(img: torch.Tensor, lv_f: int) -> torch.Tensor:
    """Replicate-pad (..., C, H, W) so H and W divide 2^lv_f
    (run_dense.cpp:299-311). Split: floor(pad/2) before, ceil(pad/2) after."""
    h, w = img.shape[-2], img.shape[-1]
    scfct = 2 ** lv_f
    padw = (scfct - w % scfct) % scfct
    padh = (scfct - h % scfct) % scfct
    if padw == 0 and padh == 0:
        return img
    return _edge_pad(img, padh // 2, padh - padh // 2, padw // 2,
                     padw - padw // 2)


def halve(img: torch.Tensor) -> torch.Tensor:
    """x0.5 downscale, cv::INTER_LINEAR-exact for even sizes: 2x2 box mean
    (run_dense.cpp:151)."""
    h, w = img.shape[-2], img.shape[-1]
    x = img[..., : (h // 2) * 2, : (w // 2) * 2]
    return _resize_mm(x, h // 2, w // 2)


def _sep_filter_reflect101(img: torch.Tensor, kh: Tuple[float, float, float],
                           kv: Tuple[float, float, float]) -> torch.Tensor:
    """Separable 3-tap filter with reflect-101 border (cv::BORDER_DEFAULT)
    on (..., C, H, W): kv along H first, then kh along W."""
    shape = img.shape
    p = F.pad(img.reshape(-1, shape[-2], shape[-1]), (1, 1, 1, 1),
              mode="reflect").reshape(shape[:-2] + (shape[-2] + 2,
                                                    shape[-1] + 2))
    v = kv[0] * p[..., :-2, :] + kv[1] * p[..., 1:-1, :] + kv[2] * p[..., 2:, :]
    return (kh[0] * v[..., :, :-2] + kh[1] * v[..., :, 1:-1]
            + kh[2] * v[..., :, 2:])


def sobel_dx(img: torch.Tensor) -> torch.Tensor:
    """cv::Sobel(dx=1, ksize=3, scale=1/8, BORDER_DEFAULT)."""
    return _sep_filter_reflect101(img, (-1.0 / 8.0, 0.0, 1.0 / 8.0),
                                  (1.0, 2.0, 1.0))


def sobel_dy(img: torch.Tensor) -> torch.Tensor:
    """cv::Sobel(dy=1, ksize=3, scale=1/8, BORDER_DEFAULT)."""
    return _sep_filter_reflect101(img, (1.0, 2.0, 1.0),
                                  (-1.0 / 8.0, 0.0, 1.0 / 8.0))


def pad_border(img: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad (..., C, H, W) by `pad` on all sides; mode 'edge' (images) or
    zero (gradients)."""
    if mode == "edge":
        return _edge_pad(img, pad, pad, pad, pad)
    return F.pad(img, (pad, pad, pad, pad))


def build_pyramid(img: torch.Tensor, lv_f: int, pad: int, getgrad: bool = True,
                  lv_l: int = 0
                  ) -> Tuple[List[Optional[torch.Tensor]],
                             List[Optional[torch.Tensor]],
                             List[Optional[torch.Tensor]]]:
    """Padded image + gradient pyramids (run_dense.cpp:131-179).

    `img` is the divisibility-padded full-resolution (..., C, H, W) image
    (u8 or float). Returns (imgs, dxs, dys) lists indexed by level
    0..lv_f, each entry float32 and padded by `pad` on all sides. Levels
    below `lv_l` are None: with lv_l > 0 the first used level comes from
    one 2^lv_l-tap box contraction, skipping the unused finer levels."""
    h, w = img.shape[-2], img.shape[-1]
    k = 2 ** lv_l
    if lv_l > 0 and h % k == 0 and w % k == 0:
        levels = [None] * (lv_l + 1)
        levels[lv_l] = _resize_mm(img, h // k, w // k, box=k)
        for _ in range(lv_f - lv_l):
            levels.append(halve(levels[-1]))
    else:
        levels = [img.to(torch.float32)]
        for _ in range(lv_f):
            levels.append(halve(levels[-1]))
    imgs, dxs, dys = [], [], []
    for lv in range(lv_f + 1):
        if lv < lv_l:
            imgs.append(None)
            dxs.append(None)
            dys.append(None)
            continue
        base = levels[lv]
        imgs.append(pad_border(base, pad, "edge"))
        if getgrad:
            dxs.append(pad_border(sobel_dx(base), pad, "zero"))
            dys.append(pad_border(sobel_dy(base), pad, "zero"))
        else:
            dxs.append(None)
            dys.append(None)
    return imgs, dxs, dys


def gradient_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Gradient-magnitude input mode (run_dense.cpp:139-148,
    SELECTCHANNEL==2): sqrt(sobel_dx^2 + sobel_dy^2) of the raw float
    (..., C, H, W) image."""
    img = img.to(torch.float32)
    dx = sobel_dx(img)
    dy = sobel_dy(img)
    return torch.sqrt(dx * dx + dy * dy)


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv::INTER_LINEAR-compatible resize of a (..., C, H, W) image
    (half-pixel centers, edge clamp; run_dense.cpp:408-412)."""
    return _resize_mm(img, out_h, out_w)
