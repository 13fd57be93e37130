"""The benchmark's traffic generator: u8 gray frame pairs and videos made
on the card from a seed, read by every traffic mix of `traffic/*.json`.

A frame is a blurred random frame (7-tap Gaussian, sigma 2, reflect-101
borders); its partner is the same frame backward-warped by a smooth
subpixel field (an affine ramp plus sinusoids, mean ~(2.5, 1.0) px,
+-~1.5 px across the frame, so patches keep crossing pixel cells), both
rounded to u8, as real 8-bit video is quantised after the motion. Frame t
of a video is its first frame warped by t times the field. Frames are
replicate-padded (floor / ceil split) to the size the program takes.

A frozen copy of the port's `tools/synth.py` (`flow_field`, `blur7`,
`remap`, `make_pairs`, `make_sequence`), except that the random draw is a
`torch.Generator` on the frames' device, in one call, where the port's is
a numpy draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def flow_field(h: int, w: int, device):
    """(u, v) (h, w) in px: the smooth subpixel motion."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    u = (2.5 + 0.8 * torch.sin(2 * math.pi * yy / 180.0)
         + 0.5 * torch.cos(2 * math.pi * xx / 260.0) + 0.4 * (xx / w - 0.5))
    v = (1.0 + 0.7 * torch.sin(2 * math.pi * xx / 210.0)
         + 0.4 * (yy / h - 0.5)).expand(h, w)
    return u.expand(h, w), v


def blur7(x: torch.Tensor) -> torch.Tensor:
    """7-tap Gaussian blur, sigma 2, reflect-101 borders, on (..., H, W)."""
    t = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-t * t / 8.0)
    k /= k.sum()
    for dim in (-1, -2):
        n = x.shape[dim]
        idx = torch.arange(-3, n + 3, device=x.device).abs()
        idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        p = x.index_select(dim, idx)
        x = sum(float(k[j]) * p.narrow(dim, j, n) for j in range(7))
    return x


def remap(img: torch.Tensor, mx: torch.Tensor,
          my: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp of (B, 1, H, W) at (mx, my), edge clamp."""
    b, c, h, w = img.shape
    x0 = mx.floor().long().clamp(0, w - 1)
    y0 = my.floor().long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = (mx - x0).clamp(0.0, 1.0)
    fy = (my - y0).clamp(0.0, 1.0)
    flat = img.reshape(b * c, h * w)

    def g(yy, xx):
        return flat[:, (yy * w + xx).reshape(-1)].reshape(b, c, h, w)

    return ((1 - fy) * ((1 - fx) * g(y0, x0) + fx * g(y0, x1))
            + fy * ((1 - fx) * g(y1, x0) + fx * g(y1, x1)))


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return x.round().clamp(0, 255).to(torch.uint8)


def pad_to(img: torch.Tensor, full_h: int, full_w: int) -> torch.Tensor:
    """Replicate-pad (..., H, W) to (full_h, full_w), floor(pad / 2)
    before and the rest after (run_dense.cpp:299-311)."""
    h, w = img.shape[-2:]
    top, left = (full_h - h) // 2, (full_w - w) // 2
    rows = torch.arange(-top, full_h - top, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-left, full_w - left,
                        device=img.device).clamp(0, w - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def base_frames(n: int, h: int, w: int, g: torch.Generator,
                device) -> torch.Tensor:
    """n blurred random gray frames (n, 1, h, w) in [0, 255]."""
    x = torch.rand((n, 1, h, w), generator=g, device=device,
                   dtype=torch.float32)
    return blur7(x * 255.0)


def make_pairs(n: int, h: int, w: int, g: torch.Generator, device,
               full_h: int, full_w: int):
    """n u8 gray pairs (n, 1, full_h, full_w), the second the first moved
    by the field."""
    base = base_frames(n, h, w, g, device)
    u, v = flow_field(h, w, device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    moved = to_u8(remap(base, xx - u, yy - v))
    return (pad_to(to_u8(base), full_h, full_w),
            pad_to(moved, full_h, full_w))


def make_videos(streams: int, frames: int, h: int, w: int,
                g: torch.Generator, device, full_h: int,
                full_w: int) -> torch.Tensor:
    """u8 gray videos (frames, streams, 1, full_h, full_w): frame t of a
    stream is its first frame moved by t times the field."""
    base = base_frames(streams, h, w, g, device)
    u, v = flow_field(h, w, device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    out = torch.empty((frames, streams, 1, full_h, full_w),
                      dtype=torch.uint8, device=device)
    for t in range(frames):
        f = base if t == 0 else remap(base, xx - t * u, yy - t * v)
        out[t] = pad_to(to_u8(f), full_h, full_w)
    return out
