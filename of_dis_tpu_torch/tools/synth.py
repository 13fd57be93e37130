"""The synthetic workload of the port's measurement tools and of
`chip_smoke.py`: u8 frame pairs and videos made on the card (or any
device) from a seed.

A pair is a blurred random frame (a numpy draw of `seed`, 7-tap Gaussian,
sigma 2) and the same frame backward-warped by a smooth subpixel field,
both rounded to u8, as real 8-bit video is quantised after the motion.
Flow pairs move by `flow_field` (an affine ramp plus sinusoids, mean
~(2.5, 1.0) px, +-~1.5 px across the frame: patches keep crossing pixel
cells, as in real footage); stereo pairs shift horizontally only, by
`disparity_field` (-3 -+ 1.6 px, the left camera's disparity being <= 0).

This is the JAX package's bench workload (`bench.py`: `_flow_field`,
`_blur`, `_warp_pairs`, `_make_pairs`). `flow_field` is the same function
as `bench.py::_flow_field`. The frames are not bit-equal to its frames:
the draw here is float32 (`rng.random(dtype=np.float32)`, there a float64
draw cast to float32), the remap clamps at the border (there
`cv2.BORDER_REFLECT`), and its stereo pairs shift by -|u| of the flow
field where these shift by `disparity_field`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def flow_field(h, w, device):
    """Smooth subpixel motion (px): affine ramp plus sinusoids, mean
    ~(2.5, 1.0), +-~1.5 px across the frame."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    u = (2.5 + 0.8 * torch.sin(2 * math.pi * yy / 180.0)
         + 0.5 * torch.cos(2 * math.pi * xx / 260.0) + 0.4 * (xx / w - 0.5))
    v = (1.0 + 0.7 * torch.sin(2 * math.pi * xx / 210.0)
         + 0.4 * (yy / h - 0.5)).expand(h, w)
    return u.expand(h, w), v


def disparity_field(h, w, device):
    """Smooth horizontal-only stereo shift (px), negative everywhere (the
    left camera's disparity): -3 -+ 1.6, no vertical component."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    d = -(3.0 + 1.0 * torch.sin(2 * math.pi * yy / 180.0)
          + 0.6 * torch.cos(2 * math.pi * xx / 260.0))
    return d.expand(h, w), torch.zeros((h, w), device=device)


def blur7(x):
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


def remap(img, mx, my):
    """Bilinear backward warp of (B, C, H, W) at (mx, my), edge clamp."""
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


def to_u8(x):
    return x.round().clamp(0, 255).to(torch.uint8)


def base_frames(batch, channels, h, w, seed, device):
    """Blurred random frames (B, channels, h, w) in [0, 255], from a
    numpy draw of `seed` (the first b frames of a draw of B > b are the
    draw of b)."""
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.random((batch, channels, h, w),
                                      dtype=np.float32),
                           device=device) * 255.0
    return blur7(base)


def make_pairs(batch, h, w, seed, device, channels=1, field=flow_field):
    """u8 frame pairs (B, channels, h, w), each channel an independent
    blurred random frame, and the true field (u, v) that moves the first
    frame of a pair onto the second."""
    base = base_frames(batch, channels, h, w, seed, device)
    u, v = field(h, w, device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    shifted = remap(base, xx - u, yy - v)
    return to_u8(base), to_u8(shifted), u, v


def make_sequence(streams, frames, h, w, seed, device, scale=1):
    """u8 videos (T, S, 1, h, w): frame t of stream s is the blurred random
    frame s (that of `make_pairs`' pair s) backward-warped by t * scale
    times the flow field, so each pair of consecutive frames moves by
    about scale * (u, v); returns the videos and (u, v)."""
    base = base_frames(streams, 1, h, w, seed, device)
    u, v = flow_field(h, w, device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    out = [base] + [remap(base, xx - t * scale * u, yy - t * scale * v)
                    for t in range(1, frames)]
    return to_u8(torch.stack(out)), u, v
