"""Flow visualization: the standard Middlebury color wheel, and a PNG
writer on zlib alone.

Usage:
  python -m of_dis_tpu_torch.utils.viz flow.flo out.png [max_flow]

Not part of the reference's surface (its verbosity-3/4 OpenCV
visualizations are commented out, oflow.cpp:301-329); the inspection tool
of the JAX package's `utils/viz.py`, in numpy, with the PNG written here
(no OpenCV or PIL).
"""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np


def _color_wheel() -> np.ndarray:
    """The 55-entry Middlebury color wheel (RY/YG/GC/CB/BM/MR ramps)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    cols = []
    for n, (c0, c1) in zip(
            (ry, yg, gc, cb, bm, mr),
            (((255, 0, 0), (255, 255, 0)), ((255, 255, 0), (0, 255, 0)),
             ((0, 255, 0), (0, 255, 255)), ((0, 255, 255), (0, 0, 255)),
             ((0, 0, 255), (255, 0, 255)), ((255, 0, 255), (255, 0, 0)))):
        for i in range(n):
            t = i / n
            cols.append([c0[k] + t * (c1[k] - c0[k]) for k in range(3)])
    return np.asarray(cols, np.float32)          # (55, 3) RGB


def flow_to_color(flow: np.ndarray, max_flow: float | None = None
                  ) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 RGB, Middlebury convention."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    rad = np.hypot(u, v)
    if max_flow is None:
        max_flow = max(float(rad.max()), 1e-9)
    u = u / max_flow
    v = v / max_flow
    rad = np.hypot(u, v)
    wheel = _color_wheel()
    ncols = wheel.shape[0]
    angle = np.arctan2(-v, -u) / np.pi            # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (ncols - 1)        # wheel coordinate
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        small = rad <= 1
        col = np.where(small, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255.0 * col).astype(np.uint8)
    return img


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_rows(img: np.ndarray) -> bytes:
    """The filtered scanlines of an 8-bit gray (H, W) or RGB (H, W, 3)
    image, row y under filter type y % 5 (None, Sub, Up, Average, Paeth:
    every filter in every image of five rows or more). Each filter is
    taken against the unfiltered neighbours, so all rows are computed at
    once."""
    h = img.shape[0]
    nch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, nch:] = x[:, :-nch]                       # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                                 # up
    c = np.zeros_like(x)
    c[1:, nch:] = x[:-1, :-nch]                    # up-left
    preds = (0, a, b, (a + b) >> 1, _paeth(a, b, c))
    kind = np.arange(h) % 5
    out = np.empty((h, x.shape[1] + 1), np.uint8)
    out[:, 0] = kind
    for k, pred in enumerate(preds):
        rows = kind == k
        pk = pred if np.isscalar(pred) else pred[rows]
        out[rows, 1:] = ((x[rows] - pk) & 0xFF).astype(np.uint8)
    return out.tobytes()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an 8-bit gray (H, W) or RGB (H, W, 3) uint8 image as a PNG
    (rows filtered as `png_rows` says, deflated by zlib at its default
    level)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(png_rows(img)))
                + _chunk(b"IEND", b""))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from of_dis_tpu_torch.utils import io as uio
    flow = uio.read_flo(argv[0])
    max_flow = float(argv[2]) if len(argv) > 2 else None
    write_png(argv[1], flow_to_color(flow[..., :2], max_flow))
    return 0


if __name__ == "__main__":
    sys.exit(main())
