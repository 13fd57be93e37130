"""K4: INTER_LINEAR x2^sc_l upscale of the final flow, written
channels-last (csrc/upscale.cu), replacing `_upscale_cf_pallas` of the JAX
package.

Plain twin: `models.dis.upscale_output` (batched)."""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.ops.pyramid import _lerp_matrix

NAME = "upscale"
launches = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_p] * 10 + [_i] * 7 + [_p]


def tap_tables(n_out: int, n_in: int, scale: float = 1.0):
    """Two (index, weight) taps per output row of the INTER_LINEAR matrix
    `_lerp_matrix(n_out, n_in) * scale` (a clamped edge row has one tap;
    its second gets weight 0)."""
    m = _lerp_matrix(n_out, n_in) * scale
    i0 = np.zeros(n_out, np.int32)
    i1 = np.zeros(n_out, np.int32)
    w0 = np.zeros(n_out, np.float32)
    w1 = np.zeros(n_out, np.float32)
    for r in range(n_out):
        nz = np.flatnonzero(m[r])
        i0[r] = i1[r] = nz[0]
        w0[r] = m[r, nz[0]]
        if len(nz) > 1:
            i1[r], w1[r] = nz[1], m[r, nz[1]]
    return i0, i1, w0, w1


def tile_window(i0: np.ndarray, i1: np.ndarray, tile: int) -> int:
    """The most input columns that the taps (i0, i1) of one tile of `tile`
    consecutive output columns span, from the tile's first tap to its last
    (the tables rise monotonically): what a block stages a row."""
    starts = np.arange(0, len(i0), tile)
    ends = np.minimum(starts + tile, len(i0)) - 1
    return int((i1[ends] - i0[starts]).max()) + 1


@lru_cache(maxsize=16)
def _device_tables(n_out: int, n_in: int, scale: float, device: str):
    return tuple(torch.as_tensor(t, device=device)
                 for t in tap_tables(n_out, n_in, scale))


@lru_cache(maxsize=16)
def _window(out_w: int, w: int, tile: int) -> int:
    i0, i1, _, _ = tap_tables(out_w, w)
    return tile_window(i0, i1, tile)


def upscale_batched(flow: torch.Tensor, sc_l: int, out_h: int,
                    out_w: int) -> torch.Tensor:
    """(B, h, w, nop) flow at the finest computed level, nop 1 or 2 ->
    (B, out_h, out_w, nop) full-resolution flow, values times 2^sc_l. CPU
    tensors run the plain twin."""
    global launches
    if flow.device.type == "cpu":
        from of_dis_tpu_torch.models.dis import upscale_output
        return upscale_output(flow, sc_l, out_h, out_w)
    b, h, w, nop = flow.shape
    if nop not in (1, 2):
        raise ValueError(f"{NAME}: nop must be 1 or 2, got {nop}")
    build.check_tensor(NAME, "flow", flow, (b, h, w, nop))
    scale = float(2 ** sc_l)
    ty = _device_tables(out_h, h, scale, str(flow.device))
    tx = _device_tables(out_w, w, 1.0, str(flow.device))
    out = torch.empty((b, out_h, out_w, nop), dtype=torch.float32,
                      device=flow.device)
    # the kernel's tile: kTile floats of a row, kTile / nop pixels
    tile = build.query(flow.device, NAME, "of_upscale_tile_floats") // nop
    p = build.ptr
    build.launch(flow.device, NAME, "of_upscale", _ARGTYPES, p(flow),
                 *(p(t) for t in ty), *(p(t) for t in tx), p(out), b, h, w,
                 out_h, out_w, nop, _window(out_w, w, tile))
    launches += 1
    return out
