"""K8: the forward-backward merge's splat of the complementary grid's
patches as a deterministic gather, one thread an output pixel
(csrc/fb_splat.cu); both merges of a level (into the forward and the
backward flow) in one launch. The JAX package has no kernel for it (XLA
contracts soft one-hot matrices).

Plain twin: `ops.densify._backward_splat` (the soft one-hot contractions
in float64, chunked)."""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from of_dis_tpu_torch.kernels import build

NAME = "fb_splat"

_i, _p = ctypes.c_int, ctypes.c_void_p
_KEYS_ARGTYPES = [_p] * 3 + [_i] * 6 + [_p]
_INDEX_ARGTYPES = [_p] * 9 + [_i] * 7 + [_p]
_SPLAT_ARGTYPES = [_p] * 6 + [_i] * 10 + [_p]


def cells(h: int, w: int, psz: int):
    """(ax0, ay0, cw, ch): the anchors whose footprint can reach a valid
    pixel (1 <= x < w-1, 1 <= y < h-1) of a level h x w, ax in [ax0,
    ax0 + cw), ay in [ay0, ay0 + ch); none where a side is below 3."""
    lb = -psz // 2
    a0 = 2 - lb - psz
    return a0, a0, max(w - 3 + psz, 0), max(h - 3 + psz, 0)


def backward_splat(spec, params, compls: Sequence) -> torch.Tensor:
    """(len(compls), B, 1 + nop, H, W) float32: for each complementary
    grid's `PatchResult` (p (B, N, nop), pt (B, N, 2), pweight (B, P, P,
    N)), the accumulated weight and weighted negated displacements of its
    patches splat bilinearly at their converged positions
    (patchgrid.cpp:278-375). One or two results, one launch of each entry.
    CPU tensors run the plain twin."""
    first = compls[0]
    if first.p.device.type == "cpu":
        from of_dis_tpu_torch.ops.densify import _backward_splat
        return torch.stack([_backward_splat(spec, params, c) for c in compls])
    nd = len(compls)
    if nd not in (1, 2):
        raise ValueError(f"{NAME}: one or two results, got {nd}")
    psz, nop = params.p_samp_s, params.nop
    if nop not in (1, 2):
        raise ValueError(f"{NAME}: nop must be 1 or 2, got {nop}")
    h, w = spec.height, spec.width
    b, n = first.p.shape[:2]
    dev = first.p.device
    out = torch.empty((nd, b, 1 + nop, h, w), dtype=torch.float32,
                      device=dev)
    ax0, ay0, cw, ch = cells(h, w, psz)
    if cw == 0 or ch == 0 or n == 0 or b == 0:
        return out.zero_()
    # positions and displacements in the grid's own (B, c, N) layout
    pts = [c.pt.transpose(1, 2).contiguous() for c in compls]
    ps = [c.p.transpose(1, 2).contiguous() for c in compls]
    pws = [c.pweight.contiguous() for c in compls]
    for k in range(nd):
        build.check_tensor(NAME, "pt", pts[k], (b, 2, n))
        build.check_tensor(NAME, "p", ps[k], (b, nop, n))
        build.check_tensor(NAME, "pweight", pws[k], (b, psz, psz, n))
    p = build.ptr

    def two(ts):
        return p(ts[0]), (p(ts[1]) if nd == 2 else None)

    keys = torch.empty((nd * b, n), dtype=torch.int32, device=dev)
    build.launch(dev, NAME, "of_fb_splat_keys", _KEYS_ARGTYPES, *two(pts),
                 p(keys), b, n, ax0, ay0, cw, ch)
    # each pair's patches in cell order, in patch order within a cell
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    starts = torch.empty((nd * b, cw * ch + 1), dtype=torch.int32,
                         device=dev)
    rec_i = torch.empty((nd * b, n, 4), dtype=torch.int32, device=dev)
    rec_f = torch.empty((nd * b, n, 4), dtype=torch.float32, device=dev)
    build.launch(dev, NAME, "of_fb_splat_index", _INDEX_ARGTYPES,
                 p(sorted_keys), p(order), *two(pts), *two(ps), p(starts),
                 p(rec_i), p(rec_f), b, n, nop, ax0, ay0, cw, ch)
    build.launch(dev, NAME, "of_fb_splat", _SPLAT_ARGTYPES, *two(pws),
                 p(starts), p(rec_i), p(rec_f), p(out), b, n, nop, psz, h, w,
                 ax0, ay0, cw, ch)
    return out
