"""T2: the per-stage ablation of the Gauss-Newton iteration as one CUDA
kernel (csrc/gn_stages.cu), replacing the TPU kernel of
`tools/bench_gn_stages.py` of the JAX package. Its stages run the device
code of the GN kernels in csrc/gn_common.cuh on either kernel's layout:
`LANES` (K1's: one warp a patch, lane l on the pixels l + 32k) or
`COLUMNS` (K6's: 16 lanes a patch, lane i on column i of its window).

Plain twin: `_plain`, which sums in the kernel's order on each layout (per
lane across the trips, then the warp's or the segment's butterfly)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from of_dis_tpu_torch.kernels import build

NAME = "gn_stages"
launches = 0

STAGES = ("W", "A3", "A4")
# variants of A4 in the C entry's numbering (bit 0: the shared-memory
# window, bit 1: 16-bit integer planes); "" is A4 itself
VARIANTS = ("", "B-smem", "C-u16", "both")
U16_VARIANTS = ("C-u16", "both")
# the C entry's layouts: K1's lanes, K6's window columns
LANES, COLUMNS = 0, 1
# lanes a patch on the column layout
SEGMENT = 16
MAX_PSZ = 12

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_p] * 7 + [_i] * 6 + [_f] + [_i] * 3 + [_p]


def residuals(i: int):
    """(rx, ry, 1 - rx, 1 - ry) of trip i, rounded to float32 as the
    kernel computes them: rx = 0.5 - 0.001 i, ry = 0.25 + 0.001 i."""
    f = np.float32
    rx = f(0.5) - f(0.001) * f(i)
    ry = f(0.25) + f(0.001) * f(i)
    return float(rx), float(ry), float(f(1) - rx), float(f(1) - ry)


def _butterfly(x: torch.Tensor) -> torch.Tensor:
    """The xor-butterfly sum of a warp (32 lanes) or a segment (16) over the
    trailing lane axis."""
    w = x.shape[-1]
    while w > 1:
        w //= 2
        x = x[..., :w] + x[..., w:2 * w]
    return x[..., 0]


def _div(x: torch.Tensor, den: int) -> torch.Tensor:
    """x / den rounded as the kernel's division (not a reciprocal)."""
    return torch.div(x, torch.full_like(x, float(den)))


def _plain_lanes(im, tmpl, tdx, tdy, sx0, sy0, psz: int, max_iter: int,
                 stage: str) -> torch.Tensor:
    """Layout `LANES`: lane l holds pixels l + 32k; its sums run over
    (trip, k) in order and the warp's butterfly reduces them once."""
    b, hp, wp = im.shape
    n = sx0.shape[1]
    p_tot = psz * psz
    kk = -(-p_tot // 32)
    dev = im.device
    flat = im.reshape(b, 1, hp * wp)
    d = torch.arange(kk * 32, device=dev)
    valid = (d < p_tot).reshape(kk, 32)
    j, i = d // psz, d % psz
    if stage == "A4":
        def lanes(t):                       # (B, N, D) -> (B, N, K, 32)
            pad = t.new_zeros((b, n, kk * 32 - p_tot))
            return torch.cat([t, pad], -1).reshape(b, n, kk, 32)
        tm, tx, ty = lanes(tmpl), lanes(tdx), lanes(tdy)
    acc = [torch.zeros((b, n, 32), dtype=torch.float32, device=dev)
           for _ in range(3)]
    for it in range(max_iter):
        sx = (sx0 + it)[..., None]
        sy = (sy0 + 3 * (it % 2))[..., None]
        y0 = (sy + j).clamp(0, hp - 1)
        y1 = (sy + j + 1).clamp(0, hp - 1)
        x0 = (sx + i).clamp(0, wp - 1)
        x1 = (sx + i + 1).clamp(0, wp - 1)

        def tap(yy, xx):
            v = torch.gather(flat, 2, (yy * wp + xx).reshape(b, 1, -1))
            v = v.reshape(b, n, kk, 32)
            return torch.where(valid, v, torch.zeros_like(v))

        v00, v01, v10, v11 = tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1)
        if stage == "W":
            for k in range(kk):
                acc[0] = acc[0] + (((v00[:, :, k] + v01[:, :, k])
                                    + v10[:, :, k]) + v11[:, :, k])
            continue
        rx, ry, rx1, ry1 = residuals(it)
        g0 = ry1 * v00 + ry * v10
        g1 = ry1 * v01 + ry * v11
        px = rx * g1 + rx1 * g0
        if stage == "A3":
            for k in range(kk):
                acc[0] = acc[0] + px[:, :, k]
            continue
        s = px[:, :, 0]
        for k in range(1, kk):
            s = s + px[:, :, k]
        mean = _div(_butterfly(s), p_tot)
        pd = (px - mean[..., None, None]) - tm
        for k in range(kk):
            v = valid[k]
            acc[0] = torch.where(v, acc[0] + pd[:, :, k].abs(), acc[0])
            acc[1] = torch.where(v, acc[1] + tx[:, :, k] * pd[:, :, k], acc[1])
            acc[2] = torch.where(v, acc[2] + ty[:, :, k] * pd[:, :, k], acc[2])
    return acc


def _plain_columns(im, tmpl, tdx, tdy, sx0, sy0, psz: int, max_iter: int,
                   stage: str) -> list:
    """Layout `COLUMNS`: lane c of a patch's `SEGMENT` lanes holds column
    c of its (psz+1)^2 window (0 beyond column psz); its sums run over
    (trip, row j) in order and the segment's butterfly reduces them once
    (the order of `ops.patch_solver._column_sum`). W weighs each window
    element by the pixels that read it (1, 2 or 4: exact); the lerp's
    right-hand column is lane c + 1's y-lerp."""
    b, hp, wp = im.shape
    n = sx0.shape[1]
    p_tot, w1 = psz * psz, psz + 1
    dev = im.device
    flat = im.reshape(b, 1, hp * wp)
    c = torch.arange(SEGMENT, device=dev)
    r = torch.arange(w1, device=dev)
    loads = c <= psz                          # lanes with a window column
    valid = c < psz                           # lanes with a patch column
    cc = c.clamp(max=psz)
    if stage == "A4":
        def cols(t):                # (B, N, psz^2) -> (B, N, psz, SEGMENT)
            t = t.reshape(b, n, psz, psz)
            return torch.cat([t, t.new_zeros((b, n, psz, SEGMENT - psz))], -1)
        tm, tx, ty = cols(tmpl), cols(tdx), cols(tdy)
    edge_r = (r == 0) | (r == psz)
    edge_c = (c == 0) | (c == psz)
    wgt = (2.0 - edge_r.float())[:, None] * (2.0 - edge_c.float())[None, :]
    acc = [torch.zeros((b, n, SEGMENT), dtype=torch.float32, device=dev)
           for _ in range(3)]
    for it in range(max_iter):
        sx = (sx0 + it)[..., None, None]
        sy = (sy0 + 3 * (it % 2))[..., None, None]
        yy = (sy + r[:, None]).clamp(0, hp - 1)
        xx = (sx + cc[None, :]).clamp(0, wp - 1)
        win = torch.gather(flat, 2, (yy * wp + xx).reshape(b, 1, -1))
        win = win.reshape(b, n, w1, SEGMENT)
        win = torch.where(loads, win, torch.zeros_like(win))
        if stage == "W":
            for rr in range(w1):
                acc[0] = torch.where(loads, acc[0] + wgt[rr] * win[:, :, rr],
                                     acc[0])
            continue
        rx, ry, rx1, ry1 = residuals(it)
        g = ry1 * win[:, :, :-1] + ry * win[:, :, 1:]
        gr = torch.cat([g[..., 1:], g[..., -1:]], -1)
        px = rx * gr + rx1 * g                # (B, N, psz, SEGMENT)
        if stage == "A3":
            for j in range(psz):
                acc[0] = torch.where(valid, acc[0] + px[:, :, j], acc[0])
            continue
        s = px[:, :, 0]
        for j in range(1, psz):
            s = s + px[:, :, j]
        s = torch.where(valid, s, torch.zeros_like(s))
        mean = _div(_butterfly(s), p_tot)
        pd = (px - mean[..., None, None]) - tm
        for j in range(psz):
            acc[0] = torch.where(valid, acc[0] + pd[:, :, j].abs(), acc[0])
            acc[1] = torch.where(valid, acc[1] + tx[:, :, j] * pd[:, :, j],
                                 acc[1])
            acc[2] = torch.where(valid, acc[2] + ty[:, :, j] * pd[:, :, j],
                                 acc[2])
    return acc


def _plain(planes, tmpl, tdx, tdy, sx0, sy0, psz: int, max_iter: int,
           stage: str, variant: str, scale: float, layout: int
           ) -> torch.Tensor:
    """The twin of one stage on one layout, arguments as `gn_stages`; every
    variant computes A4's function, so `variant` changes nothing here."""
    im = planes if planes.dtype == torch.float32 else planes.float() * scale
    body = _plain_columns if layout == COLUMNS else _plain_lanes
    acc = body(im, tmpl, tdx, tdy, sx0, sy0, psz, max_iter, stage)
    r = _butterfly(acc[0])
    if stage == "A4":
        r = _div(r, psz * psz) + _butterfly(acc[1])
        r = r + _butterfly(acc[2])
    return r


def gn_stages(planes: torch.Tensor, tmpl: torch.Tensor, tdx: torch.Tensor,
              tdy: torch.Tensor, sx0: torch.Tensor, sy0: torch.Tensor,
              psz: int, max_iter: int, stage: str, variant: str,
              scale: float, layout: int) -> torch.Tensor:
    """Per-patch checksum of `max_iter` trips of one stage (`STAGES`) or,
    at stage A4, one variant (`VARIANTS`, "" for A4 itself) on one layout
    (`LANES` or `COLUMNS`): planes (B, Hp, Wp) float32, or uint16 of
    value / scale for the u16 variants (scale 1 otherwise); tmpl, tdx, tdy
    (B, N, psz^2) float32; sx0, sy0 (B, N) int32, the window's top-left
    corner at trip 0. Returns (B, N) float32. CPU tensors run the plain
    twin."""
    global launches
    if stage not in STAGES or variant not in VARIANTS or \
            (variant and stage != "A4"):
        raise ValueError(f"{NAME}: unknown stage {stage!r} / variant "
                         f"{variant!r}")
    want = torch.uint16 if variant in U16_VARIANTS else torch.float32
    if planes.dtype != want:
        raise ValueError(f"{NAME}: variant {variant or 'A4'} takes {want} "
                         f"planes, got {planes.dtype}")
    if not 1 <= psz <= MAX_PSZ:
        raise ValueError(f"{NAME}: patch size {psz} outside 1..{MAX_PSZ}")
    if layout not in (LANES, COLUMNS):
        raise ValueError(f"{NAME}: unknown layout {layout!r}")
    if planes.device.type == "cpu":
        return _plain(planes, tmpl, tdx, tdy, sx0, sy0, psz, max_iter, stage,
                      variant, scale, layout)
    b, hp, wp = planes.shape
    n = sx0.shape[1]
    build.check_tensor(NAME, "planes", planes, (b, hp, wp), want)
    for what, t in (("tmpl", tmpl), ("tdx", tdx), ("tdy", tdy)):
        build.check_tensor(NAME, what, t, (b, n, psz * psz))
    for what, t in (("sx0", sx0), ("sy0", sy0)):
        build.check_tensor(NAME, what, t, (b, n), torch.int32)
    out = torch.empty((b, n), dtype=torch.float32, device=planes.device)
    p = build.ptr
    build.launch(planes.device, NAME, "of_gn_stages", _ARGTYPES, p(planes),
                 p(tmpl), p(tdx), p(tdy), p(sx0), p(sy0), p(out), b, n, hp,
                 wp, psz, max_iter, scale, STAGES.index(stage),
                 VARIANTS.index(variant), layout)
    launches += 1
    return out

