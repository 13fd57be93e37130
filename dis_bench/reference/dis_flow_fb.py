"""Plain PyTorch reference of DIS optical flow, gray frames (nop 2, noc 1),
L2 cost, WITH the forward-backward merge (`usefbcon`): the frozen
functions of `dis_flow.py` (pyramid, templates, Gauss-Newton, the forward
densification's cover contractions, the variational refinement, the
upscale), imported and not copied, and the merge written here on its own.
It imports nothing of the port.

Per scale, coarse to fine (oflow.cpp:31-338, patchgrid.cpp:213-397): a
second patch grid runs from the second frame to the first (its templates
from the second frame and its gradients, the first frame its target),
started from zero at the coarsest scale and from its own coarser flow
below it. Each grid's dense flow is its own densification plus the other
grid's patches splat at their converged positions with the NEGATED
displacement; the backward grid's flow is made, and refined with the
frames' roles swapped, at every scale but the last (oflow.cpp:266, :286).

The merge (patchgrid.cpp:278-375) as a direct scatter: every footprint
pixel (j, i) of a patch, anchored at ceil(pt + 1e-5) with residual
r = pt - floor(pt) (float32), lies at (anchor + lb + j, anchor + lb + i),
lb = floor(-psz / 2), and counts inside 1 <= x < W-1, 1 <= y < H-1; it
adds t = w * ty * tx (float64, left to right; w = 1 / pweight in
float32, ty and tx the bilinear weights of its tap, (1 - r) at t - 1 and
r at t on each axis) to the weight plane at each of its four taps, and
t * -p to each flow plane. A pixel sums its terms in float64 from zero,
one at a time, in one stated order, rounded to float32 once: patches by
anchor cell (row, then column), in patch order within a cell, then
footprint row and column. Then the weight and flow sums are added to the
forward densification's and the flow normalised by the weight.
"""

from __future__ import annotations

import torch

from dis_bench.geometry import Params, make_level_spec, uses_tiled
from dis_bench.reference import dis_flow as base

# the ones the benchmark's loops and control read beside `flow`
carry_of = base.carry_of
upscale = base.upscale


def check_supported(params: Params) -> None:
    if (params.nop, params.noc, params.costfct, params.usefbcon) != \
            (2, 1, 0, True):
        raise ValueError("this reference computes gray flow with the L2 "
                         "cost and the forward-backward merge only")


def dense_sums(spec, params: Params, p: torch.Tensor,
               pweight: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) float32: the forward densification's weight and
    weighted flow sums before the normalisation, contracted as
    `dis_flow.densify` contracts them."""
    psz = params.p_samp_s
    b = p.shape[0]
    dev = p.device
    u = torch.as_tensor(base._cover(spec.height, spec.noph, spec.offseth,
                                    spec.steps, psz).reshape(spec.height, psz,
                                                             spec.noph),
                        dtype=torch.float64, device=dev)
    vt = torch.as_tensor(base._cover(spec.width, spec.nopw, spec.offsetw,
                                     spec.steps, psz).T.copy(),
                         dtype=torch.float64, device=dev)
    q = torch.reciprocal(pweight).reshape(b, psz, psz * spec.nopw, spec.noph)
    p4 = p.reshape(b, 2, spec.nopw, spec.noph)
    fields = torch.stack([q] + [
        q * p4[:, None, ch].expand(b, psz, spec.nopw, spec.noph)
        .reshape(b, 1, psz * spec.nopw, spec.noph) for ch in range(2)])
    dense = torch.matmul(torch.einsum("hoy,kbozy->kbhz", u, fields.double()),
                         vt).to(torch.float32)
    return dense.transpose(0, 1)


def splat(spec, params: Params, p: torch.Tensor, pt: torch.Tensor,
          pweight: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) float32: the weight and the weighted negated flow of
    one grid's patches (p, pt (B, 2, N), pweight (B, psz, psz, N)) splat
    at their converged positions, pair by pair and plane by plane."""
    psz = params.p_samp_s
    h, w = spec.height, spec.width
    b = p.shape[0]
    dev = p.device
    lb = -psz // 2
    anchor = torch.ceil(pt + 1e-5).to(torch.int64)            # (B, 2, N)
    r = pt - torch.floor(pt)
    inv = torch.reciprocal(pweight)                            # (B, P, P, N)
    vals = torch.cat([torch.ones_like(p[:, :1]), -p], 1).double()
    # the order of the sums: patches by anchor cell, row by row, in patch
    # order within a cell; then each patch's footprint rows and columns
    key = (anchor[:, 1] + psz) * (w + 2 * psz) + anchor[:, 0] + psz
    order = torch.sort(key, dim=1, stable=True).indices        # (B, N)
    off = torch.arange(psz, device=dev)
    tap = torch.arange(2, device=dev)
    out = torch.zeros((b, 3, h * w), dtype=torch.float64, device=dev)
    for k in range(b):
        o = order[k]
        ax, ay = anchor[k, 0, o], anchor[k, 1, o]               # (N,)
        x = ax[:, None] + lb + off                             # (N, P)
        y = ay[:, None] + lb + off
        ok = (((y >= 1) & (y < h - 1))[:, :, None]
              & ((x >= 1) & (x < w - 1))[:, None, :])          # (N, j, i)
        # tap (dy, dx) of footprint pixel (j, i): the cell
        # (y_j - 1 + dy, x_i - 1 + dx), weights (1 - r, r)[dy] on y and
        # (1 - r, r)[dx] on x
        wy = torch.stack([1.0 - r[k, 1, o], r[k, 1, o]], 1).double()
        wx = torch.stack([1.0 - r[k, 0, o], r[k, 0, o]], 1).double()
        t = (inv[k][:, :, o].permute(2, 0, 1).double()[..., None, None]
             * wy[:, None, None, :, None]
             * wx[:, None, None, None, :])                     # (N,j,i,dy,dx)
        cell = ((y[:, :, None, None, None] - 1 + tap[:, None]) * w
                + x[:, None, :, None, None] - 1 + tap)
        sel = ok[..., None, None].expand(t.shape)
        cell, t = cell.expand(t.shape)[sel], t[sel]
        n_of = torch.arange(o.shape[0], device=dev)[:, None, None, None,
                                                    None].expand(
                                                        sel.shape)[sel]
        if cell.numel() == 0:
            continue
        # the terms grouped by pixel, each group in the order above; step
        # s adds every pixel's s-th term to it
        perm = torch.sort(cell, stable=True).indices
        cell, t, n_of = cell[perm], t[perm], n_of[perm]
        pos = torch.arange(cell.shape[0], device=dev)
        first = torch.ones_like(cell, dtype=torch.bool)
        first[1:] = cell[1:] != cell[:-1]
        rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
        steps = torch.split(torch.sort(rank, stable=True).indices,
                            torch.bincount(rank).tolist())
        for f in range(3):
            term = t * vals[k, f, o][n_of]
            plane = out[k, f]
            for e in steps:
                c = cell[e]
                plane[c] = plane[c] + term[e]
    return out.reshape(b, 3, h, w).to(torch.float32)


def merged(spec, params: Params, p, pweight, p_o, pt_o, pweight_o):
    """A grid's dense flow (B, H, W, 2): its densification's sums plus the
    other grid's splat, normalised by the summed weight."""
    dense = dense_sums(spec, params, p, pweight)
    back = splat(spec, params, p_o, pt_o, pweight_o)
    we = (dense[:, 0] + back[:, 0])[..., None]
    flow = dense[:, 1:].movedim(1, -1) + back[:, 1:].movedim(1, -1)
    return torch.where(we > 0, flow / we, flow)


def flow(im_a: torch.Tensor, im_b: torch.Tensor, params: Params,
         carry: torch.Tensor = None) -> torch.Tensor:
    """Full-resolution flow (B, H, W, 2) of u8 gray pairs (B, 1, H, W),
    padded to multiples of 2^sc_f; `carry` warm-starts the forward grid's
    coarsest scale (the backward grid starts from zero)."""
    check_supported(params)
    full_h, full_w = im_a.shape[-2:]
    pyr_a = base.pyramid(im_a, params, grad=True)
    pyr_b = base.pyramid(im_b, params, grad=True)
    prev, prev_bw = carry, None
    for sl in params.levels:
        spec = make_level_spec(sl, full_w, full_h, params)
        xs, ys, ref = base._grid(spec, im_a.device)
        tiled = uses_tiled(spec)
        grids = []
        for start, src, target in ((prev, pyr_a[sl], pyr_b[sl][0]),
                                   (prev_bw, pyr_b[sl], pyr_a[sl][0])):
            if start is None:
                p_init = torch.zeros((im_a.shape[0], 2, spec.nopatches),
                                     dtype=torch.float32, device=im_a.device)
            else:
                p_init = (start[:, torch.as_tensor(ys // 2,
                                                   device=start.device),
                                torch.as_tensor(xs // 2,
                                                device=start.device)]
                          * 2.0).transpose(1, 2).contiguous()
            tpl = base.templates(spec, params, src, tiled)
            p, pweight = base.gauss_newton(spec, params, target, tpl, p_init,
                                           tiled)
            grids.append((p, ref.T[None] + p,
                          pweight.reshape(-1, params.p_samp_s,
                                          params.p_samp_s,
                                          spec.nopatches)))
        (p, pt, pw), (p_bw, pt_bw, pw_bw) = grids
        pad = spec.pad
        im1 = pyr_a[sl][0][:, 0, pad:-pad, pad:-pad]
        im2 = pyr_b[sl][0][:, 0, pad:-pad, pad:-pad]
        prev = merged(spec, params, p, pw, p_bw, pt_bw, pw_bw)
        if params.usetvref:
            prev = base.refine(prev, im1, im2, sl, params)
        if sl > params.sc_l:
            prev_bw = merged(spec, params, p_bw, pw_bw, p, pt, pw)
            if params.usetvref:
                prev_bw = base.refine(prev_bw, im2, im1, sl, params)
    return upscale(prev, params.sc_l, full_h, full_w)
