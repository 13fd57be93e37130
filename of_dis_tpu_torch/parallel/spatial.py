"""Row-sharded TV refinement of one level over a list of devices.

The reference is single-process and its largest working set is one frame
(refine_variational.cpp:152-247). The JAX package splits a level whose TV
working set outgrows one chip by ROWS over a device mesh, each shard
taking a halo of d rows of the flow from its neighbours (ghost zones) and
cropping its interior, which is exact: one inner iteration of the TV
fixed-point loop reaches a bounded number of rows (the derivative
stencils, the smoothness flux and 2 * n_solver red-black sweeps), and d
is sized so that what a block's own edge does never reaches its interior.

The port does the same on its own `parallel.mesh.Mesh` (one process, a
list of devices, repeats allowed), without a framework mesh or
`torch.distributed`: the rows of a level are cut into one contiguous block
a device by `mesh.shard_bounds`, the halos are copied between neighbouring
devices with `.to()`, and each shard runs the whole batch of pairs through
the stock kernels on its device: K3 (the warp, `kernels.warp`, given the
block's first global row), then K2 (`kernels.tv_of_inner`, flow) or K5
(`kernels.tv_de_inner`, depth) with the block's global row parity, so that
its red-black checkerboard is the unsharded sweep's at any shard height.
Shards are launched one after another from the calling thread; the result
comes back on the device of the input flow.

One difference from the JAX shard body, by design: a block is padded only
toward a real neighbour. The top shard holds rows [0, hl + d), the bottom
one [H - hl - d, H), so each edge shard's outer edge is the image's edge,
where the stock loop clamps exactly as the unsharded frame does. The JAX
body pads d replicated rows outside the image too, and so needs to
re-replicate the flow before every inner iteration (`_rep`) and to zero
the vertical smoothness weight outside the image (`not_last`); the stock
loop does neither, and padding both sides with replicated rows is not
exact with it (`tests/test_torch_spatial.py::
test_replicated_padding_with_the_stock_loop_is_not_exact`). Without those
rows neither `_rep` nor `not_last` is needed, and every split equals the
unsharded level bit for bit.

Reference: of_dis_tpu/parallel/spatial.py (the JAX package's module).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from of_dis_tpu_torch.kernels import tv_de_inner, tv_of_inner
from of_dis_tpu_torch.ops import tv
from of_dis_tpu_torch.parallel.mesh import Mesh, shard_bounds


def halo_depth(n_inner: int, n_solver: int) -> int:
    """Rows a shard takes from each neighbour (spatial.py:42): 4 for the
    warp / derivative stencil chain, then per inner iteration 1 (the
    smoothness' 3-tap), 1 (the sub-laplacian flux) and 2 * n_solver (the
    red-black neighbour sums)."""
    return 4 + n_inner * (2 + 2 * n_solver)


def _row_blocks(mesh: Mesh, h: int, d: int) -> List[Tuple[int, int, int]]:
    """Per device, in order, (a, g0, g1): its interior rows [a, a + hl)
    (`shard_bounds`, which raises unless h divides evenly) and its padded
    block [g0, g1), d more rows toward each real neighbour. Raises when a
    neighbour's block is shorter than the halo (the JAX assert,
    spatial.py:130-132)."""
    bounds = shard_bounds(mesh, h)
    hl = h // mesh.size
    if mesh.size > 1 and d > hl:
        raise ValueError(f"halo depth {d} exceeds the shard height {hl} "
                         f"({h} rows over {mesh.size} devices); use fewer "
                         "devices")
    return [(s.start, max(0, s.start - d), min(h, s.stop + d))
            for s in bounds]


def _exchange_flow_halo(local, devices, d: int):
    """Each shard's local (B, hl, W) blocks with d rows from each real
    neighbour above and below (spatial.py:50), copied to its device; the
    edge shards get no outward rows. `local[i]` is shard i's tuple of
    fields (one for depth, two for flow). Returns one tuple of (B, g1 - g0,
    W) blocks a shard."""
    n = len(local)
    out = []
    for i, dev in enumerate(devices):
        padded = []
        for k, x in enumerate(local[i]):
            parts = [x]
            if i > 0:
                parts.insert(0, local[i - 1][k][..., -d:, :].to(dev))
            if i < n - 1:
                parts.append(local[i + 1][k][..., :d, :].to(dev))
            padded.append(torch.cat(parts, dim=-2))
        out.append(tuple(padded))
    return out


def _warp_global(im2, wx, wy, g0: int):
    """K3 on a block whose first row is global row g0 (spatial.py:81):
    im2 (B, C, H, W) the whole frame on the block's device, wx / wy
    (B, hp, W). Returns (warped (B, C, hp, W), mask (B, hp, W)). Reached
    through `ops.tv`, where the level path looks the wrapper up too."""
    return tv.warp_image_batched(im2, wx, wy, row0=g0)


def _shard_prologue(padded, im1, im2, g0: int):
    """A shard's set-up (spatial.py:115): its rows of im1, the warp of the
    whole im2 by its padded flow, the 5-tap derivative stack (B, 8, C, hp,
    W) as `ops.tv` builds it, and the parity of its first global row.
    `padded` is (wx,) for depth (wy = 0) or (wx, wy) for flow; im1 is the
    whole frame anywhere, im2 the whole frame on the shard's device. The
    JAX body's `_rep` and `not_last` are not needed (module docstring)."""
    wx = padded[0]
    hp = wx.shape[-2]
    im1_loc = im1[..., g0:g0 + hp, :].to(wx.device)
    wy = padded[1] if len(padded) == 2 else torch.zeros_like(wx)
    w_im2, mask = _warp_global(im2, wx, wy, g0)
    deriv = torch.stack(tv.get_derivatives(im1_loc, w_im2), dim=1)
    return mask, deriv, g0 % 2


def _local_ref_level_of(padded, mask, deriv, parity, coef):
    """A shard's flow loop (spatial.py:181): K2 on the (B, hp, W) block,
    every pair of the batch in one launch. Returns (uu, vv)."""
    return tv_of_inner.of_inner(*padded, mask, deriv, row_parity=parity,
                                **coef)


def _local_ref_level_de(padded, mask, deriv, parity, coef, camlr: int):
    """A shard's depth loop (spatial.py:217): K5 on the (B, hp, W) block,
    every pair in one launch. Returns (uu,)."""
    return (tv_de_inner.de_inner(padded[0], mask, deriv, camlr=camlr,
                                 row_parity=parity, **coef),)


def _split_level(mesh: Mesh, fields, im1, im2, *, alpha, gamma, delta,
                 n_inner, n_solver, omega, camlr=None):
    """The level's refinement split by rows over `mesh`: fields (wx,) or
    (wx, wy), each (B, H, W); im1 / im2 (B, C, H, W). Returns the refined
    fields, each (B, H, W) on the device of fields[0]."""
    h = fields[0].shape[-2]
    d = halo_depth(n_inner, n_solver)
    blocks = _row_blocks(mesh, h, d)
    hl = h // mesh.size
    quarter_alpha, hd3, hg3 = tv.tv_coefficients(alpha, gamma, delta)
    coef = dict(quarter_alpha=quarter_alpha, hd3=hd3, hg3=hg3,
                n_inner=n_inner, n_solver=n_solver, omega=omega)
    local = [tuple(f[..., a:a + hl, :].to(dev) for f in fields)
             for (a, _, _), dev in zip(blocks, mesh.devices)]
    padded = _exchange_flow_halo(local, mesh.devices, d)
    outs = []
    for (a, g0, _), dev, pf in zip(blocks, mesh.devices, padded):
        mask, deriv, parity = _shard_prologue(pf, im1, im2.to(dev), g0)
        if camlr is None:
            res = _local_ref_level_of(pf, mask, deriv, parity, coef)
        else:
            res = _local_ref_level_de(pf, mask, deriv, parity, coef, camlr)
        outs.append(tuple(r[..., a - g0:a - g0 + hl, :] for r in res))
    home = fields[0].device
    return tuple(torch.cat([o[k].to(home) for o in outs], dim=-2)
                 for k in range(len(fields)))


def tv_refine_spatial(mesh: Mesh, flow: torch.Tensor, im1: torch.Tensor,
                      im2: torch.Tensor, *, alpha, gamma, delta, n_inner,
                      n_solver, omega) -> torch.Tensor:
    """Row-sharded flow TV refinement of one level over `mesh`
    (spatial.py:285). flow (H, W, 2), im1 / im2 (C, H, W) de-padded level
    images, or a batch of each ((B, H, W, 2), (B, C, H, W)), every pair
    through one launch a shard. H must divide by the mesh size and each
    shard hold at least `halo_depth` rows. The JAX function's `axis_name`
    has no counterpart: a port `Mesh` is one unnamed axis. Returns the
    refined flow, of flow's shape on flow's device, equal to the unsharded
    `ops.tv.ref_level_of_batched` bit for bit."""
    batched = flow.ndim == 4
    if not batched:
        flow, im1, im2 = flow[None], im1[None], im2[None]
    uu, vv = _split_level(mesh, (flow[..., 0], flow[..., 1]), im1, im2,
                          alpha=alpha, gamma=gamma, delta=delta,
                          n_inner=n_inner, n_solver=n_solver, omega=omega)
    out = torch.stack([uu, vv], dim=-1)
    return out if batched else out[0]


def tv_refine_spatial_de(mesh: Mesh, wx: torch.Tensor, im1: torch.Tensor,
                         im2: torch.Tensor, *, alpha, gamma, delta, n_inner,
                         n_solver, omega, camlr: int) -> torch.Tensor:
    """Row-sharded depth TV refinement over `mesh` (spatial.py:253): wx
    (H, W) disparity and im1 / im2 (C, H, W), or a batch of each; camlr 0
    clamps to <= 0, 1 to >= 0. As `tv_refine_spatial`, equal to the
    unsharded `ops.tv.ref_level_de_batched` bit for bit."""
    batched = wx.ndim == 3
    if not batched:
        wx, im1, im2 = wx[None], im1[None], im2[None]
    (uu,) = _split_level(mesh, (wx,), im1, im2, alpha=alpha, gamma=gamma,
                         delta=delta, n_inner=n_inner, n_solver=n_solver,
                         omega=omega, camlr=camlr)
    return uu if batched else uu[0]


def tv_refine_spatial_batched(meshes: Sequence[Mesh], flow: torch.Tensor,
                              im1: torch.Tensor, im2: torch.Tensor, *,
                              alpha, gamma, delta, n_inner, n_solver,
                              omega) -> torch.Tensor:
    """The 2-D (pairs x rows) form (spatial.py:319): the pair batch cut
    into one chunk a row mesh by the batch split rule
    (`mesh.shard_bounds`), and each chunk row-sharded over its own mesh.
    `meshes` is a tuple of row meshes of one size (the JAX package's
    `pairs` axis is the tuple, its `rows` axis each mesh); a port `Mesh`
    stays one axis. flow (B, H, W, 2), im1 / im2 (B, C, H, W), B divisible
    by the number of meshes. Returns (B, H, W, 2) on flow's device."""
    if len({m.size for m in meshes}) != 1:
        raise ValueError("the row meshes must have one size, got "
                         f"{[m.size for m in meshes]}")
    pairs = Mesh(tuple(m.devices[0] for m in meshes))
    kw = dict(alpha=alpha, gamma=gamma, delta=delta, n_inner=n_inner,
              n_solver=n_solver, omega=omega)
    return torch.cat([tv_refine_spatial(m, flow[s], im1[s], im2[s], **kw)
                      for m, s in zip(meshes, shard_bounds(
                          pairs, flow.shape[0]))])
