"""K2 and K2': the flow TV fixed-point loop of one level, gray or RGB, as
one launch a level (csrc/tv_of_inner.cu): a cooperative launch that
spreads the pixels of every pair over the whole card, or, for pairs of at
most `BLOCK_MAX_PIXELS` pixels, one block a pair. `of_inner` replaces
`_of_inner_pallas_batched` of the JAX package; `of_inner_single` launches
the same kernel for one unbatched pair and replaces `_of_inner_pallas`.
Each entry keeps its own launch count.

Plain twin: `ops.tv._of_inner_loop`."""

from __future__ import annotations

import ctypes

import torch

from of_dis_tpu_torch.kernels import build

NAME = "tv_of_inner"
N_SCRATCH = 9           # scratch fields (N_SCRATCH, B, H, W), see the .cu
# Pairs of at most this many pixels take the block route (one 1,024-thread
# block a pair, block barriers), larger ones the cooperative route (grid
# barriers): a rule of the level's shape, from the crossover measured on an
# H100 (PERF.md).
BLOCK_MAX_PIXELS = 1024
launches = 0            # batched launches (K2)
launches_single = 0     # single-pair launches (K2')

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_p] * 7 + [_i] * 8 + [_f] * 5 + [_i, _p]


def _plain(wx, wy, mask, deriv, **kw):
    """The twin on the wrapper's layout: deriv (B, 8, C, H, W)."""
    from of_dis_tpu_torch.ops.tv import _of_inner_loop
    return _of_inner_loop(wx, wy, mask,
                          [d.movedim(1, 0) for d in deriv.unbind(1)],
                          noc=deriv.shape[2], **kw)


def cooperative(h: int, w: int) -> bool:
    """Whether a level of h x w pixels a pair takes the cooperative route."""
    return h * w > BLOCK_MAX_PIXELS


def _launch(wx, wy, mask, deriv, *, quarter_alpha, hd3, hg3, n_inner,
            n_solver, omega, row_parity=0):
    b, h, w = wx.shape
    noc = deriv.shape[2] if deriv.ndim == 5 else 0
    if noc not in (1, 3):
        raise ValueError(f"{NAME}: deriv must be (B, 8, C, H, W) with C 1 "
                         f"or 3, got {tuple(deriv.shape)}")
    for what, t in (("wx", wx), ("wy", wy), ("mask", mask)):
        build.check_tensor(NAME, what, t, (b, h, w))
    build.check_tensor(NAME, "deriv", deriv, (b, 8, noc, h, w))
    uu = torch.empty_like(wx)
    vv = torch.empty_like(wx)
    scratch = torch.empty((N_SCRATCH, b, h, w), dtype=torch.float32,
                          device=wx.device)
    p = build.ptr
    build.launch(wx.device, NAME, "of_tv_of_inner", _ARGTYPES, p(wx), p(wy),
                 p(mask), p(deriv), p(uu), p(vv), p(scratch), b, noc, h, w,
                 n_inner, n_solver, row_parity % 2, int(bool(hd3)),
                 quarter_alpha, hd3, hg3, omega, 1.0 - omega,
                 int(cooperative(h, w)))
    return uu, vv


def of_inner(wx: torch.Tensor, wy: torch.Tensor, mask: torch.Tensor,
             deriv: torch.Tensor, *, quarter_alpha: float, hd3: float,
             hg3: float, n_inner: int, n_solver: int, omega: float,
             row_parity: int = 0):
    """uu, vv (B, H, W) after `n_inner` fixed-point iterations.

    wx, wy, mask (B, H, W); deriv (B, 8, C, H, W) holds the derivatives
    (ix, iy, iz, ixx, ixy, iyy, ixz, iyz) of C = 1 (gray) or 3 (RGB)
    channels. CPU tensors run the plain twin."""
    global launches
    kw = dict(quarter_alpha=quarter_alpha, hd3=hd3, hg3=hg3, n_inner=n_inner,
              n_solver=n_solver, omega=omega, row_parity=row_parity)
    if wx.device.type == "cpu":
        return _plain(wx, wy, mask, deriv, **kw)
    out = _launch(wx, wy, mask, deriv, **kw)
    launches += 1
    return out


def of_inner_single(wx: torch.Tensor, wy: torch.Tensor, mask: torch.Tensor,
                    deriv: torch.Tensor, **kw):
    """`of_inner` for one unbatched pair: wx, wy, mask (H, W); deriv
    (8, C, H, W). Returns uu, vv (H, W). The K2 kernel at B = 1."""
    global launches_single
    args = (wx[None], wy[None], mask[None], deriv[None])
    if wx.device.type == "cpu":
        uu, vv = _plain(*args, **kw)
    else:
        uu, vv = _launch(*args, **kw)
        launches_single += 1
    return uu[0], vv[0]
