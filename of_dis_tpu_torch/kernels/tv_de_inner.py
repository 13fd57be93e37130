"""K5 and K5': the depth (one unknown) TV fixed-point loop of one level,
gray or RGB, one CUDA block per stereo pair (csrc/tv_de_inner.cu).
`de_inner` replaces `_de_inner_pallas_batched` of the JAX package;
`de_inner_single` launches the same kernel with one block for one
unbatched pair and replaces `_de_inner_pallas`. Each entry keeps its own
launch count.

Plain twin: `ops.tv._de_inner_loop`."""

from __future__ import annotations

import ctypes

import torch

from of_dis_tpu_torch.kernels import build

NAME = "tv_de_inner"
N_SCRATCH = 6           # (H, W) scratch fields per pair, see the .cu
launches = 0            # batched launches (K5)
launches_single = 0     # single-pair launches (K5')

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_p] * 5 + [_i] * 9 + [_f] * 5 + [_p]


def _plain(wx, mask, deriv, **kw):
    """The twin on the wrapper's layout: deriv (B, 8, C, H, W)."""
    from of_dis_tpu_torch.ops.tv import _de_inner_loop
    return _de_inner_loop(wx, mask,
                          [d.movedim(1, 0) for d in deriv.unbind(1)],
                          noc=deriv.shape[2], **kw)


def _launch(wx, mask, deriv, *, camlr, quarter_alpha, hd3, hg3, n_inner,
            n_solver, omega, row_parity=0):
    b, h, w = wx.shape
    noc = deriv.shape[2] if deriv.ndim == 5 else 0
    if noc not in (1, 3):
        raise ValueError(f"{NAME}: deriv must be (B, 8, C, H, W) with C 1 "
                         f"or 3, got {tuple(deriv.shape)}")
    if camlr not in (0, 1):
        raise ValueError(f"{NAME}: camlr must be 0 or 1, got {camlr}")
    build.check_tensor(NAME, "wx", wx, (b, h, w))
    build.check_tensor(NAME, "mask", mask, (b, h, w))
    build.check_tensor(NAME, "deriv", deriv, (b, 8, noc, h, w))
    uu = torch.empty_like(wx)
    scratch = torch.empty((b, N_SCRATCH, h, w), dtype=torch.float32,
                          device=wx.device)
    p = build.ptr
    build.launch(wx.device, NAME, "of_tv_de_inner", _ARGTYPES, p(wx),
                 p(mask), p(deriv), p(uu), p(scratch), b, noc, h, w, n_inner,
                 n_solver, row_parity % 2, int(bool(hd3)), camlr,
                 quarter_alpha, hd3, hg3, omega, 1.0 - omega)
    return uu


def de_inner(wx: torch.Tensor, mask: torch.Tensor, deriv: torch.Tensor, *,
             camlr: int, quarter_alpha: float, hd3: float, hg3: float,
             n_inner: int, n_solver: int, omega: float, row_parity: int = 0):
    """uu (B, H, W), the sign-clamped disparity after `n_inner` fixed-point
    iterations.

    wx, mask (B, H, W); deriv (B, 8, C, H, W) as for `tv_of_inner`; camlr 0
    clamps uu <= 0 (left camera), 1 clamps uu >= 0. CPU tensors run the
    plain twin."""
    global launches
    kw = dict(camlr=camlr, quarter_alpha=quarter_alpha, hd3=hd3, hg3=hg3,
              n_inner=n_inner, n_solver=n_solver, omega=omega,
              row_parity=row_parity)
    if wx.device.type == "cpu":
        return _plain(wx, mask, deriv, **kw)
    out = _launch(wx, mask, deriv, **kw)
    launches += 1
    return out


def de_inner_single(wx: torch.Tensor, mask: torch.Tensor,
                    deriv: torch.Tensor, **kw):
    """`de_inner` for one unbatched pair: wx, mask (H, W); deriv
    (8, C, H, W). Returns uu (H, W). One block of the K5 kernel."""
    global launches_single
    args = (wx[None], mask[None], deriv[None])
    if wx.device.type == "cpu":
        uu = _plain(*args, **kw)
    else:
        uu = _launch(*args, **kw)
        launches_single += 1
    return uu[0]
