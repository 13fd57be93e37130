"""K5 and K5': the depth (one unknown) TV fixed-point loop of one level,
gray or RGB, as one launch a level (csrc/tv_de_inner.cu): on the cluster
route a pair's rows are split over a cluster of K blocks that keep the
loop's fields in shared memory; pairs that no 16-block cluster holds take
the cooperative route. `route` is the rule. `de_inner` replaces
`_de_inner_pallas_batched` of the JAX package; `de_inner_single` launches
the same kernel for one unbatched pair, through its own C entry
(`of_tv_de_inner_single`, so its launches count apart), and replaces
`_de_inner_pallas`.

Plain twin: `ops.tv._de_inner_loop`."""

from __future__ import annotations

import ctypes

import torch

from of_dis_tpu_torch.kernels import build

NAME = "tv_de_inner"
N_FIELDS = 6            # float fields a pixel: du, wh, wv, om11, b1, sm
# The route rule's card: an H100 SXM, 132 SMs, 232,448 bytes of dynamic
# shared memory a block, clusters of at most 16 blocks (non-portable size).
SMS = 132
SMEM_BYTES = 232448
MAX_CLUSTER = 16
# The rule's two thresholds, measured on an H100 with `kernel_variants.py
# tv_de_inner --routes` (PERF.md): bands of at most 2,048 pixels (two a
# thread), below which splitting a pair costs more cluster barriers (~1 us
# a pass) than it saves; and levels of fewer than 64 blocks, which more,
# smaller bands spread over the card.
BLOCK_PIXELS = 2048
FILL_BLOCKS = 64
last_route = None       # (name, K) of the last launch, for chip_smoke.py

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_p] * 5 + [_i] * 9 + [_f] * 5 + [_i, _p]


def _plain(wx, mask, deriv, **kw):
    """The twin on the wrapper's layout: deriv (B, 8, C, H, W)."""
    from of_dis_tpu_torch.ops.tv import _de_inner_loop
    return _de_inner_loop(wx, mask,
                          [d.movedim(1, 0) for d in deriv.unbind(1)],
                          noc=deriv.shape[2], **kw)


def route(b: int, h: int, w: int):
    """("cluster", K) or ("cooperative", 0) for a level of b pairs of
    h x w pixels. Pairs of at most BLOCK_PIXELS pixels keep one block a
    pair (K = 1). Larger ones take the smallest power-of-two K whose bands
    of rows (ceil(h / K) rows, at least 2 when K > 1) fit one block's shared
    memory and hold at most BLOCK_PIXELS pixels, halved while b K exceeds
    the card's SMs (never below what the shared memory needs), doubled
    while b K stays under FILL_BLOCKS. Where no cluster of MAX_CLUSTER holds
    a pair, the cooperative route."""
    def band(k):
        return -(-h // k) * w

    def splits(k):
        return k <= MAX_CLUSTER and (k == 1 or h >= 2 * k)

    k_min = 1
    while N_FIELDS * 4 * band(k_min) > SMEM_BYTES:
        k_min *= 2
        if not splits(k_min):
            return ("cooperative", 0)
    if h * w <= BLOCK_PIXELS:
        return ("cluster", k_min)
    k = k_min
    while band(k) > BLOCK_PIXELS and splits(2 * k):
        k *= 2
    while k > k_min and b * k > SMS:
        k //= 2
    while b * k < FILL_BLOCKS and splits(2 * k):
        k *= 2
    return ("cluster", k)


def max_clusters(device, noc: int, k: int, h: int, w: int) -> int:
    """Clusters of k blocks of the noc-channel instance that `device` holds
    at once for an h x w level (cudaOccupancyMaxActiveClusters); 0 where
    none can be resident."""
    n = build.query(device, NAME, "of_tv_de_max_clusters", [_i] * 4, noc, k,
                    h, w)
    if n < 0:
        build.check(-n, NAME)
    return n


def _launch(wx, mask, deriv, *, camlr, quarter_alpha, hd3, hg3, n_inner,
            n_solver, omega, row_parity=0, symbol="of_tv_de_inner"):
    global last_route
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
    name, k = route(b, h, w)
    uu = torch.empty_like(wx)
    scratch = (torch.empty((N_FIELDS, b, h, w), dtype=torch.float32,
                           device=wx.device) if name == "cooperative"
               else uu)
    p = build.ptr
    build.launch(wx.device, NAME, symbol, _ARGTYPES, p(wx),
                 p(mask), p(deriv), p(uu), p(scratch), b, noc, h, w, n_inner,
                 n_solver, row_parity % 2, int(bool(hd3)), camlr,
                 quarter_alpha, hd3, hg3, omega, 1.0 - omega, k)
    last_route = (name, k)
    return uu


def de_inner(wx: torch.Tensor, mask: torch.Tensor, deriv: torch.Tensor, *,
             camlr: int, quarter_alpha: float, hd3: float, hg3: float,
             n_inner: int, n_solver: int, omega: float, row_parity: int = 0):
    """uu (B, H, W), the sign-clamped disparity after `n_inner` fixed-point
    iterations.

    wx, mask (B, H, W); deriv (B, 8, C, H, W) as for `tv_of_inner`; camlr 0
    clamps uu <= 0 (left camera), 1 clamps uu >= 0. CPU tensors run the
    plain twin."""
    kw = dict(camlr=camlr, quarter_alpha=quarter_alpha, hd3=hd3, hg3=hg3,
              n_inner=n_inner, n_solver=n_solver, omega=omega,
              row_parity=row_parity)
    if wx.device.type == "cpu":
        return _plain(wx, mask, deriv, **kw)
    return _launch(wx, mask, deriv, **kw)


def de_inner_single(wx: torch.Tensor, mask: torch.Tensor,
                    deriv: torch.Tensor, **kw):
    """`de_inner` for one unbatched pair: wx, mask (H, W); deriv
    (8, C, H, W). Returns uu (H, W). The K5 kernel at B = 1."""
    args = (wx[None], mask[None], deriv[None])
    if wx.device.type == "cpu":
        uu = _plain(*args, **kw)
    else:
        uu = _launch(*args, symbol="of_tv_de_inner_single", **kw)
    return uu[0]
