"""Coarse-to-fine DIS optical flow (the OFClass equivalent), in PyTorch.

Orchestrates the per-scale stages (reference: oflow.cpp:31-338):
  pyramid -> [per scale, coarse to fine]:
    extract templates -> init from coarser flow -> batched patch optimization
    -> densification -> TV refinement,
then the INTER_LINEAR upscale to full resolution (run_dense.cpp:408-412).

Everything is natively batched over frame pairs (B, C, H, W). On CUDA the
GN loop (K1 on small levels, K6 with in-kernel templates on large ones;
for patches above 12 pixels a side the unfused loop around the extraction
kernel K7), the warp (K3), the TV loop (K2 for flow, K5 for depth) and the
final upscale (K4) run as hand-written kernels; on the CPU their plain
twins run. Entry points take `device="cuda"` by default and raise when CUDA is
missing unless the caller asks for the CPU.

Ported: optical flow (nop=2) and depth from stereo (nop=1, the disparity
of the left camera, sign-clamped to <= 0), each on gray (noc=1) or RGB
(noc=3) input, at all four op-points, with or without the forward-backward
merge (`usefbcon`: a second patch grid on the second image, the right
camera's for depth, merged into the forward densification).
"""

from __future__ import annotations

import numpy as np
import torch

from of_dis_tpu_torch.kernels import upscale as upscale_kernel
from of_dis_tpu_torch.ops import densify, patch_solver, pyramid, tv
from of_dis_tpu_torch.params import DISParams, make_level_spec


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. Raises when CUDA is asked
    for and missing (never falls back to the CPU) and pins full float32
    matrix products (no TF32) for the pyramid, densify and upscale
    contractions, as the JAX package pins Precision.HIGHEST."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _check_supported(params: DISParams) -> None:
    if params.nop not in (1, 2) or params.noc not in (1, 3):
        raise ValueError(f"nop must be 1 or 2 and noc 1 or 3, got "
                         f"nop={params.nop}, noc={params.noc}")


def _tv_refine(flow: torch.Tensor, im_a: torch.Tensor, im_b: torch.Tensor,
               spec, params: DISParams) -> torch.Tensor:
    """Batched variational refinement of one scale's dense flow
    (VarRefClass, refine_variational.cpp:25-116). flow (B, H, W, nop);
    im_a/im_b (B, C, ...) padded level images, de-padded here
    (refine_variational.cpp:119-149). Depth clamps to the sign of
    `spec.camlr`."""
    pad = spec.pad
    im1 = im_a[:, :, pad:-pad, pad:-pad].contiguous()
    im2 = im_b[:, :, pad:-pad, pad:-pad].contiguous()
    n_inner = params.tv_innerit * (spec.level + 1)  # refine_variational.cpp:36
    kw = dict(alpha=params.tv_alpha, gamma=params.tv_gamma,
              delta=params.tv_delta, n_inner=n_inner,
              n_solver=params.tv_solverit, omega=params.tv_sor)
    if params.nop == 2:
        wx, wy = tv.ref_level_of_batched(
            flow[..., 0].contiguous(), flow[..., 1].contiguous(), im1, im2,
            **kw)
        return torch.stack([wx, wy], dim=-1)
    wx = tv.ref_level_de_batched(flow[..., 0].contiguous(), im1, im2,
                                 camlr=spec.camlr, **kw)
    return wx[..., None]


def _dis_flow_core(im_a: torch.Tensor, im_b: torch.Tensor, params: DISParams,
                   full_w: int, full_h: int) -> torch.Tensor:
    """Batched coarse-to-fine pipeline: im_a/im_b (B, C, H, W) on one
    device. Returns (B, H/2^sc_l, W/2^sc_l, nop)."""
    _check_supported(params)
    pad = params.p_samp_s
    fb = params.usefbcon
    ims_a, dxs_a, dys_a = pyramid.build_pyramid(im_a, params.sc_f, pad,
                                                lv_l=params.sc_l)
    # the second image's gradients serve the backward grid only
    ims_b, dxs_b, dys_b = pyramid.build_pyramid(im_b, params.sc_f, pad,
                                                getgrad=fb, lv_l=params.sc_l)
    batch = im_a.shape[0]

    def optimize(spec, target, src, flow_prev):
        if flow_prev is None:
            p_init = torch.zeros((batch, spec.nopatches, params.nop),
                                 dtype=torch.float32, device=im_a.device)
        else:
            p_init = patch_solver.init_from_coarser(spec, params, flow_prev)
        return patch_solver.optimize_level_batched(spec, params, target,
                                                   None, p_init, src=src)

    flow = flow_bw = None
    for sl in range(params.sc_f, params.sc_l - 1, -1):
        spec = make_level_spec(sl, full_w, full_h, params, camlr=0)
        ia, ib = ims_a[sl], ims_b[sl]
        res = optimize(spec, ib, (ia, dxs_a[sl], dys_a[sl]), flow)
        res_bw = None
        if fb:
            # the backward grid: the images swap roles, depth takes the
            # right camera's sign
            spec_bw = make_level_spec(sl, full_w, full_h, params, camlr=1)
            res_bw = optimize(spec_bw, ia, (ib, dxs_b[sl], dys_b[sl]),
                              flow_bw)
        flow = densify.aggregate_flow_dense(spec, params, res, res_bw)
        # no backward flow at the last scale: nothing reads it
        # (oflow.cpp:266)
        bw_next = fb and sl > params.sc_l
        if bw_next:
            flow_bw = densify.aggregate_flow_dense(spec_bw, params, res_bw,
                                                   res)
        if params.usetvref:
            flow = _tv_refine(flow, ia, ib, spec, params)
            if bw_next:
                flow_bw = _tv_refine(flow_bw, ib, ia, spec_bw, params)
    return flow


def _as_batch(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return t.to(device).contiguous()


def dis_flow(im_a, im_b, params: DISParams, full_w: int, full_h: int,
             device="cuda") -> torch.Tensor:
    """Full coarse-to-fine DIS on one frame pair (C, H, W), already
    divisibility-padded to 2^sc_f. Returns dense flow (H/2^sc_l, W/2^sc_l,
    nop) at the finest computed scale."""
    dev = resolve_device(device)
    a = _as_batch(im_a, dev)[None]
    b = _as_batch(im_b, dev)[None]
    return _dis_flow_core(a, b, params, full_w, full_h)[0]


def upscale_output(flow: torch.Tensor, sc_l: int, out_h: int, out_w: int
                   ) -> torch.Tensor:
    """Final rescale of the last-scale flow (..., h, w, nop) to full
    resolution (run_dense.cpp:408-412): values times 2^sc_l, then the
    INTER_LINEAR resize. The plain twin of kernel K4."""
    if sc_l == 0:
        return flow
    f = (flow * float(2 ** sc_l)).movedim(-1, -3)
    return pyramid.resize_linear(f, out_h, out_w).movedim(-3, -1)


def dis_flow_full(im_a, im_b, params: DISParams, full_w: int, full_h: int,
                  device="cuda") -> torch.Tensor:
    """dis_flow + the final upscale to the padded full resolution:
    (full_h, full_w, nop). The upscale is kernel K4 on CUDA."""
    flow = dis_flow(im_a, im_b, params, full_w, full_h, device=device)
    if params.sc_l == 0:
        return flow
    return upscale_kernel.upscale_batched(flow[None].contiguous(),
                                          params.sc_l, full_h, full_w)[0]


def dis_flow_batched(im_a, im_b, params: DISParams, full_w: int, full_h: int,
                     channels_last: bool = True,
                     device="cuda") -> torch.Tensor:
    """Throughput mode over a leading frame-pair batch axis.

    im_a, im_b: (B, C, H, W) u8 or float, divisibility-padded. Returns
    (B, H, W, nop) full-resolution flow, or (B, nop, H, W) with
    channels_last=False."""
    dev = resolve_device(device)
    a = _as_batch(im_a, dev)
    b = _as_batch(im_b, dev)
    flow = _dis_flow_core(a, b, params, full_w, full_h)
    if params.sc_l != 0:
        flow = upscale_kernel.upscale_batched(flow.contiguous(), params.sc_l,
                                              full_h, full_w)
    if channels_last:
        return flow
    return flow.movedim(3, 1)
