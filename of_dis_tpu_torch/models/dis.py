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

import time

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


def _p_init(spec, params: DISParams, flow_prev, batch: int, device
            ) -> torch.Tensor:
    """A level's start parameters (B, N, nop): zero at the coarsest level,
    else read from the coarser level's flow."""
    if flow_prev is None:
        return torch.zeros((batch, spec.nopatches, params.nop),
                           dtype=torch.float32, device=device)
    return patch_solver.init_from_coarser(spec, params, flow_prev)


class _NoClock:
    """The stage clock of a quiet run: nothing waits, nothing prints."""

    def lap(self) -> float:
        return 0.0

    def report(self, fmt: str, *args) -> None:
        pass


class _StageClock(_NoClock):
    """The verbosity-2 clock: a lap waits for the device to finish what
    was queued (torch.cuda.synchronize; nothing to wait for on the CPU)
    and returns the host seconds since the previous lap."""

    def __init__(self, device: torch.device):
        self.device = device
        self.last = time.perf_counter()

    def lap(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt, self.last = now - self.last, now
        return dt

    def report(self, fmt: str, *args) -> None:
        print(fmt % args)


def _dis_flow_core(im_a: torch.Tensor, im_b: torch.Tensor, params: DISParams,
                   full_w: int, full_h: int, clock: _NoClock = _NoClock()
                   ) -> torch.Tensor:
    """Batched coarse-to-fine pipeline: im_a/im_b (B, C, H, W) on one
    device. Returns (B, H/2^sc_l, W/2^sc_l, nop). A `_StageClock` times
    the pyramid, the grid set-up and per scale the stages pconst
    (templates of the levels whose GN kernel reads them), pinit, poptim,
    cflow and tvopt, and prints the reference's lines (run_dense.cpp:
    347-353, oflow.cpp:297)."""
    _check_supported(params)
    pad = params.p_samp_s
    fb = params.usefbcon
    clock.lap()
    ims_a, dxs_a, dys_a = pyramid.build_pyramid(im_a, params.sc_f, pad,
                                                lv_l=params.sc_l)
    # the second image's gradients serve the backward grid only
    ims_b, dxs_b, dys_b = pyramid.build_pyramid(im_b, params.sc_f, pad,
                                                getgrad=fb, lv_l=params.sc_l)
    clock.report("TIME (Pyramide+Gradients) (ms): %3g", clock.lap() * 1e3)
    # the per-scale grids (OFClass allocates them up front,
    # oflow.cpp:139-178); the backward grid takes the right camera's sign
    levels = range(params.sc_f, params.sc_l - 1, -1)
    specs = {sl: (make_level_spec(sl, full_w, full_h, params, camlr=0),
                  make_level_spec(sl, full_w, full_h, params, camlr=1)
                  if fb else None) for sl in levels}
    clock.report("TIME (Grid Memo. Alloc. ) (ms): %3g", clock.lap() * 1e3)
    batch, dev = im_a.shape[0], im_a.device

    def templates(spec, src):
        # a large level's `gn_tiled` builds its templates itself
        if patch_solver.builds_templates(spec, params):
            return None
        return patch_solver.extract_templates(spec, params, *src)

    flow = flow_bw = None
    for sl in levels:
        spec, spec_bw = specs[sl]
        ia, ib = ims_a[sl], ims_b[sl]
        # with the merge, the backward grid swaps the images' roles
        src = (ia, dxs_a[sl], dys_a[sl])
        src_bw = (ib, dxs_b[sl], dys_b[sl]) if fb else None
        tpl = templates(spec, src)
        tpl_bw = templates(spec_bw, src_bw) if fb else None
        laps = [clock.lap()]
        p_init = _p_init(spec, params, flow, batch, dev)
        p_init_bw = _p_init(spec_bw, params, flow_bw, batch, dev) if fb \
            else None
        laps.append(clock.lap())
        res = patch_solver.optimize_level_batched(spec, params, ib, tpl,
                                                  p_init, src=src)
        res_bw = None
        if fb:
            res_bw = patch_solver.optimize_level_batched(
                spec_bw, params, ia, tpl_bw, p_init_bw, src=src_bw)
        laps.append(clock.lap())
        flow = densify.aggregate_flow_dense(spec, params, res, res_bw)
        # no backward flow at the last scale: nothing reads it
        # (oflow.cpp:266)
        bw_next = fb and sl > params.sc_l
        if bw_next:
            flow_bw = densify.aggregate_flow_dense(spec_bw, params, res_bw,
                                                   res)
        laps.append(clock.lap())
        if params.usetvref:
            flow = _tv_refine(flow, ia, ib, spec, params)
            if bw_next:
                flow_bw = _tv_refine(flow_bw, ib, ia, spec_bw, params)
        laps.append(clock.lap())
        clock.report("TIME (Sc: %i, #p:%6i, pconst, pinit, poptim, cflow, "
                     "tvopt, total): %8.2f %8.2f %8.2f %8.2f %8.2f -> %8.2f "
                     "ms.", sl, spec.nopatches, *(t * 1e3 for t in laps),
                     sum(laps) * 1e3)
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


def upscale_full(flow: torch.Tensor, params: DISParams, full_h: int,
                 full_w: int) -> torch.Tensor:
    """The finest scale's flow of one pair (h, w, nop) at the padded full
    resolution (full_h, full_w, nop): kernel K4 on CUDA."""
    if params.sc_l == 0:
        return flow
    return upscale_kernel.upscale_batched(flow[None].contiguous(),
                                          params.sc_l, full_h, full_w)[0]


def dis_flow_full(im_a, im_b, params: DISParams, full_w: int, full_h: int,
                  device="cuda") -> torch.Tensor:
    """dis_flow + the final upscale to the padded full resolution:
    (full_h, full_w, nop)."""
    flow = dis_flow(im_a, im_b, params, full_w, full_h, device=device)
    return upscale_full(flow, params, full_h, full_w)


def dis_flow_timed(im_a, im_b, params: DISParams, full_w: int, full_h: int,
                   init_flow=None, device="cuda") -> torch.Tensor:
    """The verbosity-2 path: `dis_flow` with each stage run to completion
    and timed, printing the pyramid's and the grid set-up's lines and the
    reference's per-scale six-column breakdown (oflow.cpp:297):

      TIME (Sc: i, #p: n, pconst, pinit, poptim, cflow, tvopt, total): ...

    Spans are host perf_counter times around stages that end in
    `torch.cuda.synchronize`. The computation is `dis_flow`'s, so the flow
    equals its flow bit for bit: (H/2^sc_l, W/2^sc_l, nop). A warm start
    (`init_flow`) is not ported."""
    if init_flow is not None:
        raise NotImplementedError(
            "init_flow is not ported yet (ROADMAP queue 1, item 14)")
    dev = resolve_device(device)
    a = _as_batch(im_a, dev)[None]
    b = _as_batch(im_b, dev)[None]
    return _dis_flow_core(a, b, params, full_w, full_h,
                          clock=_StageClock(dev))[0]


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
