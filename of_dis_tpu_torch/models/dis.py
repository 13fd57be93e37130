"""Coarse-to-fine DIS optical flow (the OFClass equivalent), in PyTorch.

Orchestrates the per-scale stages (reference: oflow.cpp:31-338):
  pyramid -> [per scale, coarse to fine]:
    extract templates -> init from coarser flow -> batched patch optimization
    -> densification -> TV refinement,
then the INTER_LINEAR upscale to full resolution (run_dense.cpp:408-412).

Everything is natively batched over frame pairs (B, C, H, W). On CUDA the
GN loop (K1 on small levels, K6 with in-kernel templates on large ones;
for patches above 12 pixels a side the unfused loop around the extraction
kernel K7), the warp (K3), the TV loop (K2 for flow, K5 for depth), the
merge's splat (K8) and the final upscale (K4) run as hand-written
kernels; on the CPU their plain twins run. Entry points take
`device="cuda"` by default and raise when CUDA is missing unless the
caller asks for the CPU.

Ported: optical flow (nop=2) and depth from stereo (nop=1, the disparity
of the left camera, sign-clamped to <= 0), each on gray (noc=1) or RGB
(noc=3) input, at all four op-points, with or without the forward-backward
merge (`usefbcon`: a second patch grid on the second image, the right
camera's for depth, merged into the forward densification); a warm start
of the coarsest level from an initial flow (`init_flow`, oflow.cpp:215-217)
and sequence mode on top of it (`dis_sequence`, `dis_sequence_batched`,
`dis_step_warm`: each pair of a video warm-started from the previous
pair's flow); and the row-sharded TV route (`params.with_spatial_tv`: a
large level's refinement split by rows over a list of devices,
`parallel.spatial`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from of_dis_tpu_torch import trace
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


# Spatial (row-sharded) TV routing: when params carry a spatial_tv_mesh
# (params.with_spatial_tv) and a level's TV working set reaches
# params.spatial_tv_min_bytes, _tv_refine splits the level by rows over
# the mesh (parallel.spatial). The route travels inside the parameter set,
# so every entry point that reaches _dis_flow_core routes.
_TV_FIELDS = 26   # ~fields of (H, W) f32 live per pair in the TV loop


def _spatial_tv_route(b: int, h: int, w: int, params: DISParams):
    """params.spatial_tv_mesh, if a level of b pairs of h x w should be
    row-sharded over it (the JAX package's models/dis.py:44-58): its
    working set reaches the threshold and h divides by the mesh size.
    Shard heights need not be even: each shard's row parity is threaded
    into the red-black sweeps."""
    mesh = params.spatial_tv_mesh
    if mesh is None:
        return None
    if b * _TV_FIELDS * h * w * 4 < params.spatial_tv_min_bytes:
        return None
    if h % mesh.size != 0:
        return None
    return mesh


def _tv_refine(flow: torch.Tensor, im_a: torch.Tensor, im_b: torch.Tensor,
               spec, params: DISParams) -> torch.Tensor:
    """Batched variational refinement of one scale's dense flow
    (VarRefClass, refine_variational.cpp:25-116). flow (B, H, W, nop);
    im_a/im_b (B, C, ...) padded level images, de-padded here
    (refine_variational.cpp:119-149). Depth clamps to the sign of
    `spec.camlr`. A level that `_spatial_tv_route` routes is split by
    rows over the parameter set's mesh, the whole batch at once."""
    pad = spec.pad
    im1 = im_a[:, :, pad:-pad, pad:-pad].contiguous()
    im2 = im_b[:, :, pad:-pad, pad:-pad].contiguous()
    n_inner = params.tv_innerit * (spec.level + 1)  # refine_variational.cpp:36
    kw = dict(alpha=params.tv_alpha, gamma=params.tv_gamma,
              delta=params.tv_delta, n_inner=n_inner,
              n_solver=params.tv_solverit, omega=params.tv_sor)
    mesh = _spatial_tv_route(flow.shape[0], im1.shape[2], im1.shape[3],
                             params)
    if mesh is not None:
        from of_dis_tpu_torch.parallel import spatial

        if params.nop == 2:
            return spatial.tv_refine_spatial(mesh, flow, im1, im2, **kw)
        return spatial.tv_refine_spatial_de(
            mesh, flow[..., 0], im1, im2, camlr=spec.camlr, **kw)[..., None]
    if params.nop == 2:
        wx, wy = tv.ref_level_of_batched(
            flow[..., 0].contiguous(), flow[..., 1].contiguous(), im1, im2,
            **kw)
        return torch.stack([wx, wy], dim=-1)
    wx = tv.ref_level_de_batched(flow[..., 0].contiguous(), im1, im2,
                                 camlr=spec.camlr, **kw)
    return wx[..., None]


def _p_init(spec, params: DISParams, flow_prev, batch: int, device,
            init_flow=None) -> torch.Tensor:
    """A level's start parameters (B, N, nop): read from the coarser
    level's flow; at the coarsest level from `init_flow` (B, H/2^(sc_f+1),
    W/2^(sc_f+1), nop) where one is given, else zero."""
    if flow_prev is None:
        flow_prev = init_flow
    if flow_prev is None:
        return torch.zeros((batch, spec.nopatches, params.nop),
                           dtype=torch.float32, device=device)
    return patch_solver.init_from_coarser(spec, params, flow_prev)


STAGES = ("pconst", "pinit", "poptim", "cflow", "tvopt")


@lru_cache(maxsize=None)
def _span_keys(sl: int) -> Tuple[str, ...]:
    """The span keys of scale sl: `L<sl>`, its stages' (`STAGES`), then
    `L<sl>.merge`, the merge's splats inside `cflow`."""
    key = f"L{sl}"
    return (key,) + tuple(f"{key}.{stage}" for stage in STAGES + ("merge",))


def _dis_flow_core(im_a: torch.Tensor, im_b: torch.Tensor, params: DISParams,
                   full_w: int, full_h: int, init_flow=None) -> torch.Tensor:
    """Batched coarse-to-fine pipeline: im_a/im_b (B, C, H, W) on one
    device; `init_flow` (B, H/2^(sc_f+1), W/2^(sc_f+1), nop) float32 on the
    same device, if given, warm-starts the forward grid's coarsest level
    (the backward grid of the merge starts from zero, as in the JAX
    package). Returns (B, H/2^sc_l, W/2^sc_l, nop). Spans (`trace`): the
    pyramid, the grid set-up, and per scale `L<sl>` its stages (`STAGES`):
    pconst (templates of the levels whose GN kernel reads them), pinit,
    poptim, cflow and tvopt; with the merge, `L<sl>.merge` inside cflow
    (kernel K8's splats)."""
    _check_supported(params)
    pad = params.p_samp_s
    fb = params.usefbcon
    t = trace.begin("pyramid")
    ims_a, dxs_a, dys_a = pyramid.build_pyramid(im_a, params.sc_f, pad,
                                                lv_l=params.sc_l)
    # the second image's gradients serve the backward grid only
    ims_b, dxs_b, dys_b = pyramid.build_pyramid(im_b, params.sc_f, pad,
                                                getgrad=fb, lv_l=params.sc_l)
    trace.end("pyramid", t)
    t = trace.begin("grid")
    if init_flow is not None:
        k = 2 ** (params.sc_f + 1)
        want = (im_a.shape[0], full_h // k, full_w // k, params.nop)
        if tuple(init_flow.shape) != want:
            raise ValueError(f"init_flow has shape {tuple(init_flow.shape)}, "
                             f"expected {want}")
    # the per-scale grids (OFClass allocates them up front,
    # oflow.cpp:139-178); the backward grid takes the right camera's sign
    levels = range(params.sc_f, params.sc_l - 1, -1)
    specs = {sl: (make_level_spec(sl, full_w, full_h, params, camlr=0),
                  make_level_spec(sl, full_w, full_h, params, camlr=1)
                  if fb else None) for sl in levels}
    trace.end("grid", t)
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
        key, k_const, k_init, k_optim, k_flow, k_tv, k_merge = \
            _span_keys(sl)
        t_level = trace.begin(key, sl)
        t = trace.begin(k_const, sl)
        tpl = templates(spec, src)
        tpl_bw = templates(spec_bw, src_bw) if fb else None
        trace.end(k_const, t)
        t = trace.begin(k_init, sl)
        p_init = _p_init(spec, params, flow, batch, dev, init_flow)
        p_init_bw = _p_init(spec_bw, params, flow_bw, batch, dev) if fb \
            else None
        trace.end(k_init, t)
        t = trace.begin(k_optim, sl)
        res = patch_solver.optimize_level_batched(spec, params, ib, tpl,
                                                  p_init, src=src)
        res_bw = None
        if fb:
            res_bw = patch_solver.optimize_level_batched(
                spec_bw, params, ia, tpl_bw, p_init_bw, src=src_bw)
        trace.end(k_optim, t)
        t = trace.begin(k_flow, sl)
        # no backward flow at the last scale: nothing reads it
        # (oflow.cpp:266)
        bw_next = fb and sl > params.sc_l
        if fb:
            flow, flow_bw = densify.merge_flows(
                spec, params, res, res_bw, spec_bw if bw_next else None,
                span=k_merge)
        else:
            flow = densify.aggregate_flow_dense(spec, params, res)
        trace.end(k_flow, t)
        t = trace.begin(k_tv, sl)
        if params.usetvref:
            flow = _tv_refine(flow, ia, ib, spec, params)
            if bw_next:
                flow_bw = _tv_refine(flow_bw, ib, ia, spec_bw, params)
        trace.end(k_tv, t)
        trace.end(key, t_level)
    return flow


def _upscale(flow: torch.Tensor, params: DISParams, full_h: int,
             full_w: int) -> torch.Tensor:
    """A batch's finest-scale flow (B, h, w, nop) at the padded full
    resolution (B, full_h, full_w, nop): kernel K4 on CUDA."""
    if params.sc_l == 0:
        return flow
    t = trace.begin("upscale")
    flow = upscale_kernel.upscale_batched(flow.contiguous(), params.sc_l,
                                          full_h, full_w)
    trace.end("upscale", t)
    return flow


def _as_batch(x, device: torch.device) -> torch.Tensor:
    """`x` as a contiguous tensor on `device`; host data (a NumPy array or
    a CPU tensor) bound for the card goes through `trace.upload`."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if t.device.type == "cpu" and device.type != "cpu":
        return trace.upload(t, device).contiguous()
    return t.to(device).contiguous()


def _as_init(init_flow, device: torch.device):
    """A single pair's warm start (h, w, nop) as a batch of one float32
    tensor on `device`, or None."""
    if init_flow is None:
        return None
    return _as_batch(init_flow, device).to(torch.float32)[None]


@trace.entry
def dis_flow(im_a, im_b, params: DISParams, full_w: int, full_h: int,
             init_flow=None, device="cuda") -> torch.Tensor:
    """Full coarse-to-fine DIS on one frame pair (C, H, W), already
    divisibility-padded to 2^sc_f. `init_flow`, if given, warm-starts the
    coarsest scale and has shape (H/2^(sc_f+1), W/2^(sc_f+1), nop)
    (oflow.h:106, oflow.cpp:215-217; `warm_start_from_full` makes it from a
    full-resolution flow). Returns dense flow (H/2^sc_l, W/2^sc_l, nop) at
    the finest computed scale."""
    dev = resolve_device(device)
    a = _as_batch(im_a, dev)[None]
    b = _as_batch(im_b, dev)[None]
    return _dis_flow_core(a, b, params, full_w, full_h,
                          _as_init(init_flow, dev))[0]


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
    return _upscale(flow[None], params, full_h, full_w)[0]


@trace.entry
def dis_flow_full(im_a, im_b, params: DISParams, full_w: int, full_h: int,
                  init_flow=None, device="cuda") -> torch.Tensor:
    """dis_flow + the final upscale to the padded full resolution:
    (full_h, full_w, nop)."""
    flow = dis_flow(im_a, im_b, params, full_w, full_h, init_flow,
                    device=device)
    return upscale_full(flow, params, full_h, full_w)


def dis_flow_timed(im_a, im_b, params: DISParams, full_w: int, full_h: int,
                   init_flow=None, device="cuda") -> torch.Tensor:
    """The verbosity-2 path: `dis_flow` with each stage run to completion
    and timed, printing the pyramid's and the grid set-up's lines and the
    reference's per-scale six-column breakdown (oflow.cpp:297):

      TIME (Sc: i, #p: n, pconst, pinit, poptim, cflow, tvopt, total): ...

    The lines are the host times of the call's spans (`trace`), each
    stage ending in a `torch.cuda.synchronize` on the card. The computation
    is `dis_flow`'s, warm start included, so the flow equals its flow bit
    for bit: (H/2^sc_l, W/2^sc_l, nop)."""
    dev = resolve_device(device)
    with trace.call(settle=dev) as c:
        a = _as_batch(im_a, dev)[None]
        b = _as_batch(im_b, dev)[None]
        flow = _dis_flow_core(a, b, params, full_w, full_h,
                              _as_init(init_flow, dev))[0]
    ms = {s.name: (s.end_ns - s.start_ns) / 1e6 for s in trace.spans(c.id)}
    print("TIME (Pyramide+Gradients) (ms): %3g" % ms["pyramid"])
    print("TIME (Grid Memo. Alloc. ) (ms): %3g" % ms["grid"])
    for sl in range(params.sc_f, params.sc_l - 1, -1):
        laps = [ms[f"L{sl}.{stage}"] for stage in STAGES]
        print("TIME (Sc: %i, #p:%6i, pconst, pinit, poptim, cflow, tvopt, "
              "total): %8.2f %8.2f %8.2f %8.2f %8.2f -> %8.2f ms."
              % (sl, make_level_spec(sl, full_w, full_h, params).nopatches,
                 *laps, sum(laps)))
    return flow


@trace.entry
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
    flow = _upscale(_dis_flow_core(a, b, params, full_w, full_h), params,
                    full_h, full_w)
    if channels_last:
        return flow
    return flow.movedim(3, 1)


def warm_start_from_full(flow_full: torch.Tensor, sc_f: int) -> torch.Tensor:
    """A full-resolution flow (..., H, W, nop) as the warm-start input
    (..., H/2^(sc_f+1), W/2^(sc_f+1), nop) (run_dense.cpp:373-376): cropped
    to a multiple of k = 2^(sc_f+1), values times 1/k, then the k x k box
    mean (cv::INTER_AREA at this integer factor). Plain torch on the flow's
    device; the box sums accumulate in float64 and round once, so a
    stream's carry does not depend on the streams beside it (a float32
    sum's order follows the tensor's shape on CUDA)."""
    k = 2 ** (sc_f + 1)
    h, w, c = flow_full.shape[-3:]
    t = trace.begin("carry")
    f = flow_full[..., : (h // k) * k, : (w // k) * k, :] * (1.0 / k)
    f = f.reshape(*flow_full.shape[:-3], h // k, k, w // k, k, c)
    carry = (f.sum(dim=(-4, -2), dtype=torch.float64) / (k * k)).to(
        torch.float32)
    trace.end("carry", t)
    return carry


@trace.entry
def dis_sequence(frames, params: DISParams, full_w: int, full_h: int,
                 device="cuda") -> torch.Tensor:
    """Sequence mode: flow for the consecutive pairs of one video, each
    pair warm-started from the previous pair's flow (the reference's
    commented-out initialization-flow input, run_dense.cpp:356-379,
    oflow.cpp:215-217), the first from zero.

    frames: (T, C, H, W) divisibility-padded to 2^(sc_f+1). Returns
    (T-1, H, W, nop) full-resolution flow."""
    dev = resolve_device(device)
    frames = _as_batch(frames, dev)
    carry = warm_carry_init(1, params, full_w, full_h, device=dev)[0]
    flows = []
    for t in range(frames.shape[0] - 1):
        flow = dis_flow_full(frames[t], frames[t + 1], params, full_w,
                             full_h, init_flow=carry, device=dev)
        carry = warm_start_from_full(flow, params.sc_f)
        flows.append(flow)
    return torch.stack(flows)


def _warm_step(im_a: torch.Tensor, im_b: torch.Tensor, params: DISParams,
               full_w: int, full_h: int, carry: torch.Tensor):
    """One warm-started step over S streams: the (S, C, H, W) pair batch
    and each stream's carry -> ((S, H, W, nop) full-resolution flow, the
    next carry). The upscale is kernel K4 on CUDA, as in
    `dis_flow_batched`."""
    flow = _upscale(_dis_flow_core(im_a, im_b, params, full_w, full_h,
                                   init_flow=carry), params, full_h, full_w)
    return flow, warm_start_from_full(flow, params.sc_f)


def warm_carry_init(s: int, params: DISParams, full_w: int, full_h: int,
                    device="cuda") -> torch.Tensor:
    """The zero warm-start carry of S streams (the cold start of a chain;
    oflow.cpp:215-217 with no initial flow): (S, H/2^(sc_f+1),
    W/2^(sc_f+1), nop) float32."""
    k = 2 ** (params.sc_f + 1)
    return torch.zeros((s, full_h // k, full_w // k, params.nop),
                       dtype=torch.float32, device=resolve_device(device))


@trace.entry
def dis_step_warm(im_a, im_b, params: DISParams, full_w: int, full_h: int,
                  carry, device="cuda"):
    """One step of the S-stream warm-start loop, for serving loops that
    cannot hold whole videos: the pairs (S, C, H, W) of S streams and
    their carry (start from `warm_carry_init`) -> ((S, H, W, nop) flow,
    the next carry). A loop of it equals `dis_sequence_batched`."""
    dev = resolve_device(device)
    return _warm_step(_as_batch(im_a, dev), _as_batch(im_b, dev), params,
                      full_w, full_h, _as_batch(carry, dev))


@trace.entry
def dis_sequence_batched(frames, params: DISParams, full_w: int, full_h: int,
                         device="cuda") -> torch.Tensor:
    """Batched sequence mode: S video streams advance in lockstep, each
    pair warm-started from its stream's previous flow (the per-step batch
    keeps the card busy while the loop carries the warm starts).

    frames: (T, S, C, H, W) divisibility-padded to 2^(sc_f+1). Returns
    (T-1, S, H, W, nop) full-resolution flow."""
    dev = resolve_device(device)
    frames = _as_batch(frames, dev)
    carry = warm_carry_init(frames.shape[1], params, full_w, full_h,
                            device=dev)
    flows = []
    for t in range(frames.shape[0] - 1):
        flow, carry = _warm_step(frames[t], frames[t + 1], params, full_w,
                                 full_h, carry)
        flows.append(flow)
    return torch.stack(flows)
