"""Per-stage times of the port's batched pipeline on the card: the
counterpart of the JAX package's `tools/bench_stages.py`.

`run_stages` runs one `dis_flow_batched` call (no merge, no warm start)
stage by stage, as `models.dis._dis_flow_core` chains them: the pyramids;
per level, coarse to fine, `extract_templates` (levels whose GN kernel
reads templates: K1's), the start parameters, the GN loop
(`optimize_level_batched`: K1, or K6 with its templates built in the
kernel), the densification and `_tv_refine` (K3, the derivative stack,
K2 or K5); then the upscale (K4). Its result equals `dis_flow_batched`'s
bit for bit, and it records each stage with the inputs the full call
hands it. Each stage is then timed alone on those inputs: CUDA events
around K back-to-back calls after one warm-up call (on the CPU the host
clock), and one line printed per stage,

  {stage:44s} ... ms/step (... us/pair)

then the stages' sum beside the whole call timed the same way.

Usage: python -m of_dis_tpu_torch.tools.bench_stages [batch] [--op 2]
           [--reps 8] [--device cuda|cpu]
on B Sintel-sized 1024x436 gray u8 flow pairs of `tools/synth.py`
(batch 64 by default: the main path).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, NamedTuple

import torch

from of_dis_tpu_torch.kernels import upscale
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import densify, patch_solver, pyramid
from of_dis_tpu_torch.params import make_level_spec, op_point_params
from of_dis_tpu_torch.tools import bench, synth


class Stage(NamedTuple):
    name: str
    level: int          # -1: before and after the levels
    fn: Callable
    args: tuple


def run_stages(im_a, im_b, params, full_w: int, full_h: int):
    """One call's stages on padded (B, C, H, W) pairs, in order: returns
    (the flow (B, H, W, nop), equal to `dis_flow_batched`'s, and the list
    of Stage, each with the inputs the call gave it)."""
    if params.usefbcon:
        raise ValueError("run_stages: the forward-backward merge is not "
                         "staged")
    stages: List[Stage] = []

    def stage(name, level, fn, *args):
        stages.append(Stage(name, level, fn, args))
        return fn(*args)

    pad = params.p_samp_s

    def pyramids(a, b):
        return (pyramid.build_pyramid(a, params.sc_f, pad, lv_l=params.sc_l),
                pyramid.build_pyramid(b, params.sc_f, pad, getgrad=False,
                                      lv_l=params.sc_l))

    (ims_a, dxs_a, dys_a), (ims_b, _, _) = stage(
        f"pyramids (sc_f={params.sc_f}, grads)", -1, pyramids, im_a, im_b)
    batch, dev = im_a.shape[0], im_a.device
    flow = None
    for sl in range(params.sc_f, params.sc_l - 1, -1):
        spec = make_level_spec(sl, full_w, full_h, params)
        src = (ims_a[sl], dxs_a[sl], dys_a[sl])
        ib = ims_b[sl]
        n = spec.nopatches
        tpl = None
        if patch_solver.builds_templates(spec, params):
            gn = "gn_tiled"
        else:
            gn = ("bilerp_extract" if patch_solver.uses_unfused(params)
                  else "gn_fused")
            tpl = stage(f"L{sl} extract_templates (n={n})", sl,
                        patch_solver.extract_templates, spec, params, *src)
        p_init = stage(f"L{sl} start parameters", sl, dis._p_init, spec,
                       params, flow, batch, dev)
        res = stage(f"L{sl} GN {gn} ({params.max_iter} it)", sl,
                    patch_solver.optimize_level_batched, spec, params, ib,
                    tpl, p_init, src)
        flow = stage(f"L{sl} densify", sl, densify.aggregate_flow_dense,
                     spec, params, res)
        if params.usetvref:
            n_inner = params.tv_innerit * (sl + 1)
            flow = stage(f"L{sl} tv_refine (inner={n_inner})", sl,
                         dis._tv_refine, flow, ims_a[sl], ib, spec, params)
    if params.sc_l:
        flow = stage(f"upscale x{2 ** params.sc_l} to full", -1,
                     upscale.upscale_batched, flow.contiguous(), params.sc_l,
                     full_h, full_w)
    return flow, stages


def time_ms(fn, args, reps: int, device) -> float:
    """ms a call of fn(*args): CUDA events around `reps` back-to-back
    calls after one warm-up call (the host clock on the CPU)."""
    fn(*args)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def line(name: str, ms: float, batch: int) -> str:
    return f"{name:44s} {ms:9.3f} ms/step ({ms / batch * 1e3:8.1f} us/pair)"


def flow_pairs(batch: int, op: int, device, h: int, w: int, nop: int = 2):
    """Padded synthetic u8 pairs of `tools/synth.py` (flow, or depth with
    nop=1) and their op-point's parameters."""
    params = op_point_params(w, op, nop=nop, noc=1)
    field = synth.flow_field if nop == 2 else synth.disparity_field
    a8, b8, _, _ = synth.make_pairs(batch, h, w, bench.SEED, device,
                                    field=field)
    return (pyramid.pad_to_divisible(a8, params.sc_f),
            pyramid.pad_to_divisible(b8, params.sc_f), params)


def main(argv=None, h: int = bench.H, w: int = bench.W) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=64)
    ap.add_argument("--op", type=int, default=2)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dis.resolve_device(args.device)
    a, b, params = flow_pairs(args.batch, args.op, dev, h, w)
    fh, fw = a.shape[-2], a.shape[-1]
    _, stages = run_stages(a, b, params, fw, fh)
    print(f"op{args.op} B={args.batch} {w}x{h} on {dev}, {args.reps} reps")
    times = {}
    for s in stages:
        times[s.name] = time_ms(s.fn, s.args, args.reps, dev)
        print(line(s.name, times[s.name], args.batch), flush=True)
    total = time_ms(lambda: dis.dis_flow_batched(a, b, params, fw, fh,
                                                 device=dev), (), args.reps,
                    dev)
    print(line("sum of the stages", sum(times.values()), args.batch))
    print(line("dis_flow_batched", total, args.batch))
    return dict(stages_ms=times, call_ms=total)


if __name__ == "__main__":
    main()
