"""One level's TV refinement split into its parts, on the card: the
counterpart of the JAX package's `tools/bench_tv_parts.py`.

At [batch] [level] of an op-point's call, on the inputs the full call
hands that level's `_tv_refine` (`bench_stages.run_stages` on the
synthetic pairs of `tools/synth.py`), times

  - the warp (K3, `kernels.warp.warp_image_batched`);
  - the 5-tap derivative stack (plain torch, `ops.tv.get_derivatives`
    and the stack of its eight fields: ~160 small kernels on the card);
  - the fixed-point loop (K2, `tv_of_inner.of_inner`; with --depth K5,
    `tv_de_inner.de_inner`);
  - the whole `models.dis._tv_refine` (the de-padding copies included),

each alone: CUDA events around K back-to-back calls after a warm-up
call (on the CPU the host clock; where the host launches slower than the
card runs, this is the host's time), then, once every part is timed, on
the card each part's device time and kernel count from one profiled
call. The parts chained equal
`_tv_refine` bit for bit (`parts`). The last line gives the derivative
stack's share of the level, by both times.

Usage: python -m of_dis_tpu_torch.tools.bench_tv_parts [batch] [level]
           [--op 2] [--depth] [--reps 8] [--device cuda|cpu]
(batch 64, level 3 by default: op-2's finest level.)
"""

from __future__ import annotations

import argparse
from typing import Callable, NamedTuple

import torch

from of_dis_tpu_torch.kernels import tv_de_inner, tv_of_inner, warp
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import tv
from of_dis_tpu_torch.tools import bench, bench_stages, profile_pipeline


class Parts(NamedTuple):
    """A level's TV refinement as callables on their real inputs."""
    warp: tuple          # (fn, args)
    derivs: tuple
    inner: tuple
    full: tuple
    compose: Callable    # () -> the level's refined flow, from the parts


def derivative_stack(im1, w_im2):
    """The (B, 8, C, H, W) stack the TV loops read
    (`ops.tv._warp_and_derivatives` without the warp)."""
    return torch.stack(tv.get_derivatives(im1, w_im2), dim=1)


def parts(flow, im_a, im_b, spec, params) -> Parts:
    """`dis._tv_refine(flow, im_a, im_b, spec, params)` split into its
    parts, each with its inputs (computed once here)."""
    pad = spec.pad
    im1 = im_a[:, :, pad:-pad, pad:-pad].contiguous()
    im2 = im_b[:, :, pad:-pad, pad:-pad].contiguous()
    wx = flow[..., 0].contiguous()
    wy = (flow[..., 1].contiguous() if params.nop == 2
          else torch.zeros_like(wx))
    qa, hd3, hg3 = tv.tv_coefficients(params.tv_alpha, params.tv_gamma,
                                      params.tv_delta)
    kw = dict(quarter_alpha=qa, hd3=hd3, hg3=hg3,
              n_inner=params.tv_innerit * (spec.level + 1),
              n_solver=params.tv_solverit, omega=params.tv_sor)
    w_im2, mask = warp.warp_image_batched(im2, wx, wy)
    deriv = derivative_stack(im1, w_im2)
    if params.nop == 2:
        def inner(wx, wy, mask, deriv):
            return tv_of_inner.of_inner(wx, wy, mask, deriv, **kw)
        inner_args = (wx, wy, mask, deriv)
    else:
        def inner(wx, mask, deriv):
            return tv_de_inner.de_inner(wx, mask, deriv, camlr=spec.camlr,
                                        **kw)
        inner_args = (wx, mask, deriv)

    def compose():
        w2, m = warp.warp_image_batched(im2, wx, wy)
        d = derivative_stack(im1, w2)
        if params.nop == 2:
            return torch.stack(inner(wx, wy, m, d), dim=-1)
        return inner(wx, m, d)[..., None]

    return Parts(warp=(warp.warp_image_batched, (im2, wx, wy)),
                 derivs=(derivative_stack, (im1, w_im2)),
                 inner=(inner, inner_args),
                 full=(dis._tv_refine, (flow, im_a, im_b, spec, params)),
                 compose=compose)


def level_inputs(batch: int, level: int, op: int, nop: int, device, h: int,
                 w: int):
    """The arguments (flow, im_a, im_b, spec, params) that one call of
    `dis_flow_batched` on synthetic pairs hands `_tv_refine` at
    `level`."""
    a, b, params = bench_stages.flow_pairs(batch, op, device, h, w, nop)
    _, stages = bench_stages.run_stages(a, b, params, a.shape[-1],
                                        a.shape[-2])
    for s in stages:
        if s.level == level and s.fn is dis._tv_refine:
            return s.args
    raise ValueError(f"op-point {op} refines no level {level} (levels "
                     f"{params.sc_f}..{params.sc_l}, TV "
                     f"{'on' if params.usetvref else 'off'})")


def main(argv=None, h: int = bench.H, w: int = bench.W) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=64)
    ap.add_argument("level", type=int, nargs="?", default=3)
    ap.add_argument("--op", type=int, default=2)
    ap.add_argument("--depth", action="store_true",
                    help="depth pairs (K5) in place of flow (K2)")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dis.resolve_device(args.device)
    nop = 1 if args.depth else 2
    flow, im_a, im_b, spec, params = level_inputs(
        args.batch, args.level, args.op, nop, dev, h, w)
    p = parts(flow, im_a, im_b, spec, params)
    print(f"op{args.op} {'depth' if args.depth else 'flow'} L{spec.level} "
          f"{spec.height}x{spec.width} B={args.batch} n_inner="
          f"{params.tv_innerit * (spec.level + 1)} on {dev}, {args.reps} "
          "reps")
    names = {"warp": "warp (K3)", "derivs": "derivative stack (plain torch)",
             "inner": f"inner loop ({'K5' if args.depth else 'K2'})",
             "full": "full _tv_refine"}
    ms = {key: bench_stages.time_ms(*getattr(p, key), args.reps, dev)
          for key in names}
    device = {}
    for key, label in names.items():
        extra = ""
        if dev.type == "cuda":
            fn, fargs = getattr(p, key)
            evs = profile_pipeline.events(profile_pipeline.profile(
                lambda: fn(*fargs), dev), "cuda")
            device[key] = sum(e.dur_us for e in evs) / 1e3
            extra = f"  device {device[key]:8.3f} ms, {len(evs):3d} kernels"
        print(f"{label:34s} {ms[key]:9.3f} ms/step "
              f"({ms[key] / args.batch * 1e3:8.1f} us/pair){extra}",
              flush=True)
    share = (f", {device['derivs'] / device['full']:.3f} of its device "
             "time" if device else "")
    print(f"derivative stack: {ms['derivs'] / ms['full']:.3f} of the "
          f"level's full _tv_refine{share}")
    return dict(ms=ms, device_ms=device)


if __name__ == "__main__":
    main()
