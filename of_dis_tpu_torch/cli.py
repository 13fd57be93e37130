"""Command line of the port, mirroring the reference's binaries.

Modes: run_OF_INT / run_OF_RGB (optical flow from gray / colour input,
writes .flo), run_DE_INT / run_DE_RGB (depth from a stereo pair: the left
camera's disparity, writes .pfm), run_OF_GRD / run_DE_GRD (the same on the
gradient magnitude of the gray input, kept as float).

Usage (reference: README.md:46-86, run_dense.cpp:186-295):

  python -m of_dis_tpu_torch.cli run_OF_INT img1 img2 out.flo            # op-point 2
  python -m of_dis_tpu_torch.cli run_OF_INT img1 img2 out.flo 1          # op-point 1
  python -m of_dis_tpu_torch.cli run_OF_INT img1 img2 out.flo \
      lv_f lv_l maxiter miniter mindprate mindrrate minimgerr patchsz poverl \
      usefbcon patnorm costfct tvref tv_alpha tv_gamma tv_delta tv_innerit \
      tv_solverit tv_sor verbosity                                 # 20 params

Flags: `--quiet` silences the op-point form's default verbosity;
`--device cuda|cpu` picks the device (default cuda; there is no silent
fallback to the CPU). `--init-flow` raises NotImplementedError.
Verbosity > 0 prints the total flow time; verbosity > 1 (the op-point
form's default) also the load, pyramid, grid and save times and, per
scale, the reference's six-column line (`models.dis.dis_flow_timed`)
`TIME (Sc: i, #p: n, pconst, pinit, poptim, cflow, tvopt, total)`; its
flow equals the one written at verbosity 0 bit for bit.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import pyramid
from of_dis_tpu_torch.params import DISParams, op_point_params, pad_amounts
from of_dis_tpu_torch.utils import io

_MODES = ("run_OF_INT", "run_OF_RGB", "run_DE_INT", "run_DE_RGB",
          "run_OF_GRD", "run_DE_GRD")


def parse_args(argv):
    mode = argv[0]
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode}")
    nop = 2 if "OF" in mode else 1
    noc = 3 if "RGB" in mode else 1
    img1, img2, outfile = argv[1], argv[2], argv[3]
    rest = list(argv[4:])
    if "--init-flow" in rest:
        raise NotImplementedError(
            "--init-flow is not ported yet (ROADMAP queue 1, item 14)")
    device = "cuda"
    if "--device" in rest:
        k = rest.index("--device")
        device = rest[k + 1]
        del rest[k:k + 2]
    quiet = "--quiet" in rest
    if quiet:
        rest.remove("--quiet")
    return mode, nop, noc, img1, img2, outfile, rest, quiet, device


def build_params(width_org, nop, noc, rest) -> DISParams:
    if len(rest) <= 1:  # op-point form (run_dense.cpp:226-268)
        sel = int(rest[0]) if rest else 2
        return op_point_params(width_org, sel, nop=nop, noc=noc, verbosity=2)
    # explicit 20-parameter form (run_dense.cpp:270-295)
    (lv_f, lv_l, maxit, minit, mindp, mindr, minerr, psz, pov, fb, pn, cf,
     tvref, a, g, d, innerit, solverit, sor, verb) = rest[:20]
    return DISParams(
        sc_f=int(lv_f), sc_l=int(lv_l), max_iter=int(maxit),
        min_iter=int(minit), dp_thresh=float(mindp), dr_thresh=float(mindr),
        res_thresh=float(minerr), p_samp_s=int(psz), patove=float(pov),
        usefbcon=bool(int(fb)), patnorm=int(pn), costfct=int(cf),
        usetvref=bool(int(tvref)), tv_alpha=float(a), tv_gamma=float(g),
        tv_delta=float(d), tv_innerit=int(innerit),
        tv_solverit=int(solverit), tv_sor=float(sor), verbosity=int(verb),
        nop=nop, noc=noc)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    t0 = time.perf_counter()
    mode, nop, noc, img1p, img2p, outfile, rest, quiet, device = \
        parse_args(argv)
    dev = dis.resolve_device(device)

    img1 = io.load_image(img1p, channels=noc)
    img2 = io.load_image(img2p, channels=noc)
    if "GRD" in mode:
        # gradient-magnitude input (run_dense.cpp:139-148): not
        # integer-valued, stays float32
        img1 = pyramid.gradient_magnitude(torch.as_tensor(img1))
        img2 = pyramid.gradient_magnitude(torch.as_tensor(img2))
    else:
        # 8-bit sources are integer-valued: ship u8, as the reference
        # reads CV_8U
        img1 = torch.as_tensor(img1.astype(np.uint8))
        img2 = torch.as_tensor(img2.astype(np.uint8))
    h_org, w_org = img1.shape[1], img1.shape[2]

    params = build_params(w_org, nop, noc, rest)
    if quiet:
        params = dataclasses.replace(params, verbosity=0)
    verb = params.verbosity

    # divisibility padding (run_dense.cpp:299-311)
    a = pyramid.pad_to_divisible(img1, params.sc_f)
    b = pyramid.pad_to_divisible(img2, params.sc_f)
    full_h, full_w = a.shape[1], a.shape[2]
    top, _, left, _ = pad_amounts(w_org, h_org, params.sc_f)
    if verb > 1:
        print(f"TIME (Image loading     ) (ms): "
              f"{(time.perf_counter() - t0) * 1e3:3g}")

    t_run = time.perf_counter()
    if verb > 1:
        # staged path printing the per-scale six-column breakdown
        flow = dis.dis_flow_timed(a, b, params, full_w, full_h, device=dev)
        flow = dis.upscale_full(flow, params, full_h, full_w)
    else:
        flow = dis.dis_flow_full(a, b, params, full_w, full_h, device=dev)
    flow = flow.cpu().numpy()
    if verb > 0:
        print(f"TIME (O.Flow Run-Time   ) (ms): "
              f"{(time.perf_counter() - t_run) * 1e3:3g}")
    t0 = time.perf_counter()

    # crop divisibility padding (run_dense.cpp:415)
    flow = flow[top:top + h_org, left:left + w_org]
    if nop == 2:
        io.write_flo(outfile, flow)
    else:
        io.write_pfm(outfile, flow[:, :, 0])
    if verb > 1:
        print(f"TIME (Saving flow file  ) (ms): "
              f"{(time.perf_counter() - t0) * 1e3:3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
