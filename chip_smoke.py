"""On-card smoke test of the PyTorch / CUDA port (`of_dis_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: CUDA present, the `nvidia-smi` name / power-limit line;
  2. build: every kernel of `of_dis_tpu_torch/csrc/` compiled with nvcc for
     sm_90a, one process per source, all at once;
  3. per path (see PATHS: at op-point 2 A gray flow, B gray depth, C RGB
     flow, D RGB depth, G gray flow with the forward-backward merge; E
     op-point 3 and F op-point 4 gray flow; H gray flow at patch size 16
     through the 20-parameter form, the unfused GN route; Sintel 1024x436
     padded to 1024x448): each kernel against its plain PyTorch twin on
     the card, on the inputs the path hands it (the whole batch), with
     kernel / plain / library times and the bound the card could reach;
     on paths A, E and F every GN level is also timed on both fused
     routes (templates gathered by plain torch plus `gn_fused`, against
     `gn_tiled`), the measurement behind `patch_solver.TILED_MIN_PATCHES`;
  4. per path, end to end: `dis_flow_batched`, launch counts of every
     kernel (asserted), the result against the known synthetic field and
     against the plain path, pairs/s, one profile with the busy share; the
     merge's result equal to the bit between two calls;
  5. the single-pair TV entries `ops.tv.ref_level_of` / `ref_level_de` on
     pair 0 of the finest level of paths A and B: launch counts, against
     their twins, and equal to row 0 of the batched result;
  6. the compiled-reference goldens through the port's `cli.main` on the
     card (all fifteen: six modes at op-2, op-1, op-3 in five modes, op-4,
     the merge for flow and depth, the TV-free pseudo-Huber run), and the
     op-2 and op-4 gray-flow goldens again at the CLI's default verbosity 2:
     the per-scale lines printed, the file equal to the quiet one;
  7. the tensor-core dot microbenchmark (T1): `tools.bench_i8_dot` at its
     defaults, launches counted, both products equal to their exact twin,
     times beside the bound and one PyTorch product of the same function;
  8. the per-stage ablation of the GN iteration (T2): `tools
     .bench_gn_stages` at op-2's finest level (batch 384) and at op-4's
     level 0 (batch 4), launches counted, every stage against its twin,
     every variant equal to A4 bit for bit, times beside the large-level GN
     kernel's level-0 time of path F;
  9. one `{"kernels": [...]}` JSON line, the `nvidia-smi` line, and as the
     last line `{"ok": true, "device": {...}}`.

Synthetic pairs follow the JAX package's bench workload (a blurred random
frame, backward-warped by a smooth subpixel field, both frames rounded to
u8), generated on the card from a seed. Flow pairs move by a field of mean
~(2.5, 1.0) px; stereo pairs shift horizontally only, by a disparity in
[-4.6, -1.4] px (the left camera's disparity is <= 0).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io as io_mod
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from of_dis_tpu_torch import cli
from of_dis_tpu_torch.kernels import (bilerp_extract, build, gn_fused,
                                      gn_stages, gn_tiled, i8_dot,
                                      tv_de_inner, tv_of_inner, upscale,
                                      warp)
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import patch_solver, pyramid, tv
from of_dis_tpu_torch.params import op_point_params
from of_dis_tpu_torch.tools import bench_gn_stages, bench_i8_dot
from of_dis_tpu_torch.utils import io

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "of_dis_tpu_torch", "smoke")

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# FLOP/s outside the tensor cores, for every kernel of the flow path
# (float32 CUDA-core work); the dense tensor-core rates without sparsity
# for the dot microbenchmark (T1): int8 OP/s and bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12

H_ORG, W_ORG = 436, 1024
# The paths driven end to end, each with its expected launches per
# `dis_flow_batched` call. op-2: three levels (5..3), one final upscale.
# op-3: five levels (5..1), of which levels 3 to 1 run the large-level GN
# kernel. op-4: six levels (5..0), levels 3..0 on the large-level kernel,
# and no upscale (the last level is full resolution). The merge (fbcon)
# runs a second GN per level and a backward TV at all but the last level.
# `plain_pairs`: pairs of the kernel-path / plain-path comparison; `routes`:
# time every GN level on both fused routes; `args`: the CLI's 20-parameter
# form in place of an op-point; `at_least`: kernels whose launch count
# depends on the data (one extraction at the start of a level and one per
# trip), with the fewest launches a call must show.
PATHS = [
    dict(name="A", what="flow, gray", op=2, nop=2, noc=1, batch=64,
         routes=True,
         launches={"gn_fused": 3, "tv_of_inner": 3, "warp": 3, "upscale": 1}),
    dict(name="B", what="depth, gray", op=2, nop=1, noc=1, batch=64,
         launches={"gn_fused": 3, "tv_de_inner": 3, "warp": 3, "upscale": 1}),
    dict(name="C", what="flow, RGB", op=2, nop=2, noc=3, batch=64,
         launches={"gn_fused": 3, "tv_of_inner": 3, "warp": 3, "upscale": 1}),
    dict(name="D", what="depth, RGB", op=2, nop=1, noc=3, batch=16,
         launches={"gn_fused": 3, "tv_de_inner": 3, "warp": 3, "upscale": 1}),
    dict(name="E", what="flow, gray, op-3", op=3, nop=2, noc=1, batch=16,
         plain_pairs=2, routes=True,
         launches={"gn_fused": 2, "gn_tiled": 3, "tv_of_inner": 5, "warp": 5,
                   "upscale": 1}),
    dict(name="F", what="flow, gray, op-4", op=4, nop=2, noc=1, batch=4,
         plain_pairs=2, routes=True,
         launches={"gn_fused": 2, "gn_tiled": 4, "tv_of_inner": 6,
                   "warp": 6}),
    dict(name="G", what="flow, gray, forward-backward merge", op=2, nop=2,
         noc=1, batch=64, fbcon=True,
         launches={"gn_fused": 6, "tv_of_inner": 5, "warp": 5, "upscale": 1}),
    # op-3's settings (16 trips, overlap 0.75, TV on) at patch size 16,
    # levels 4..1: 256 pixels a patch, more than a warp of either GN
    # kernel holds, so every level takes the unfused route
    dict(name="H", what="flow, gray, patch size 16 (20-parameter form)",
         op=None, args="4 1 16 16 0.05 0.95 0 16 0.75 0 1 0 1 10 10 5 1 3 "
         "1.6 0", nop=2, noc=1, batch=4, plain_pairs=2,
         launches={"tv_of_inner": 4, "warp": 4, "upscale": 1},
         at_least={"bilerp_extract": 8}),
]
# name -> where the main path looks the wrapper up (`entry`), the module
# and attribute of its launch count, its source and the TPU kernel(s) it
# replaces.
KERNELS = {
    "gn_fused": dict(module=gn_fused, entry=(gn_fused, "gn_fused"),
                     counter="launches",
                     source="of_dis_tpu_torch/csrc/gn_fused.cu",
                     replaces="of_dis_tpu/ops/patch_solver.py:584",
                     tpu_kernels=["of_dis_tpu/ops/patch_solver.py:584 "
                                  "_gn_fused_pallas"]),
    "gn_tiled": dict(module=gn_tiled, entry=(gn_tiled, "gn_tiled"),
                     counter="launches",
                     source="of_dis_tpu_torch/csrc/gn_tiled.cu",
                     replaces="of_dis_tpu/ops/patch_solver.py:1228",
                     tpu_kernels=["of_dis_tpu/ops/patch_solver.py:1228 "
                                  "_gn_tiled_pallas"]),
    "bilerp_extract": dict(module=bilerp_extract,
                           entry=(bilerp_extract, "bilerp_extract"),
                           counter="launches",
                           source="of_dis_tpu_torch/csrc/bilerp_extract.cu",
                           replaces="of_dis_tpu/ops/patch_solver.py:312",
                           tpu_kernels=["of_dis_tpu/ops/patch_solver.py:312 "
                                        "_bilerp_select_pallas"]),
    "tv_of_inner": dict(module=tv_of_inner,
                        entry=(tv_of_inner, "of_inner"), counter="launches",
                        source="of_dis_tpu_torch/csrc/tv_of_inner.cu",
                        replaces="of_dis_tpu/ops/tv.py:1153",
                        tpu_kernels=["of_dis_tpu/ops/tv.py:1153 "
                                     "_of_inner_pallas_batched"]),
    "tv_of_inner_single": dict(module=tv_of_inner,
                               entry=(tv_of_inner, "of_inner_single"),
                               counter="launches_single",
                               source="of_dis_tpu_torch/csrc/tv_of_inner.cu",
                               replaces="of_dis_tpu/ops/tv.py:1092",
                               tpu_kernels=["of_dis_tpu/ops/tv.py:1092 "
                                            "_of_inner_pallas"]),
    "tv_de_inner": dict(module=tv_de_inner,
                        entry=(tv_de_inner, "de_inner"), counter="launches",
                        source="of_dis_tpu_torch/csrc/tv_de_inner.cu",
                        replaces="of_dis_tpu/ops/tv.py:1224",
                        tpu_kernels=["of_dis_tpu/ops/tv.py:1224 "
                                     "_de_inner_pallas_batched"]),
    "tv_de_inner_single": dict(module=tv_de_inner,
                               entry=(tv_de_inner, "de_inner_single"),
                               counter="launches_single",
                               source="of_dis_tpu_torch/csrc/tv_de_inner.cu",
                               replaces="of_dis_tpu/ops/tv.py:1332",
                               tpu_kernels=["of_dis_tpu/ops/tv.py:1332 "
                                            "_de_inner_pallas"]),
    "warp": dict(module=warp, entry=(tv, "warp_image_batched"),
                 counter="launches",
                 source="of_dis_tpu_torch/csrc/warp.cu",
                 replaces="of_dis_tpu/ops/tv.py:271",
                 tpu_kernels=["of_dis_tpu/ops/tv.py:271 "
                              "warp_image_banded_pallas",
                              "of_dis_tpu/ops/tv.py:106 _warp_coeffs_pallas"]),
    "upscale": dict(module=upscale, entry=(upscale, "upscale_batched"),
                    counter="launches",
                    source="of_dis_tpu_torch/csrc/upscale.cu",
                    replaces="of_dis_tpu/models/dis.py:206",
                    tpu_kernels=["of_dis_tpu/models/dis.py:206 "
                                 "_upscale_cf_pallas"]),
    # the measurement tools' kernels (phases 7 and 8)
    "i8_dot": dict(module=i8_dot, entry=(i8_dot, "dot_sum"),
                   counter="launches",
                   source="of_dis_tpu_torch/csrc/i8_dot.cu",
                   replaces="tools/bench_i8_dot.py:36",
                   tpu_kernels=["tools/bench_i8_dot.py:36 main.make"]),
    "gn_stages": dict(module=gn_stages, entry=(gn_stages, "gn_stages"),
                      counter="launches",
                      source="of_dis_tpu_torch/csrc/gn_stages.cu",
                      replaces="tools/bench_gn_stages.py:103",
                      tpu_kernels=["tools/bench_gn_stages.py:103 "
                                   "main.make"]),
}
# Tolerances of kernel against plain twin, with their reasons.
TOL = {
    # px: the twin sums each patch in the kernel's order, so the two agree
    # to rounding; 12 dependent Gauss-Newton trips amplify what is left
    "gn_fused": 1e-3,
    # px: as gn_fused, the template mean and the Hessian summed in the
    # kernel's order too; up to 128 dependent trips at op-4
    "gn_tiled": 1e-3,
    # 0-255 scale: the twin's three float32 lerps term by term
    "bilerp_extract": 1e-4,
    # px: the same float32 formulas; the only freedom is rounding of the
    # compiler's division / square root, carried through the SOR sweeps
    "tv_of_inner": 1e-4,
    "tv_of_inner_single": 1e-4,
    # px: as tv_of_inner, one unknown
    "tv_de_inner": 1e-4,
    "tv_de_inner_single": 1e-4,
    # 0-255 scale: the same four-term float32 lerp; a few ulps at 255
    "warp": 1e-4,
    # px: two taps against the matrix product's sum over every input
    # column, float32 rounding of ~20 px values
    "upscale": 1e-4,
    # every value a small integer: both products exact, in any order
    "i8_dot": 0.0,
    # relative to the stage's largest checksum: the twin sums in the
    # kernel's order with the same float32 operations (no contraction), so
    # 0 is expected; the margin covers a division or gather that rounds
    # otherwise
    "gn_stages": 1e-6,
}
# pweight of the GN kernel: relative to the level's largest weight
# (a residual moves by p's float32 difference times the image gradient)
PWEIGHT_REL_TOL = 1e-4


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, inner: int) -> float:
    """Median over `reps` samples of the CUDA-event time of `inner`
    back-to-back calls of fn, per call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, peak: float = F32_FLOP_PER_S):
    """(bound_ms, bytes_ms, ops_ms) of work on the H100's published peaks;
    `peak` is the rate of the operations' type (float32 by default)."""
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = flops / peak * 1e3
    return max(b_ms, o_ms), b_ms, o_ms


# ------------------------------------------------------ synthetic workload

def _flow_field(h, w, device):
    """Smooth subpixel motion (px): affine ramp plus sinusoids, mean
    ~(2.5, 1.0), +-~1.5 px across the frame."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    u = (2.5 + 0.8 * torch.sin(2 * math.pi * yy / 180.0)
         + 0.5 * torch.cos(2 * math.pi * xx / 260.0) + 0.4 * (xx / w - 0.5))
    v = (1.0 + 0.7 * torch.sin(2 * math.pi * xx / 210.0)
         + 0.4 * (yy / h - 0.5)).expand(h, w)
    return u.expand(h, w), v


def _disparity_field(h, w, device):
    """Smooth horizontal-only stereo shift (px), negative everywhere (the
    left camera's disparity): -3 -+ 1.6, no vertical component."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    d = -(3.0 + 1.0 * torch.sin(2 * math.pi * yy / 180.0)
          + 0.6 * torch.cos(2 * math.pi * xx / 260.0))
    return d.expand(h, w), torch.zeros((h, w), device=device)


def _blur7(x):
    """7-tap Gaussian blur, sigma 2, reflect-101 borders, on (..., H, W)."""
    t = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-t * t / 8.0)
    k /= k.sum()
    for dim in (-1, -2):
        n = x.shape[dim]
        idx = torch.arange(-3, n + 3, device=x.device).abs()
        idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        p = x.index_select(dim, idx)
        x = sum(float(k[j]) * p.narrow(dim, j, n) for j in range(7))
    return x


def _remap(img, mx, my):
    """Bilinear backward warp of (B, C, H, W) at (mx, my), edge clamp."""
    b, c, h, w = img.shape
    x0 = mx.floor().long().clamp(0, w - 1)
    y0 = my.floor().long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = (mx - x0).clamp(0.0, 1.0)
    fy = (my - y0).clamp(0.0, 1.0)
    flat = img.reshape(b * c, h * w)

    def g(yy, xx):
        return flat[:, (yy * w + xx).reshape(-1)].reshape(b, c, h, w)

    return ((1 - fy) * ((1 - fx) * g(y0, x0) + fx * g(y0, x1))
            + fy * ((1 - fx) * g(y1, x0) + fx * g(y1, x1)))


def make_pairs(batch, h, w, seed, device, channels=1, field=_flow_field):
    """u8 frame pairs (B, channels, h, w), each channel an independent
    blurred random frame, and the true field (u, v) that moves the first
    frame of a pair onto the second."""
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.random((batch, channels, h, w),
                                      dtype=np.float32),
                           device=device) * 255.0
    base = _blur7(base)
    u, v = field(h, w, device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    shifted = _remap(base, xx - u, yy - v)

    def to_u8(x):
        return x.round().clamp(0, 255).to(torch.uint8)

    return to_u8(base), to_u8(shifted), u, v


# ---------------------------------------------- kernel inputs of the path

@contextlib.contextmanager
def swapped(make):
    """Replace each kernel's wrapper, where the main path looks it up, by
    make(name, wrapper); yields the wrappers and restores them on exit."""
    saved = {name: getattr(*k["entry"]) for name, k in KERNELS.items()}
    for name, k in KERNELS.items():
        setattr(*k["entry"], make(name, saved[name]))
    try:
        yield saved
    finally:
        for name, k in KERNELS.items():
            setattr(*k["entry"], saved[name])


def _recorder(calls):
    """make() for `swapped`: record each call's arguments in calls[name],
    then call through to the wrapper."""
    def make(name, fn):
        def wrapped(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return wrapped
    return make


def _single(plain):
    """The twin of a single-pair entry: the batched twin at B = 1."""
    def fn(*args, **kw):
        out = plain(*(a[None] for a in args), **kw)
        return out[0] if torch.is_tensor(out) else tuple(o[0] for o in out)
    return fn


# each kernel's plain twin, with its wrapper's signature: routes the main
# path through the twins on whatever device the tensors are
PLAIN = {
    "gn_fused": lambda *args: patch_solver._gn_plain(*args)[:3],
    "gn_tiled": lambda *args: patch_solver._gn_tiled_plain(*args)[:3],
    "bilerp_extract": patch_solver.extract_bilinear,
    "tv_of_inner": tv_of_inner._plain,
    "tv_of_inner_single": _single(tv_of_inner._plain),
    "tv_de_inner": tv_de_inner._plain,
    "tv_de_inner_single": _single(tv_de_inner._plain),
    "warp": tv.warp_image,
    "upscale": dis.upscale_output,
    "i8_dot": i8_dot._plain,
    "gn_stages": gn_stages._plain,
}


def reset_launches():
    for k in KERNELS.values():
        setattr(k["module"], k["counter"], 0)


def read_launches():
    """Launch counts since the last reset, kernels never launched left
    out."""
    counts = {name: getattr(k["module"], k["counter"])
              for name, k in KERNELS.items()}
    return {name: n for name, n in counts.items() if n}


# ------------------------------------------------- per-kernel comparisons

def check_gn(name, args, kernel_fn):
    """One GN call against its twin. `gn_fused` takes materialised
    templates (spec, params, im_b, tpl, p_init_t, pt_ref_t), `gn_tiled`
    the source planes in their place."""
    spec, params, im_b, tpl_or_src, p_init_t, pt_ref_t = args
    twin = (patch_solver._gn_plain if name == "gn_fused"
            else patch_solver._gn_tiled_plain)
    p_k, pw_k, it_k = kernel_fn(*args)
    p_p, pw_p, it_p, trips = twin(*args)
    torch.cuda.synchronize()
    err = float((p_k - p_p).abs().max())
    pw_err = float((pw_k - pw_p).abs().max()) / float(pw_p.abs().max())
    if int(it_k) != int(it_p):
        raise AssertionError(f"{name} iters {int(it_k)} != plain "
                             f"{int(it_p)} at level {spec.level}")
    if not (err <= TOL[name] and pw_err <= PWEIGHT_REL_TOL):
        raise AssertionError(f"{name} level {spec.level}: p err {err}, "
                             f"pweight rel err {pw_err}")
    b, c, hp, wp = im_b.shape
    n, nop = spec.nopatches, params.nop
    d = params.novals
    nh = 3 if nop == 2 else 1
    # trips are the ones this run's data needed
    n_trips = float(trips.sum())
    # outputs written once: p, the channel-summed pweight, iters; inputs
    # read once: the target planes, p_init, pt_ref and the templates
    nbytes = 4 * (b * c * hp * wp + nop * b * n + 2 * n
                  + nop * b * n + b * (d // c) * n + 1)
    if name == "gn_fused":
        # tmpl, tdx and for flow tdy, and the Hessians
        nbytes += 4 * ((1 + nop) * b * d * n + nh * b * n)
        # per element: 15 flops per extraction (9 bilinear, 2
        # mean-normalise, 3 residual / weight / clamp, 1 residual sum), one
        # extraction at the start and one per trip, plus 2 per trip and
        # projection (two for flow, one for depth)
        flops = d * (15.0 * (b * n + n_trips) + 2.0 * nop * n_trips)
    else:
        # the source image and its x- (for flow also y-) gradient planes
        nbytes += 4 * (1 + nop) * b * c * hp * wp
        # as gn_fused, with the projections taken inside every error
        # evaluation, one more extraction for the weight after the loop,
        # and per patch the template mean (2 per element) and the Hessian
        # entries (2 each)
        flops = d * (15.0 * (2 * b * n + n_trips)
                     + 2.0 * nop * (b * n + n_trips)
                     + (2.0 + 2.0 * nh) * b * n)
    return dict(
        shape=f"B{b} N{n} D{d} nop{nop} planes {c}x{hp}x{wp}",
        max_abs_err=err, pweight_rel_err=pw_err, iters=int(it_k),
        twin_pairs=b, trips=n_trips,
        kernel_ms=cuda_ms(lambda: kernel_fn(*args), 5, 10),
        plain_ms=cuda_ms(lambda: twin(*args), 2, 1),
        library_ms=None, bound=bound(nbytes, flops))


def check_routes(label, spec, params, im_b, src, p_init):
    """One GN level on both fused routes, for the routing rule
    (`patch_solver.uses_tiled`): templates gathered into device memory by
    plain torch and then `gn_fused`, against `gn_tiled` on the source
    planes. Prints the two times and how far their results lie apart."""
    pt_ref_t = patch_solver.grid_ref_points(spec, im_b.device).T[None] \
        .contiguous()
    p_init_t = p_init.transpose(1, 2).contiguous()

    def fused_route():
        tpl = patch_solver.extract_templates(spec, params, *src)
        return gn_fused.gn_fused(spec, params, im_b, tpl, p_init_t, pt_ref_t)

    def tiled_route():
        return gn_tiled.gn_tiled(spec, params, im_b, src, p_init_t, pt_ref_t)

    diff = float((fused_route()[0] - tiled_route()[0]).abs().max())
    print(json.dumps({
        "path": label, "routes_level": spec.level, "grid": spec.camlr,
        "patches": spec.nopatches, "batch": im_b.shape[0],
        "psz": params.p_samp_s, "trips": params.max_iter,
        "uses_tiled": patch_solver.uses_tiled(spec),
        "fused_route_ms": cuda_ms(fused_route, 3, 2),
        "tiled_route_ms": cuda_ms(tiled_route, 3, 2),
        "routes_max_abs_diff": diff}), flush=True)


def check_extract(args, kernel_fn):
    """One patch extraction against its twin."""
    im, pts, psz, pad = args
    o_k = kernel_fn(*args)
    o_p = patch_solver.extract_bilinear(*args)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    if not (o_k.shape == o_p.shape and err <= TOL["bilerp_extract"]):
        raise AssertionError(f"bilerp_extract {tuple(o_k.shape)}: err {err}")
    b, c, hp, wp = im.shape
    n = pts.shape[1]
    d = psz * psz * c
    # library yardstick: grid_sample at every tap position of every patch,
    # pt - psz/2 + pad + (i, j) in the padded planes, a (B, psz^2, N, 2)
    # grid built outside the timing; its output (B, C, psz^2, N). It
    # differs from the kernel where the kernel's anchor ceil(pt + 1e-5)
    # lands one pixel left (integer positions from 256 on, where 1e-5 is
    # below half an ulp) and beyond the planes (it clamps the coordinate,
    # the kernel each tap)
    jj, ii = (t.reshape(-1).to(im.device, torch.float32) for t in
              torch.meshgrid(torch.arange(psz), torch.arange(psz),
                             indexing="ij"))
    base = pts + float(pad - psz // 2)                    # (B, N, 2)
    gx = (base[:, None, :, 0] + ii[None, :, None]) * (2.0 / (wp - 1)) - 1.0
    gy = (base[:, None, :, 1] + jj[None, :, None]) * (2.0 / (hp - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    lib = lambda: F.grid_sample(im, grid, mode="bilinear",  # noqa: E731
                                padding_mode="border", align_corners=True)
    lib_diff = float((lib().permute(0, 2, 1, 3).reshape(b, d, n)
                      - o_p).abs().max()) if c == 1 else None
    # planes and positions read once, the patches written once; per element
    # two y-lerps and one x-lerp of three operations each
    nbytes = 4 * (b * c * hp * wp + 2 * b * n + b * d * n)
    flops = 9.0 * b * d * n
    return dict(
        shape=f"B{b} N{n} D{d} planes {c}x{hp}x{wp}", max_abs_err=err,
        library_max_abs_diff=lib_diff,
        kernel_ms=cuda_ms(lambda: kernel_fn(*args), 5, 10),
        plain_ms=cuda_ms(lambda: patch_solver.extract_bilinear(*args), 2, 1),
        library_ms=cuda_ms(lib, 5, 10), bound=bound(nbytes, flops))


def tv_flops_per_px(name, n_solver, colour, noc):
    """Float operations per pixel and inner iteration of a TV loop, as the
    kernel does them. Flow: smoothness 18, data term 64 gray / 212 RGB
    (44 / 136 without the colour term), sub_laplacian and the hoisted SOR
    terms 23, uu/vv 2, and 24 per SOR sweep (each pixel updated once per
    sweep). Depth: smoothness 10, data term 53 gray / 143 RGB (34 / 94),
    sub_laplacian and the hoisted term 15, uu and its clamp 2, and 11 per
    sweep."""
    if name.startswith("tv_of"):
        data = {1: (64, 44), 3: (212, 136)}[noc][0 if colour else 1]
        return 18 + data + 23 + 2 + 24 * n_solver
    data = {1: (53, 34), 3: (143, 94)}[noc][0 if colour else 1]
    return 10 + data + 15 + 2 + 11 * n_solver


def check_tv(name, args, kw, kernel_fn):
    """One TV entry (flow or depth, batched or single pair) against its
    twin. args = (wx, [wy,] mask, deriv), unbatched for a single entry."""
    def tup(out):
        return (out,) if torch.is_tensor(out) else tuple(out)

    wx, deriv = args[0], args[-1]
    out_k = tup(kernel_fn(*args, **kw))
    plain = lambda: PLAIN[name](*args, **kw)  # noqa: E731
    out_p = tup(plain())
    torch.cuda.synchronize()
    err = max(float((k - p).abs().max()) for k, p in zip(out_k, out_p))
    if not err <= TOL[name]:
        raise AssertionError(f"{name} {tuple(wx.shape)}: err {err}")
    h, w = wx.shape[-2:]
    b = wx.shape[0] if wx.ndim == 3 else 1
    noc = deriv.shape[-3]
    # inputs wx, [wy,] mask and 8 derivative planes per channel read once,
    # outputs uu [, vv] written once
    nbytes = 4 * b * h * w * (len(args) - 1 + 8 * noc + len(out_k))
    flops = b * h * w * kw["n_inner"] * tv_flops_per_px(
        name, kw["n_solver"], bool(kw["hd3"]), noc)
    return dict(
        shape=f"B{b} C{noc} {h}x{w} n_inner {kw['n_inner']}",
        max_abs_err=err,
        kernel_ms=cuda_ms(lambda: kernel_fn(*args, **kw), 5, 10),
        plain_ms=cuda_ms(plain, 2, 1), library_ms=None,
        bound=bound(nbytes, flops))


def check_warp(args, kernel_fn):
    src, wx, wy = args
    o_k, m_k = kernel_fn(*args)
    o_p, m_p = tv.warp_image(*args)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    if not (err <= TOL["warp"] and torch.equal(m_k, m_p)):
        raise AssertionError(f"warp {tuple(src.shape)}: err {err}, masks "
                             f"equal {torch.equal(m_k, m_p)}")
    b, c, h, w = src.shape
    # library yardstick: grid_sample with border padding at the same
    # absolute positions (no mask); the grid is built outside the timing
    gy = torch.arange(h, dtype=torch.float32, device=src.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=src.device)[None, :]
    grid = torch.stack([(gx + wx) * (2.0 / (w - 1)) - 1.0,
                        (gy + wy) * (2.0 / (h - 1)) - 1.0], dim=-1)
    lib = lambda: F.grid_sample(src, grid, mode="bilinear",  # noqa: E731
                                padding_mode="border", align_corners=True)
    lib_diff = float((lib() - o_p).abs().max())
    nbytes = 4 * b * h * w * (2 * c + 3)
    flops = b * h * w * (10 + 13 * c)
    return dict(
        shape=f"B{b} C{c} {h}x{w}", max_abs_err=err,
        library_max_abs_diff=lib_diff,
        kernel_ms=cuda_ms(lambda: kernel_fn(*args), 5, 10),
        plain_ms=cuda_ms(lambda: tv.warp_image(*args), 5, 5),
        library_ms=cuda_ms(lib, 5, 10), bound=bound(nbytes, flops))


def check_upscale(args, kernel_fn):
    flow, sc_l, out_h, out_w = args
    o_k = kernel_fn(*args)
    o_p = dis.upscale_output(*args)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    if not err <= TOL["upscale"]:
        raise AssertionError(f"upscale {tuple(flow.shape)}: err {err}")
    b, h, w, nop = flow.shape
    # library yardstick: one bilinear interpolate of the pre-scaled planar
    # flow (half-pixel centres, edge clamp = INTER_LINEAR)
    f_cf = (flow * float(2 ** sc_l)).movedim(-1, 1).contiguous()
    lib = lambda: F.interpolate(f_cf, size=(out_h, out_w),  # noqa: E731
                                mode="bilinear", align_corners=False)
    lib_diff = float((lib().movedim(1, -1) - o_p).abs().max())
    nbytes = 4 * nop * (b * h * w + b * out_h * out_w) + 16 * (out_h + out_w)
    flops = 6.0 * nop * b * out_h * out_w
    return dict(
        shape=f"B{b} {h}x{w}x{nop} -> {out_h}x{out_w}",
        max_abs_err=err, library_max_abs_diff=lib_diff,
        kernel_ms=cuda_ms(lambda: kernel_fn(*args), 5, 10),
        plain_ms=cuda_ms(lambda: dis.upscale_output(*args), 5, 5),
        library_ms=cuda_ms(lib, 5, 10), bound=bound(nbytes, flops))


def profile_call(label, fn, wall_s: float, top: int = 12) -> None:
    """Device time by kernel over one call under torch.profiler, and the
    device's busy share of the call's unprofiled wall time `wall_s` (one
    stream: kernels do not overlap, so their sum is the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(json.dumps({"profile": label, "device_busy_ms": busy_ms,
                      "wall_ms": wall_s * 1e3,
                      "busy_share": busy_ms / (wall_s * 1e3),
                      "kernels": len(rows),
                      "launches": sum(r[1] for r in rows)}), flush=True)
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3:9.4f} ms {count:5d}x  {key[:90]}")


def epe_ratio(ours, ref):
    """Mean end-point error over the reference's mean magnitude, over the
    trailing parameter axis (2 for flow, 1 for depth)."""
    d = torch.linalg.vector_norm(ours - ref, dim=-1)
    return float(d.mean() / torch.linalg.vector_norm(ref, dim=-1).mean())


CHECKS = {"gn_fused": lambda name, args, kw, fn: check_gn(name, args, fn),
          "gn_tiled": lambda name, args, kw, fn: check_gn(name, args, fn),
          "bilerp_extract": lambda name, args, kw, fn: check_extract(args, fn),
          "warp": lambda name, args, kw, fn: check_warp(args, fn),
          "upscale": lambda name, args, kw, fn: check_upscale(args, fn)}


def call_level(name, args, full_w, finest):
    """The pyramid level of a recorded call, and for a GN call the grid
    (camlr 1 is the merge's backward grid): from the level spec of a GN
    call, from the field width of a TV or warp call; the upscale follows
    the finest level."""
    if name.startswith("gn_"):
        return args[0].level, args[0].camlr
    if name == "upscale":
        return finest, 0
    if name == "bilerp_extract":
        # (im, pts, psz, pad): the padded planes' width
        width = args[0].shape[-1] - 2 * args[3]
        return int(round(math.log2(full_w / width))), 0
    return int(round(math.log2(full_w / args[0].shape[-1]))), 0


def check_calls(label, calls, wrappers, rows, full_w, finest):
    """Hold every recorded call of every kernel against its twin, time it,
    print one JSON line per call and append the rows to rows[name]."""
    for name, recorded in calls.items():
        seen = {}
        for args, kw in recorded:
            r = CHECKS.get(name, check_tv)(name, args, kw, wrappers[name])
            b_ms, by_ms, op_ms = r.pop("bound")
            r.update(bound_ms=b_ms, bytes_ms=by_ms, ops_ms=op_ms)
            rows[name].append(r)
            level, _ = call_level(name, args, full_w, finest)
            # with the merge a level's second call is the backward grid's;
            # the extraction runs many times a level: its calls are numbered
            seen[level] = seen.get(level, 0) + 1
            if name == "bilerp_extract":
                grid = f"call {seen[level]}"
            else:
                grid = "forward" if seen[level] == 1 else "backward"
            # each recorded call is one launch of the kernel on the path
            print(json.dumps({"path": label, "kernel": name, "level": level,
                              "grid": grid, "launches": 1,
                              "tolerance": TOL[name], **r}), flush=True)


def launches_as_expected(counts, cfg) -> bool:
    """Whether one call's launch counts are the path's: exact for every
    kernel but those of `at_least`, which must reach their floor."""
    floor = cfg.get("at_least", {})
    exact = {name: n for name, n in counts.items() if name not in floor}
    return exact == cfg["launches"] and all(
        counts.get(name, 0) >= n for name, n in floor.items())


def run_path(cfg, dev, rows, totals):
    """Phases 3 and 4 for one path. Returns the recorded inputs and result
    of the finest level's batched TV call, for the single-pair phase, and
    that level."""
    label, nop, noc, batch = cfg["name"], cfg["nop"], cfg["noc"], cfg["batch"]
    op = cfg["op"]
    if op is None:
        params = cli.build_params(W_ORG, nop, noc, cfg["args"].split())
    else:
        params = op_point_params(W_ORG, op, nop=nop, noc=noc)
    if cfg.get("fbcon"):
        params = dataclasses.replace(params, usefbcon=True)
    t0 = time.perf_counter()
    field = _flow_field if nop == 2 else _disparity_field
    a_u8, b_u8, u_true, v_true = make_pairs(batch, H_ORG, W_ORG, 0, dev,
                                            channels=noc, field=field)
    im_a = pyramid.pad_to_divisible(a_u8, params.sc_f)
    im_b = pyramid.pad_to_divisible(b_u8, params.sc_f)
    full_h, full_w = im_a.shape[2], im_a.shape[3]
    torch.cuda.synchronize()
    print(f"path {label} ({cfg['what']}, nop={nop}, noc={noc}): {batch} x "
          f"{noc}x{H_ORG}x{W_ORG} u8 -> padded {full_h}x{full_w} in "
          f"{time.perf_counter() - t0:.2f} s; levels {params.sc_f}.."
          f"{params.sc_l}", flush=True)

    def run(a=im_a, b=im_b):
        return dis.dis_flow_batched(a, b, params, full_w, full_h, device=dev)

    # 3. each kernel against its plain twin on the path's inputs; the
    # batched TV entry's inputs and result are kept for phase 5
    tv_entry = "ref_level_of_batched" if nop == 2 else "ref_level_de_batched"
    tv_fn = getattr(tv, tv_entry)
    tv_calls = []

    def tv_recorded(*args, **kw):
        out = tv_fn(*args, **kw)
        tv_calls.append((args, kw, out))
        return out

    gn_level = patch_solver.optimize_level_batched
    gn_levels = []

    def gn_recorded(spec, prm, target, tpl, p_init, src=None):
        gn_levels.append((spec, prm, target, src, p_init))
        return gn_level(spec, prm, target, tpl, p_init, src=src)

    calls = {name: [] for name in KERNELS}
    setattr(tv, tv_entry, tv_recorded)
    patch_solver.optimize_level_batched = gn_recorded
    try:
        with swapped(_recorder(calls)) as wrappers:
            run()
    finally:
        setattr(tv, tv_entry, tv_fn)
        patch_solver.optimize_level_batched = gn_level
    torch.cuda.synchronize()
    recorded = {name: len(c) for name, c in calls.items() if c}
    if not launches_as_expected(recorded, cfg):
        raise AssertionError(f"path {label}: calls {recorded}, expected "
                             f"{cfg['launches']}, at least "
                             f"{cfg.get('at_least', {})}")
    first = {name: len(rs) for name, rs in rows.items()}
    check_calls(label, calls, wrappers, rows, full_w, params.sc_l)
    if cfg.get("routes"):
        for level_args in gn_levels:
            check_routes(label, *level_args)
    del gn_levels

    # 4. end to end, counted
    reset_launches()
    flow = run()
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"path {label}: launches in one dis_flow_batched call: "
          f"{json.dumps(launches)}", flush=True)
    if not launches_as_expected(launches, cfg):
        raise AssertionError(f"path {label}: launches {launches} != expected "
                             f"{cfg['launches']}, at least "
                             f"{cfg.get('at_least', {})}")
    for name, n in launches.items():
        totals[name] = totals.get(name, 0) + n
    if tuple(flow.shape) != (batch, full_h, full_w, nop) or \
            not bool(torch.isfinite(flow).all()):
        raise AssertionError(f"flow shape {tuple(flow.shape)} or non-finite")
    top = (full_h - H_ORG) // 2
    # interior, away from the border where the warp's clamp rules
    crop = flow[:, top + 32:top + H_ORG - 32, 32:W_ORG - 32]
    true = torch.stack([u_true, v_true], -1)[32:-32, 32:-32, :nop]
    med = crop.reshape(-1, nop).median(dim=0).values
    med_true = true.reshape(-1, nop).median(dim=0).values
    epe_true = float(torch.linalg.vector_norm(crop - true, dim=-1).mean())
    print(f"path {label}: median {med.tolist()} vs true {med_true.tolist()}; "
          f"mean EPE vs the true field {epe_true:.4f} px", flush=True)
    # op-2 stops at 1/8 resolution (op-3 at 1/2, op-4 at full);
    # tests/test_torch_dis.py holds the JAX reference to the same limits
    # on this workload at op-2
    if float((med - med_true).abs().max()) > 0.25 or epe_true > 0.6:
        raise AssertionError(f"path {label}: result does not follow the "
                             "synthetic field")
    if nop == 1 and float(flow.max()) > 0.0:
        raise AssertionError(f"path {label}: positive disparity "
                             f"{float(flow.max())} for the left camera")
    if cfg.get("fbcon") and not torch.equal(flow, run()):
        raise AssertionError(f"path {label}: two calls with the merge differ")
    few = cfg.get("plain_pairs", 4)
    with swapped(lambda name, _: PLAIN[name]):
        ref4 = run(im_a[:few], im_b[:few])
    ours4 = run(im_a[:few], im_b[:few])
    ratio = epe_ratio(ours4, ref4)
    print(f"path {label}: EPE ratio, kernel path vs plain path on the card, "
          f"{few} pairs: {ratio:.3e}", flush=True)
    if not ratio < 1e-3:
        raise AssertionError(f"path {label}: kernel path EPE ratio {ratio} "
                             ">= 1e-3")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(json.dumps({"e2e": "dis_flow_batched", "path": label, "op": op,
                      "fbcon": bool(cfg.get("fbcon")),
                      "nop": nop, "noc": noc, "batch": batch,
                      "size": f"{W_ORG}x{H_ORG}", "wall_s": walls,
                      "median_wall_s": wall, "pairs_per_s": batch / wall}),
          flush=True)
    profile_call(f"dis_flow_batched path {label}", run, wall)
    # per kernel, summed over its calls in this path's run
    print(json.dumps({"path": label, "kernel_ms": {
        name: {key: sum(r[key] for r in rs[first[name]:])
               for key in ("kernel_ms", "plain_ms", "bound_ms")}
        for name, rs in rows.items() if len(rs) > first[name]}}), flush=True)
    return tv_calls[-1], params.sc_l


def run_single(label, finest, rows, totals):
    """Phase 5 for one path: the single-pair TV entry on pair 0 of the
    finest level's recorded inputs."""
    (args, kw, batched), level = finest
    flow_path = len(args) == 4                 # (wx, wy, im1, im2)
    entry = tv.ref_level_of if flow_path else tv.ref_level_de
    name = "tv_of_inner_single" if flow_path else "tv_de_inner_single"
    pair0 = tuple(a[0].contiguous() for a in args)
    expected = {name: 1, "warp": 1}
    calls = {n: [] for n in KERNELS}
    with swapped(_recorder(calls)) as wrappers:
        entry(*pair0, **kw)
    check_calls(label + "'", {n: calls[n] for n in expected}, wrappers, rows,
                W_ORG, level)
    reset_launches()
    out = entry(*pair0, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"path {label}': launches in one {entry.__name__} call: "
          f"{json.dumps(launches)}", flush=True)
    if launches != expected:
        raise AssertionError(f"path {label}': launches {launches} != "
                             f"expected {expected}")
    for kernel, n in launches.items():
        totals[kernel] = totals.get(kernel, 0) + n
    outs = (out,) if torch.is_tensor(out) else out
    rows0 = (batched,) if torch.is_tensor(batched) else batched
    for o, r in zip(outs, rows0):
        if o.shape != r.shape[1:] or not torch.equal(o, r[0]):
            raise AssertionError(f"{entry.__name__} differs from row 0 of "
                                 "the batched result")
    print(f"path {label}': {entry.__name__} on one {tuple(outs[0].shape)} "
          "pair equals row 0 of the batched result", flush=True)


# The explicit 20-parameter forms of the merge and TV-free goldens
# (tests/test_golden_parity.py): levels 3..1, 12 trips, patch size 8,
# overlap 0.4, then usefbcon, patnorm, costfct, usetvref.
_FB = "3 1 12 12 0.05 0.95 0 8 0.4 1 1 {cost} 1 10 10 5 1 3 1.6 0"
_HUBER_NOTV = "3 1 12 12 0.05 0.95 0 8 0.4 0 1 2 0 10 10 5 1 3 1.6 0"
# (mode, first image, second image, golden, trailing arguments, budget):
# the budgets of tests/test_golden_parity.py
GOLDENS = [
    ("run_OF_INT", "a.png", "b.png", "of_int_op1.flo", "1", 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_op2.flo", "2", 1e-2),
    ("run_OF_RGB", "ac.png", "bc.png", "of_rgb_op2.flo", "2", 1e-2),
    ("run_OF_GRD", "a.png", "b.png", "of_grd_op2.flo", "2", 1e-2),
    ("run_DE_INT", "a.png", "bs.png", "de_int_op2.pfm", "2", 1e-2),
    ("run_DE_RGB", "asc.png", "bsc.png", "de_rgb_op2.pfm", "2", 1e-2),
    ("run_DE_GRD", "a.png", "bs.png", "de_grd_op2.pfm", "2", 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_op3.flo", "3", 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_op4.flo", "4", 1e-2),
    ("run_OF_RGB", "ac.png", "bc.png", "of_rgb_op3.flo", "3", 1e-2),
    ("run_OF_GRD", "a.png", "b.png", "of_grd_op3.flo", "3", 1e-2),
    ("run_DE_INT", "a.png", "bs.png", "de_int_op3.pfm", "3", 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_l1_fb.flo",
     _FB.format(cost=1), 1e-2),
    ("run_DE_INT", "a.png", "bs.png", "de_int_l2_fb.pfm",
     _FB.format(cost=0), 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_huber_notv.flo", _HUBER_NOTV,
     1e-3),
]


def run_goldens():
    """Phase 6: the compiled reference's outputs through `cli.main`."""
    os.makedirs(OUT_DIR, exist_ok=True)
    gold = os.path.join(ROOT, "tests", "goldens")
    for mode, img1, img2, golden, args, budget in GOLDENS:
        out = os.path.join(OUT_DIR, golden)
        reset_launches()
        cli.main([mode, os.path.join(gold, img1), os.path.join(gold, img2),
                  out] + args.split() + ["--quiet"])
        launches = read_launches()
        if golden.endswith(".flo"):
            ours, ref = io.read_flo(out), io.read_flo(
                os.path.join(gold, golden))
        else:
            ours, ref = (io.read_pfm(f)[..., None]
                         for f in (out, os.path.join(gold, golden)))
        r = epe_ratio(torch.as_tensor(ours.copy()),
                      torch.as_tensor(ref.copy()))
        print(f"golden {golden} ({mode}): EPE ratio {r:.3e} (budget "
              f"{budget:g}); launches {json.dumps(launches)}", flush=True)
        if not r < budget:
            raise AssertionError(f"golden {golden} EPE ratio {r}")
        # op-3 / op-4: the 192x160 frame's finest level holds 3,456 patches
        if args in ("3", "4") and not launches.get("gn_tiled"):
            raise AssertionError(f"golden {golden}: the finest level did "
                                 "not run gn_tiled")


# goldens run again at the CLI's default verbosity 2 (no --quiet)
VERBOSE_GOLDENS = ("of_int_op2.flo", "of_int_op4.flo")


def run_verbose_goldens():
    """Phase 6, second part: `cli.main` at verbosity 2 prints one
    per-scale line a level and writes the file written quietly above."""
    gold = os.path.join(ROOT, "tests", "goldens")
    for mode, img1, img2, golden, args, _ in GOLDENS:
        if golden not in VERBOSE_GOLDENS:
            continue
        out = os.path.join(OUT_DIR, "verbose_" + golden)
        text = io_mod.StringIO()
        with contextlib.redirect_stdout(text):
            cli.main([mode, os.path.join(gold, img1),
                      os.path.join(gold, img2), out] + args.split())
        lines = text.getvalue().splitlines()
        print("\n".join(f"  {ln}" for ln in lines), flush=True)
        params = cli.build_params(192, 2, 1, args.split())
        scales = sum(ln.startswith("TIME (Sc: ") for ln in lines)
        if scales != params.sc_f - params.sc_l + 1:
            raise AssertionError(f"verbose golden {golden}: {scales} "
                                 "per-scale lines")
        quiet = io.read_flo(os.path.join(OUT_DIR, golden))
        if not np.array_equal(io.read_flo(out), quiet):
            raise AssertionError(f"verbose golden {golden}: the file "
                                 "differs from the quiet one")
        print(f"golden {golden} at verbosity 2: {scales} per-scale lines, "
              "the file equal to the quiet one", flush=True)


# ------------------------------------------------- the measurement tools

def run_i8_dot(dev, rows, totals):
    """Phase 7: the dot microbenchmark's main path (the tool at its
    defaults, launches counted), then both products against the twin,
    timed beside the bound and one PyTorch product of the same function:
    A repeated reps times along k times B's reps blocks stacked along k."""
    reset_launches()
    res = bench_i8_dot.main(["--device", str(dev)])
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"i8_dot: launches in one run of the tool: {json.dumps(launches)}",
          flush=True)
    if set(launches) != {"i8_dot"}:
        raise AssertionError(f"i8_dot tool launches {launches}")
    totals["i8_dot"] = totals.get("i8_dot", 0) + launches["i8_dot"]
    reps, grid, m, k, n = 64, 64, 832, 256, 256
    inputs = bench_i8_dot.make_inputs(reps, m, k, n, dev)
    for dtype, peak, label in ((torch.int8, INT8_OP_PER_S, "int8 -> int32"),
                               (torch.bfloat16, BF16_FLOP_PER_S,
                                "bf16 -> f32")):
        a, bt = inputs[dtype]
        out = i8_dot.dot_sum(a, bt, n, grid)
        twin = i8_dot._plain(a, bt, n, grid)
        err = float((out.double() - twin.double()).abs().max())
        if not (torch.equal(out, twin) and torch.equal(res[label]["out"],
                                                       twin)):
            raise AssertionError(f"i8_dot {label}: not the exact product "
                                 f"(max abs err {err})")
        # B's blocks stacked along k, (reps k, n), column-major (k
        # contiguous), the layout of cuBLAS's integer tensor-core products
        a_rep = a.repeat(1, reps)
        b_stack = bt.reshape(reps, n, k).transpose(0, 1).reshape(
            n, reps * k).t()
        if dtype == torch.int8:
            lib = lambda: [torch._int_mm(a_rep, b_stack)  # noqa: E731
                           for _ in range(grid)]
        else:
            lib = lambda: [torch.matmul(a_rep, b_stack)  # noqa: E731
                           for _ in range(grid)]
        lib_diff = float((lib()[0].double() - twin[0].double()).abs().max())
        ops = 2.0 * m * k * n * reps * grid
        esize = a.element_size()
        nbytes = esize * (m * k + reps * n * k) + 4 * grid * m * n
        r = dict(shape=f"{label} ({m}, {k}) @ ({k}, {n}) x {reps} reps x "
                 f"{grid}", max_abs_err=err, library_max_abs_diff=lib_diff,
                 kernel_ms=cuda_ms(lambda: i8_dot.dot_sum(a, bt, n, grid),
                                   5, 3),
                 plain_ms=cuda_ms(lambda: i8_dot._plain(a, bt, n, grid), 3,
                                  1),
                 library_ms=cuda_ms(lib, 5, 1))
        r["tops"] = ops / r["kernel_ms"] / 1e9
        r["library_tops"] = ops / r["library_ms"] / 1e9
        b_ms, by_ms, op_ms = bound(nbytes, ops, peak)
        r.update(bound_ms=b_ms, bytes_ms=by_ms, ops_ms=op_ms)
        rows["i8_dot"].append(r)
        print(json.dumps({"tool": "bench_i8_dot", "kernel": "i8_dot",
                          "tolerance": TOL["i8_dot"], **r}), flush=True)


def gn_stages_flops(stage: str, b: int, n: int, psz: int,
                    max_iter: int) -> float:
    """Float operations of one `gn_stages` call, as the kernel does them:
    per pixel and trip W 4 (three tap sums, one accumulation), A3 10 (nine
    for the bilinear, one accumulation), A4 18 (the bilinear, the patch
    sum, the residual's two subtractions, |.|, the three accumulations:
    1 + 2 + 2); A4 also a division a patch and trip for the mean and, once
    a patch, the division and two additions at the end."""
    per_px = {"W": 4, "A3": 10, "A4": 18}[stage]
    ops = float(b) * n * max_iter * psz * psz * per_px
    if stage == "A4":
        ops += float(b) * n * (max_iter + 3)
    return ops


def run_gn_stages(dev, rows, totals):
    """Phase 8: the GN stage ablation's main path (the tool at both
    geometries, launches counted), then every stage against its twin on
    the card and every variant against A4, timed; at op4-l0 beside the
    large-level GN kernel's level-0 time of path F (51,300 patches, batch
    4)."""
    reset_launches()
    results = {g: bench_gn_stages.main(["--geometry", g, "--device",
                                        str(dev)])
               for g in ("op2-l3", "op4-l0")}
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"gn_stages: launches in one run of the tool at both geometries: "
          f"{json.dumps(launches)}", flush=True)
    if set(launches) != {"gn_stages"}:
        raise AssertionError(f"gn_stages tool launches {launches}")
    totals["gn_stages"] = totals.get("gn_stages", 0) + launches["gn_stages"]
    if not all(r["equal_a4"] for res in results.values() for r in res
               if r["variant"]):
        raise AssertionError("gn_stages: a variant differs from A4")
    k6_l0 = [r["kernel_ms"] for r in rows["gn_tiled"]
             if r["shape"].startswith("B4 N51300 ")]
    for gname in results:
        geom = bench_gn_stages.GEOMETRIES[gname]
        b, n, psz = geom.batch, geom.n, geom.psz
        x = bench_gn_stages.make_inputs(geom, b, dev)
        a4 = None
        for label, stage, variant in bench_gn_stages.RUNS:
            args = bench_gn_stages.call_args(x, geom, stage, variant)
            out = gn_stages.gn_stages(*args)
            twin = gn_stages._plain(*args)
            torch.cuda.synchronize()
            err = float((out - twin).abs().max())
            scale = float(twin.abs().max())
            if not err <= TOL["gn_stages"] * scale:
                raise AssertionError(f"gn_stages {gname} {label}: err {err} "
                                     f"of checksums up to {scale}")
            if stage == "A4" and not variant:
                a4 = out
            if variant and not torch.equal(out, a4):
                raise AssertionError(f"gn_stages {gname} {label} != A4")
            # planes, the anchors and the checksums
            nbytes = (args[0].numel() * args[0].element_size()
                      + 4 * 2 * b * n + 4 * b * n)
            if stage == "A4":
                nbytes += 4 * 3 * b * n * psz * psz
            r = dict(shape=f"{gname} {label} B{b} N{n} psz{psz} "
                     f"trips{geom.max_iter}", max_abs_err=err,
                     max_abs_checksum=scale,
                     kernel_ms=cuda_ms(lambda: gn_stages.gn_stages(*args), 5,
                                       3),
                     plain_ms=cuda_ms(lambda: gn_stages._plain(*args), 1, 1),
                     library_ms=None)
            r["us_per_pair"] = r["kernel_ms"] * 1e3 / b
            b_ms, by_ms, op_ms = bound(nbytes, gn_stages_flops(
                stage, b, n, psz, geom.max_iter))
            r.update(bound_ms=b_ms, bytes_ms=by_ms, ops_ms=op_ms)
            rows["gn_stages"].append(r)
            print(json.dumps({"tool": "bench_gn_stages",
                              "kernel": "gn_stages",
                              "tolerance": TOL["gn_stages"], **r}),
                  flush=True)
        if gname == "op4-l0" and k6_l0:
            print(f"gn_tiled (K6) at level 0 of path F, the same 51,300 "
                  f"patches x 4 pairs and 128 trips: {k6_l0[0]:.3f} ms = "
                  f"{k6_l0[0] * 1e3 / 4:.1f} us per pair", flush=True)


# -------------------------------------------------------------------- main

def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = dis.resolve_device("cuda")

    # 2. build
    t0 = time.perf_counter()
    reports = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(reports)} "
          "kernels", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3-4. every path; 5. the single-pair entries on paths A and B
    rows = {name: [] for name in KERNELS}
    totals = {}
    finest = {cfg["name"]: run_path(cfg, dev, rows, totals) for cfg in PATHS}
    for label in ("A", "B"):
        run_single(label, finest[label], rows, totals)

    # 6. goldens through the CLI on the card, quiet and at verbosity 2
    run_goldens()
    run_verbose_goldens()

    # 7-8. the measurement tools' kernels
    run_i8_dot(dev, rows, totals)
    run_gn_stages(dev, rows, totals)

    # 9. summary: per kernel, summed over its calls in one run of every path
    # or tool
    summary = []
    for name, rs in rows.items():
        if not rs or not totals.get(name):
            raise AssertionError(f"kernel {name} was launched on no path")
        k = KERNELS[name]
        lib = [r["library_ms"] for r in rs]
        summary.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "tpu_kernels": k["tpu_kernels"],
            "launches": totals[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["kernel_ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": ("bytes" if sum(r["bytes_ms"] for r in rs)
                         >= sum(r["ops_ms"] for r in rs) else "operations"),
            "library_ms": None if None in lib else sum(lib),
        })
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
