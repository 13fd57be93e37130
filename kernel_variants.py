"""Time versions of one kernel's source against each other on the card, on
the calls that `chip_smoke.py`'s paths hand the kernel.

    python3 kernel_variants.py KERNEL SOURCE.cu ...
    python3 kernel_variants.py tv_de_inner --routes

Run from the repository root on a machine with an NVIDIA GPU. KERNEL is
`gn_fused`, `gn_tiled`, `bilerp_extract`, `tv_de_inner`, `warp`, `i8_dot`
or `gn_stages`; each SOURCE is a version of
`of_dis_tpu_torch/csrc/KERNEL.cu` with the same C entry (say the parent's,
from `git show HEAD:of_dis_tpu_torch/csrc/gn_fused.cu`, and trial edits),
named by its file stem. Every SOURCE is compiled with the build's nvcc
flags, all at once, and its ptxas report (registers, spills) printed. The
kernel's calls are recorded from one `dis_flow_batched` call on each of
its paths (PATHS; for `i8_dot` the dot tool's call at its defaults, both
types; for `gn_stages` the stage tool's 12 calls, both geometries and so
both layouts), then, in each of ROUNDS rounds, each version is bound in
place of the kernel's library (`build.bind`), checked against the plain
twin on every call with `chip_smoke.py`'s tolerances (gn_fused and
gn_tiled: iterations equal, p and pweight within tolerance; gn_stages:
within its tolerance of the largest checksum; the others: equal) and
timed with `chip_smoke.device_ms`. The versions run in the order given
in even rounds and in the reverse order in odd ones (two versions, two
rounds: A B B A). Prints one JSON line per version
and round: device ms per (path, level) or tool call, summed over the
level's calls,
their sum, the calls that differed from their twin (`"mismatch"`) and
the card's `nvidia-smi` name and power limit.

With `--routes`, the depth TV loop's calls are timed on every route its
rule could take instead (`tv_de_inner.route` forced: clusters of 1 to 16
blocks where the bands fit and are 2 rows high, and the cooperative
route), each checked equal to its twin: one JSON line per call and
route, and per route the sum over the calls; the measurement behind the
rule.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from of_dis_tpu_torch import cli
from of_dis_tpu_torch.kernels import (bilerp_extract, build, gn_fused,
                                      gn_stages, gn_tiled, i8_dot,
                                      tv_de_inner, warp)
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import patch_solver, pyramid, tv
from of_dis_tpu_torch.params import op_point_params
from of_dis_tpu_torch.tools import bench_gn_stages, bench_i8_dot, synth

# each kernel's wrapper, its plain twin and the chip_smoke paths that
# launch it: every call of K1 (28), K6 (19: 7 on E and F, 4 on I, 8 on K),
# K7 (68), K5 (12) and K3 (49) on the main path; T1 and T2 run on none
# (their calls are the tools')
KERNELS = {"gn_fused": gn_fused.gn_fused,
           "gn_tiled": gn_tiled.gn_tiled,
           "bilerp_extract": bilerp_extract.bilerp_extract,
           "tv_de_inner": tv_de_inner.de_inner,
           "warp": warp.warp_image_batched,
           "i8_dot": i8_dot.dot_sum,
           "gn_stages": gn_stages.gn_stages}
TWINS = {"gn_fused": patch_solver._gn_plain,
         "gn_tiled": patch_solver._gn_tiled_plain,
         "bilerp_extract": patch_solver.extract_bilinear,
         "tv_de_inner": tv_de_inner._plain,
         "warp": tv.warp_image,
         "i8_dot": i8_dot._plain,
         "gn_stages": gn_stages._plain}
PATHS = {"gn_fused": "ABCDEFGIK", "gn_tiled": "EFIK", "bilerp_extract": "H",
         "tv_de_inner": "BDI", "warp": "ABCDEFGHIK", "i8_dot": "",
         "gn_stages": ""}
ROUNDS = 2


def compile_all(sources):
    """Each source built into a library beside it, one nvcc each, all at
    once; returns {stem: library path} of the ones that built."""
    procs = {}
    for src in sources:
        lib = src.with_name(f"lib{src.stem}.so")
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR),
               "-o", str(lib), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), lib)
    libs = {}
    for stem, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        report = [ln.split(": ", 1)[-1].strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln or "entry" in ln]
        print(f"{stem}: nvcc rc {proc.returncode}; " + " | ".join(report),
              flush=True)
        if proc.returncode == 0:
            libs[stem] = lib
        else:
            print(log[-3000:], flush=True)
    return libs


def record(kernel, dev):
    """[(label "path Llevel", args, kw)] of every call of `kernel` in one
    `dis_flow_batched` call on each of its paths; for `i8_dot` the dot
    tool's two calls at its defaults; for `gn_stages` the stage tool's
    twelve (label "geometry stage")."""
    if kernel == "gn_stages":
        calls = []
        for gname, geom in bench_gn_stages.GEOMETRIES.items():
            x = bench_gn_stages.make_inputs(geom, geom.batch, dev)
            calls += [(f"{gname} {label}",
                       bench_gn_stages.call_args(x, geom, stage, variant), {})
                      for label, stage, variant in bench_gn_stages.RUNS]
        return calls
    if kernel == "i8_dot":
        reps, grid, m, k, n = 64, 64, 832, 256, 256
        inputs = bench_i8_dot.make_inputs(reps, m, k, n, dev)
        return [(label, (*inputs[dtype], n, grid), {})
                for label, dtype in (("int8", torch.int8),
                                     ("bf16", torch.bfloat16))]
    calls_all = []
    for cfg in cs.PATHS:
        if cfg["name"] not in PATHS[kernel]:
            continue
        nop, noc = cfg["nop"], cfg["noc"]
        if cfg["op"] is None:
            params = cli.build_params(cs.W_ORG, nop, noc, cfg["args"].split())
        else:
            params = op_point_params(cs.W_ORG, cfg["op"], nop=nop, noc=noc)
        if cfg.get("fbcon"):
            params = dataclasses.replace(params, usefbcon=True)
        field = synth.flow_field if nop == 2 else synth.disparity_field
        a_u8, b_u8, _, _ = synth.make_pairs(cfg["batch"], cs.H_ORG, cs.W_ORG,
                                            0, dev, channels=noc, field=field)
        im_a = pyramid.pad_to_divisible(a_u8, params.sc_f)
        im_b = pyramid.pad_to_divisible(b_u8, params.sc_f)
        calls = {name: [] for name in cs.KERNELS}
        with cs.swapped(cs._recorder(calls)):
            dis.dis_flow_batched(im_a, im_b, params, im_a.shape[3],
                                 im_a.shape[2], device=dev)
        for args, kw in calls[kernel]:
            level = cs.call_level(kernel, args, im_a.shape[3], params.sc_l)[0]
            calls_all.append((f"{cfg['name']} L{level}", args, kw))
    torch.cuda.synchronize()
    return calls_all


def agrees(kernel, out, twin) -> bool:
    """A call's result against its twin's, at chip_smoke's tolerances."""
    if kernel == "gn_stages":
        scale = float(twin.abs().max())
        return float((out - twin).abs().max()) <= cs.TOL[kernel] * scale
    if kernel == "warp":
        return all(torch.equal(o, t) for o, t in zip(out, twin))
    if kernel not in ("gn_fused", "gn_tiled"):
        return torch.equal(out, twin)
    p_k, pw_k, it_k = out
    p_p, pw_p, it_p = twin[:3]
    pw_err = float((pw_k - pw_p).abs().max()) / float(pw_p.abs().max())
    return (int(it_k) == int(it_p) and pw_err <= cs.PWEIGHT_REL_TOL and
            float((p_k - p_p).abs().max()) <= cs.TOL[kernel])


def time_routes(dev) -> None:
    """Every call of the depth TV loop on every route its rule could take
    (`--routes`)."""
    calls = record("tv_de_inner", dev)
    rule = tv_de_inner.route
    sums = {}
    try:
        for label, args, kw in calls:
            b, h, w = args[0].shape
            twin = TWINS["tv_de_inner"](*args, **kw)
            routes = [("cluster", k) for k in (1, 2, 4, 8, 16)
                      if (k == 1 or h >= 2 * k) and tv_de_inner.N_FIELDS * 4
                      * -(-h // k) * w <= tv_de_inner.SMEM_BYTES]
            routes.append(("cooperative", 0))
            for r in routes:
                tv_de_inner.route = lambda *_, r=r: r
                out = tv_de_inner.de_inner(*args, **kw)
                torch.cuda.synchronize()
                ms = cs.device_ms(lambda *a: tv_de_inner.de_inner(*a, **kw),
                                  args)
                key = f"{r[0]} {r[1]}"
                sums[key] = sums.get(key, 0.0) + ms
                print(json.dumps({"call": label, "shape": [b, h, w],
                                  "route": list(r), "rule": list(rule(b, h, w)),
                                  "device_ms": ms,
                                  "equal": torch.equal(out, twin)}),
                      flush=True)
    finally:
        tv_de_inner.route = rule
    print(json.dumps({"routes_device_ms_sum": sums,
                      "card": cs.nvidia_smi_line()}), flush=True)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv == ["tv_de_inner", "--routes"]:
        if not torch.cuda.is_available():
            raise RuntimeError("kernel_variants needs a CUDA device")
        build.build()
        time_routes(torch.device("cuda"))
        return
    if len(argv) < 2 or argv[0] not in KERNELS:
        raise SystemExit(__doc__)
    kernel, sources = argv[0], [Path(p).resolve() for p in argv[1:]]
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_variants needs a CUDA device")
    libs = compile_all(sources)
    build.build()
    dev = torch.device("cuda")
    calls = record(kernel, dev)
    twins = [TWINS[kernel](*args, **kw) for _, args, kw in calls]
    wrapper = KERNELS[kernel]
    for rnd in range(ROUNDS):
        order = list(libs.items())
        for stem, lib in order if rnd % 2 == 0 else order[::-1]:
            build.bind(kernel, lib)
            row, bad = {}, []
            for (label, args, kw), twin in zip(calls, twins):
                out = wrapper(*args, **kw)
                torch.cuda.synchronize()
                if not agrees(kernel, out, twin):
                    bad.append(label)
                row[label] = row.get(label, 0.0) + cs.device_ms(
                    lambda *a: wrapper(*a, **kw), args)
            print(json.dumps({"round": rnd, "version": stem,
                              "device_ms": row, "sum": sum(row.values()),
                              "mismatch": bad,
                              "card": cs.nvidia_smi_line()}), flush=True)


if __name__ == "__main__":
    main()
