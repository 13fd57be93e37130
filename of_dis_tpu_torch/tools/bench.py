"""Throughput bench of the port: batched DIS flow pairs/s at op-point 2 on
Sintel-sized (1024x436) gray u8 frame pairs, on the card. The counterpart
of the JAX package's `bench.py`.

Prints ONE JSON line in `bench.py`'s form, {"metric", "value", "unit",
"vs_baseline", "secondary"}, plus per row the device's busy share and the
launches of every kernel, and the card's name and power limit:

  - primary row `sintel_1024x436_op2_pairs_per_sec`: op-2 gray flow through
    `dis_flow_batched` at BENCH_BATCH pairs (default 64, the port's main
    path): one warm-up call (the nvcc build and the first allocations
    fall outside the timer), then BENCH_ITERS (default 6) back-to-back
    calls alternating (a, b) / (b, a), host clock, one
    `torch.cuda.synchronize()` at the end;
  - secondary rows (BENCH_SECONDARY=0 leaves them out), each at
    `bench.py`'s batch rule min(BENCH_BATCH, cap), iterations and sizes,
    under the same keys: `op1`, `op3`, `op4`, `rgb_op3`, `rgb_op2`,
    `de_op2`, `de_op3`, `de_rgb_op2`, `fbcon_op2`, `op2_1080p` (1920x1080),
    `seq_op3` (4 streams x 9 frames through `dis_sequence_batched`, two
    timed runs) and `seq_serving` (`pipeline.run_pipeline(op_point=3,
    streams=4)` on 33 PNG frames moving 0.7 times the field a frame,
    written by `utils.viz.write_png`; pairs over the wall of a whole run,
    decode and file writes included). `bench.py`'s `op3_nocache` has no
    row: its extraction cache is a TPU device the port has no counterpart
    of.
  - `busy_share` per row: device kernel time of one profiled call over
    the unprofiled wall of one call right after the row's timed loop
    (null on the CPU); the profiles run once every row is timed;
  - `vs_baseline` is null: `bench.py` divides by a TPU target, and the
    card has none.

A row that raises ends the bench with a non-zero exit: no row records an
error in the line. Every row checks the kernels' launch counts on the
card and raises if a kernel its parameters reach launched no time (K1,
K2, K3, K4 on op-2; K6 on the op-3/4 levels above 512 patches; K5 on the
depth rows): no row runs on the plain twins where there is a card.

Workload: `tools/synth.py` (the JAX bench's smooth subpixel field, seed
0; depth pairs by its disparity field). `bench.py`'s BENCH_SCAN (a loop
inside one XLA executable) and BENCH_TIME_BUDGET (cold XLA compiles)
have no counterpart here.

Usage: python -m of_dis_tpu_torch.tools.bench [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import torch

from of_dis_tpu_torch import pipeline, trace
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import patch_solver, pyramid
from of_dis_tpu_torch.params import (make_level_spec, op_point_params,
                                     pad_amounts)
from of_dis_tpu_torch.tools import bench_pipeline, profile_pipeline, synth
from of_dis_tpu_torch.utils import viz

PRIMARY = "sintel_1024x436_op2_pairs_per_sec"
H, W = 436, 1024
HD = (1080, 1920)
SEED = 0
# the kernel libraries of the main path, each counted at its batched C
# entry `of_<library>`
KERNELS = ("gn_fused", "gn_tiled", "bilerp_extract", "tv_of_inner",
           "tv_de_inner", "warp", "upscale")
_launch_base: dict = {}


@dataclasses.dataclass(frozen=True)
class Row:
    """One row: `bench.py`'s key, op-point, modes, batch cap,
    iterations, size; kind "pairs" (`dis_flow_batched`), "seq"
    (`dis_sequence_batched` on streams x frames) or "serving"
    (`run_pipeline` with streams on frames)."""
    name: str
    op: int
    cap: int = 0
    iters: int = 1
    nop: int = 2
    noc: int = 1
    fbcon: bool = False
    hd: bool = False
    kind: str = "pairs"
    streams: int = 0
    frames: int = 0


SECONDARY = (
    Row("op1_pairs_per_sec", 1, cap=384, iters=6),
    Row("op3_pairs_per_sec", 3, cap=8, iters=4),
    Row("op4_pairs_per_sec", 4, cap=4, iters=2),
    Row("rgb_op3_pairs_per_sec", 3, cap=8, iters=3, noc=3),
    Row("rgb_op2_pairs_per_sec", 2, cap=96, iters=4, noc=3),
    Row("de_op2_pairs_per_sec", 2, cap=256, iters=4, nop=1),
    Row("de_op3_pairs_per_sec", 3, cap=8, iters=4, nop=1),
    Row("de_rgb_op2_pairs_per_sec", 2, cap=96, iters=4, nop=1, noc=3),
    Row("fbcon_op2_pairs_per_sec", 2, cap=64, iters=4, fbcon=True),
    Row("op2_1080p_pairs_per_sec", 2, cap=32, iters=3, hd=True),
    Row("seq_op3_pairs_per_sec", 3, iters=2, kind="seq", streams=4,
        frames=9),
    Row("seq_serving_pairs_per_sec", 3, kind="serving", streams=4,
        frames=33),
)
# frames of seq_serving move by this fraction of the field a frame
SERVING_STEP = 0.7


def _launch_counts() -> dict:
    return {name: trace.launches(name, f"of_{name}") for name in KERNELS}


def reset_launches() -> None:
    """Count launches from here on."""
    _launch_base.clear()
    _launch_base.update(_launch_counts())


def read_launches() -> dict:
    """Launch counts since the last reset, kernels never launched left
    out."""
    counts = {name: n - _launch_base.get(name, 0)
              for name, n in _launch_counts().items()}
    return {name: n for name, n in counts.items() if n}


def expected_kernels(params, full_w: int, full_h: int) -> set:
    """The kernels a call with these parameters must launch on the card:
    per level its GN route (`gn_fused`, `gn_tiled` above 512 patches, the
    extraction of the unfused route for patches above 12 pixels), with TV
    the warp and the flow or depth loop, and the upscale unless the last
    level is full resolution."""
    names = set()
    for sl in range(params.sc_f, params.sc_l - 1, -1):
        spec = make_level_spec(sl, full_w, full_h, params)
        if patch_solver.uses_unfused(params):
            names.add("bilerp_extract")
        elif patch_solver.uses_tiled(spec):
            names.add("gn_tiled")
        else:
            names.add("gn_fused")
    if params.usetvref:
        names |= {"warp", "tv_of_inner" if params.nop == 2 else "tv_de_inner"}
    if params.sc_l:
        names.add("upscale")
    return names


def check_launches(name: str, launches: dict, want: set) -> None:
    missing = sorted(k for k in want if not launches.get(k))
    if missing:
        raise RuntimeError(f"{name}: kernels {missing} launched no time "
                           f"(launches {launches})")


def time_calls(params, a, b, iters: int, full_w: int, full_h: int, device,
               alternate: bool = False):
    """One warm-up call of `dis_flow_batched(a, b)`, then `iters`
    back-to-back calls, every second one on (b, a) with `alternate`, on
    the host clock with one synchronize at the end. Returns (seconds of
    the timed calls, seconds of the warm-up call, the last output)."""
    t0 = time.perf_counter()
    out = dis.dis_flow_batched(a, b, params, full_w, full_h, device=device)
    profile_pipeline.sync(device)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(iters):
        x, y = (b, a) if alternate and i % 2 else (a, b)
        out = dis.dis_flow_batched(x, y, params, full_w, full_h,
                                   device=device)
    profile_pipeline.sync(device)
    return time.perf_counter() - t0, warm, out


def wall_of(fn, device) -> float:
    """Host seconds of one call of fn, between two synchronizes."""
    profile_pipeline.sync(device)
    t0 = time.perf_counter()
    fn()
    profile_pipeline.sync(device)
    return time.perf_counter() - t0


def row_params(row: Row, w: int):
    params = op_point_params(w, row.op, nop=row.nop, noc=row.noc)
    if row.fbcon:
        params = dataclasses.replace(params, usefbcon=True)
    return params


def pairs_row(row: Row, batch: int, device, h: int, w: int,
              alternate: bool = False) -> dict:
    """A `dis_flow_batched` row: pairs/s, one call (`run`) and its
    unprofiled wall, and the inputs and last output of its timed
    calls."""
    params = row_params(row, w)
    field = synth.flow_field if row.nop == 2 else synth.disparity_field
    a8, b8, _, _ = synth.make_pairs(batch, h, w, SEED, device,
                                    channels=row.noc, field=field)
    a = pyramid.pad_to_divisible(a8, params.sc_f)
    b = pyramid.pad_to_divisible(b8, params.sc_f)
    fh, fw = a.shape[-2], a.shape[-1]
    dt, _, out = time_calls(params, a, b, row.iters, fw, fh, device,
                            alternate)

    def run():
        return dis.dis_flow_batched(a, b, params, fw, fh, device=device)

    return dict(value=batch * row.iters / dt, run=run,
                wall_s=wall_of(run, device),
                want=expected_kernels(params, fw, fh), inputs=(a, b),
                params=params, out=out)


def seq_row(row: Row, device, h: int, w: int) -> dict:
    """`dis_sequence_batched` on row.streams x row.frames, one warm-up
    run, then row.iters timed runs."""
    params = row_params(row, w)
    frames, _, _ = synth.make_sequence(row.streams, row.frames, h, w, SEED,
                                       device)
    frames = pyramid.pad_to_divisible(frames, params.sc_f + 1)
    fh, fw = frames.shape[-2], frames.shape[-1]

    def run():
        return dis.dis_sequence_batched(frames, params, fw, fh,
                                        device=device)

    wall_of(run, device)                    # build, allocate, warm up
    t0 = time.perf_counter()
    for _ in range(row.iters):
        run()
    profile_pipeline.sync(device)
    dt = time.perf_counter() - t0
    pairs = row.streams * (row.frames - 1) * row.iters
    return dict(value=pairs / dt, run=run,
                wall_s=wall_of(run, device),
                want=expected_kernels(params, fw, fh))


def serving_row(row: Row, device, h: int, w: int, tmp: str) -> dict:
    """`run_pipeline(op_point=row.op, streams=row.streams)` on row.frames
    PNG frames written under `tmp`: one warm-up run, then one timed run
    (its wall, decode and file writes included)."""
    params = row_params(row, w)
    frames, _, _ = synth.make_sequence(1, row.frames, h, w, SEED, device,
                                       scale=SERVING_STEP)
    frames = frames[:, 0, 0].cpu().numpy()
    fdir, odir = os.path.join(tmp, "frames"), os.path.join(tmp, "out")
    os.makedirs(fdir)
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(viz.write_png,
                                os.path.join(fdir, f"f{t:04d}.png"),
                                frames[t]) for t in range(len(frames))]:
            fut.result()

    def run():
        return pipeline.run_pipeline(fdir, odir, op_point=row.op,
                                     streams=row.streams, verbose=False,
                                     device=device)

    run()                                   # build, allocate, warm up
    shutil.rmtree(odir)
    t0 = time.perf_counter()
    n = run()
    dt = time.perf_counter() - t0
    top, bot, left, right = pad_amounts(w, h, params.sc_f)
    return dict(value=n / dt, run=run, wall_s=dt,
                want=expected_kernels(params, w + left + right,
                                      h + top + bot))


def card(device) -> Optional[dict]:
    """The card's name and power limit from `nvidia-smi`; None on the
    CPU."""
    if torch.device(device).type != "cuda":
        return None
    name, limit = bench_pipeline.card().rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def run_row(row: Row, batch: int, device, h: int, w: int, tmp: str,
            alternate: bool = False) -> dict:
    """One row (its files, if any, under `tmp`) with its launches counted
    and checked on the card."""
    reset_launches()
    if row.kind == "seq":
        r = seq_row(row, device, h, w)
    elif row.kind == "serving":
        r = serving_row(row, device, h, w, tmp)
    else:
        r = pairs_row(row, min(batch, row.cap), device, h, w, alternate)
    profile_pipeline.sync(device)
    r["launches"] = read_launches()
    if torch.device(device).type == "cuda":
        check_launches(row.name, r["launches"], r["want"])
    return r


def main(argv=None, rows: Optional[Sequence[str]] = None, h: int = H,
         w: int = W, hd=HD) -> dict:
    """Run the primary row and the secondary rows (all, or those named in
    `rows`) and print the JSON line; returns it as a dict, with each
    row's result under "rows". `h`, `w` and `hd` set the frame sizes
    (Sintel and the 1080p row's). Every row is timed before any is
    profiled: a profiler session could perturb the calls after it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dis.resolve_device(args.device)
    batch = int(os.environ.get("BENCH_BATCH", "64"))
    iters = int(os.environ.get("BENCH_ITERS", "6"))
    todo = [Row(PRIMARY, 2, cap=batch, iters=iters)]
    if os.environ.get("BENCH_SECONDARY", "1") != "0":
        todo += [r for r in SECONDARY if rows is None or r.name in rows]
    results = {}
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        for row in todo:
            rh, rw = hd if row.hd else (h, w)
            results[row.name] = run_row(row, batch, dev, rh, rw,
                                        os.path.join(tmp, row.name),
                                        alternate=row.name == PRIMARY)
        # the busy share: device time of one profiled call over the
        # unprofiled wall of one call after the row's timed loop
        for r in results.values():
            run = r.pop("run")
            r["busy_share"] = (None if dev.type != "cuda" else
                               profile_pipeline.busy_ms(run, dev)
                               / (r["wall_s"] * 1e3))
    secondary = {k: round(r["value"], 2) for k, r in results.items()
                 if k != PRIMARY}
    line = {
        "metric": PRIMARY,
        "value": round(results[PRIMARY]["value"], 2),
        "unit": "frame-pairs/s",
        "vs_baseline": None,
        **({"secondary": secondary} if secondary else {}),
        "busy_share": {k: r["busy_share"] for k, r in results.items()},
        "launches": {k: r["launches"] for k, r in results.items()},
        "batch": batch, "iters": iters, "device": str(dev),
        "card": card(dev),
    }
    print(json.dumps(line), flush=True)
    return dict(line, rows=results)


if __name__ == "__main__":
    main()
