"""Serving-pipeline batch sweep: pairs/s of `pipeline.run_pipeline` (cold
batches, gray flow) at each batch size tried per op-point, the measurement
behind `pipeline.DEFAULT_BATCH`.

Frames: a blurred random base image (numpy.random.default_rng(seed),
7-tap Gaussian, sigma 2) translated by t * (1.3, 0.4) px for frame t
(bilinear, so the motion is subpixel and never whole pixels), cropped to
1024x436, rounded to u8 and written by `utils.viz.write_png` (rows under
every PNG filter). `make_frames` is shared with `chip_smoke.py`'s
pipeline phase.

Each op-point runs its batch sizes in turns, forward then backward, for
two rounds after one warm-up run, and prints one JSON line per
op-point and batch: the wall seconds of every run (host clock around
`run_pipeline`, which returns once every file is written) and the median
pairs/s, with the card's name and power limit. op-2 runs on 513 frames
(batches of up to 256 pairs then divide the run), op-3 and op-4 on the
first 161.

Usage: python -m of_dis_tpu_torch.tools.bench_pipeline   (needs CUDA)
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from of_dis_tpu_torch import pipeline
from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.tools import synth
from of_dis_tpu_torch.utils import viz

H, W = 436, 1024
STEP = (1.3, 0.4)
# batch sizes tried per op-point
SWEEP = {2: (32, 64, 128, 256), 3: (8, 16, 32), 4: (2, 4, 8)}
# frames of the op-2 sweep (512 pairs: every batch divides them), of the
# op-3 / op-4 sweeps (the chip phase's 161), and rounds of turns
FRAMES, SMALL_RUN, ROUNDS = 513, 161, 2


def frame_stack(n: int, step=STEP, seed: int = 0, device="cuda",
                h: int = H, w: int = W) -> torch.Tensor:
    """(n, h, w) uint8 frames on `device`: frame t is the base image
    sampled at (y - t dy, x - t dx) (content moving by `step` px a frame),
    bilinear, over a window placed so that every sample lies inside the
    base (at least 1280x512, larger when n frames need it)."""
    dx, dy = step
    span_x, span_y = abs(dx) * (n - 1), abs(dy) * (n - 1)
    bw = max(1280, w + math.ceil(span_x) + 16)
    bh = max(512, h + math.ceil(span_y) + 16)
    rng = np.random.default_rng(seed)
    base = synth.blur7(torch.as_tensor(
        rng.random((bh, bw), dtype=np.float32), device=device) * 255.0)
    # window origin: the sampled span centred in the base
    x0 = (bw - w - math.ceil(span_x)) // 2 + math.ceil(max(0.0, dx) * (n - 1))
    y0 = (bh - h - math.ceil(span_y)) // 2 + math.ceil(max(0.0, dy) * (n - 1))
    out = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for t in range(n):
        sx, sy = t * dx, t * dy
        nx, ny = math.floor(sx), math.floor(sy)
        fx, fy = sx - nx, sy - ny
        # x - sx lies between columns x - nx - 1 (weight fx) and x - nx
        a = base[y0 - ny - 1:y0 - ny + h, x0 - nx - 1:x0 - nx + w]
        rows = (1.0 - fx) * a[:, 1:] + fx * a[:, :-1]
        f = (1.0 - fy) * rows[1:] + fy * rows[:-1]
        out[t] = f.round().clamp(0, 255).to(torch.uint8)
    return out


def make_frames(frame_dir: str, n: int, step=STEP, seed: int = 0,
                device="cuda") -> np.ndarray:
    """Write `frame_stack(n, step, seed)` as frame_0000.png ... into
    `frame_dir` (emptied first), eight writer threads; returns the frames
    as (n, h, w) uint8."""
    frames = frame_stack(n, step, seed, device).cpu().numpy()
    shutil.rmtree(frame_dir, ignore_errors=True)
    os.makedirs(frame_dir)
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(viz.write_png,
                                os.path.join(frame_dir, f"frame_{t:04d}.png"),
                                frames[t]) for t in range(n)]:
            fut.result()
    return frames


def card() -> str:
    """The `nvidia-smi` name and power-limit line."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def sweep(frame_dir: str, out_dir: str, op: int, batches, rounds: int
          ) -> list:
    """Wall seconds of `run_pipeline` on the card at each batch, in turns
    (forward, then backward, `rounds` times), after one warm-up run."""
    walls = {b: [] for b in batches}
    pipeline.run_pipeline(frame_dir, out_dir, op_point=op, batch=batches[0],
                          verbose=False)
    order = list(batches) + list(batches)[::-1]
    for _ in range(rounds):
        for b in order:
            t0 = time.perf_counter()
            n = pipeline.run_pipeline(frame_dir, out_dir, op_point=op,
                                      batch=b, verbose=False)
            walls[b].append(time.perf_counter() - t0)
    return [{"bench": "pipeline_batch", "op": op, "batch": b, "pairs": n,
             "wall_s": walls[b],
             "pairs_per_s": n / statistics.median(walls[b])}
            for b in batches]


def main() -> list:
    dev = dis.resolve_device("cuda")
    build.build()
    root = os.path.join(build.BUILD_DIR, "bench_pipeline")
    big, small = os.path.join(root, "frames"), os.path.join(root, "small")
    make_frames(big, FRAMES, device=dev)
    shutil.rmtree(small, ignore_errors=True)
    os.makedirs(small)
    for t in range(SMALL_RUN):
        name = f"frame_{t:04d}.png"
        os.symlink(os.path.join(big, name), os.path.join(small, name))
    rows = []
    for op, batches in SWEEP.items():
        for row in sweep(big if op == 2 else small,
                         os.path.join(root, "out"), op, batches, ROUNDS):
            row["card"] = card()
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
