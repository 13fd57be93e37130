"""Frames/s of the batch decoder (`native.io.decode_batch`) in two or more
checkouts of this repo, run in turns on one host.

    python -m of_dis_tpu_torch.tools.bench_decode --trees OLD NEW \\
        [--frames DIR] [--pairs 10] [--threads 1 8] [--channels 1]

The frames are phase 7's of chip_smoke.py (`bench_pipeline.make_frames`:
161 gray 1024x436 PNGs, all five filters), written once into
`build/bench_decode/frames` unless `--frames` names a directory (any
format `pipeline.list_frames` lists: JPEG, WebP, Sun raster, PAM, HDR,
TIFF, GIF and JPEG 2000 too; chip_smoke.py leaves part 7c-7e's frames
under `build/of_dis_tpu_torch/smoke/`; committed are part 7b's JPEG
frames, Huffman-coded in tests/torch_fixtures/jpeg/frames and
arithmetic-coded in .../frames_arith, its lossless gray and YCCK pairs in
.../pairs/*, part 7e's Group 4 frames in tests/torch_fixtures/tiff/fax_g4
(its YCbCr ones part 7e writes to build/of_dis_tpu_torch/smoke/tiff/
ycbcr_lzw), and part 7f's JPEG 2000 frames in
tests/torch_fixtures/jp2/frames and .../lossless). One
worker process a checkout imports that checkout's package and waits; for
each thread count the turns run ABBA (OLD, NEW, NEW, OLD, ...) `pairs`
times, each turn one `decode_batch` over every frame on a fresh pool of
that many threads, its planes checked against the first turn's. A turn
decodes the directory's frames as many times over as it takes to reach
MIN_TURN_FRAMES (the record's `repeat`): a turn of nine frames on eight
threads lasts a few milliseconds and its rate sags. A host
whose other tenants vary moves both trees' turns alike, so the median of
each tree's turns and of the per-pair ratios is the number to read. The
decode runs on the host alone: no device work. Prints one JSON line a
thread count (with the frame directory), and the card's `nvidia-smi`
line where there is one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

from of_dis_tpu_torch.kernels import build

# the fewest frames a turn decodes
MIN_TURN_FRAMES = 72

# the worker: argv = checkout, frame dir, channels, frames a turn; answers
# "ready" and the repeat count, then reads a thread count a line from
# stdin and answers with that turn's frames/s
_WORKER = r"""
import sys, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np
sys.path.insert(0, sys.argv[1])
from of_dis_tpu_torch import pipeline
from of_dis_tpu_torch.native import io as nio
paths = pipeline.list_frames(sys.argv[2])
repeat = -(-int(sys.argv[4]) // len(paths))
paths = paths * repeat
channels = int(sys.argv[3])
first = nio.decode_batch(paths, channels)
print("ready", repeat, flush=True)
for line in sys.stdin:
    with ThreadPoolExecutor(int(line)) as pool:
        t0 = time.perf_counter()
        out = nio.decode_batch(paths, channels, pool=pool)
        rate = len(paths) / (time.perf_counter() - t0)
    if not np.array_equal(out, first):
        sys.exit("decode_batch differs between turns")
    print(rate, flush=True)
"""


def _card() -> str | None:
    if shutil.which("nvidia-smi") is None:
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def _frames(frame_dir: str | None) -> str:
    if frame_dir:
        return os.path.abspath(frame_dir)   # the workers run in each tree
    from of_dis_tpu_torch.tools import bench_pipeline
    frame_dir = str(build.BUILD_DIR / "bench_decode" / "frames")
    bench_pipeline.make_frames(frame_dir, 161, seed=0, device="cpu")
    return frame_dir


def run(trees, frame_dir, pairs: int, threads, channels: int) -> list:
    """One record a thread count: each tree's turns (frames/s; a turn
    decodes the directory's frames `repeat` times over) and their median,
    and the median of each later tree's ratio to the first over the
    pairs."""
    names = [os.path.basename(os.path.abspath(t)) or t for t in trees]
    workers = []
    try:
        for tree in trees:
            w = subprocess.Popen(
                [sys.executable, "-c", _WORKER, os.path.abspath(tree),
                 frame_dir, str(channels), str(MIN_TURN_FRAMES)],
                cwd=tree, text=True,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            workers.append(w)
        for w in workers:
            ready, _, repeat = w.stdout.readline().partition(" ")
            if ready != "ready":
                raise RuntimeError("a decode worker failed to start")
            repeat = int(repeat)

        def turn(w, k: int) -> float:
            w.stdin.write(f"{k}\n")
            w.stdin.flush()
            line = w.stdout.readline()
            if not line:
                raise RuntimeError("a decode worker stopped")
            return float(line)

        records = []
        for k in threads:
            turns = [[] for _ in trees]
            for p in range(pairs):
                order = range(len(trees))
                for i in (order if p % 2 == 0 else reversed(order)):
                    turns[i].append(turn(workers[i], k))
            rec = {"bench": "decode_batch", "threads": k, "pairs": pairs,
                   "repeat": repeat,
                   "frames_per_s": dict(zip(names, turns)),
                   "median": {n: statistics.median(t)
                              for n, t in zip(names, turns)}}
            rec["median_ratio_to_" + names[0]] = {
                n: statistics.median(b / a for a, b in zip(turns[0], t))
                for n, t in zip(names[1:], turns[1:])}
            records.append(rec)
        return records
    finally:
        for w in workers:
            if w.stdin:
                w.stdin.close()
            try:
                w.wait(timeout=30)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="checkouts of the repo; the first is the base")
    ap.add_argument("--frames", default=None,
                    help="a directory of frames (default: phase 7's)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--channels", type=int, default=1, choices=(1, 3))
    args = ap.parse_args(argv)
    frame_dir = _frames(args.frames)
    records = run(args.trees, frame_dir, args.pairs, args.threads,
                  args.channels)
    card = _card()
    for rec in records:
        rec.update(frames=frame_dir, host_cpus=os.cpu_count(), card=card)
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
