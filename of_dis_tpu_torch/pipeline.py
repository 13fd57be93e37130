"""Streaming serving pipeline: a directory of frames -> .flo / .pfm files.

The production serving mode of the JAX package (`of_dis_tpu/pipeline.py`),
on PyTorch and CUDA: consecutive frame pairs of a sequence are batched,
decoded on host threads (`native.io.decode_batch`, every frame of a batch
once), copied to the card while the previous batch computes, and written
out by a pool of writer threads. All four reference modes serve
(run_dense.cpp:186-431): run_OF_INT / run_OF_RGB write .flo flow,
run_DE_INT / run_DE_RGB write .pfm disparity (consecutive frames treated as
stereo pairs, the negated bottom-up payload of run_dense.cpp:421 and
SavePFMFile).

On CUDA a batch lands in a pinned host buffer, its copy to the card runs
without blocking on a side stream that the compute stream waits on, and
its result comes back without blocking into pinned memory: the host
decodes batch k+1 (producer thread) and writes batch k-1 (writer pool)
while the card runs batch k. Each batch goes through the normal entry
point, `models.dis.dis_flow_batched` (`dis_step_warm` with --streams).

Several devices: pass a `parallel.mesh.Mesh` (or --mesh on the command
line) and each batch's frame-pair axis is split over its devices, one
contiguous shard a device, each shard copied to its own device.

Usage:
  python -m of_dis_tpu_torch.pipeline FRAME_DIR OUT_DIR [--op N] [--batch B]
      [--mode run_OF_INT|run_OF_RGB|run_DE_INT|run_DE_RGB] [--streams S]
      [--mesh all|N] [--device cuda|cpu]

--streams S enables warm-start sequence serving: S contiguous video
segments advance in lockstep, each lane warm-starting from its previous
pair's flow. --mesh all splits over every CUDA device; --mesh N over the
first N (on --device cpu, over the CPU N times).

Frames (PNG, PNM (P1-P6), BMP, JPEG, WebP, Sun raster, PAM, Radiance
HDR, TIFF and GIF, each decoded as cv::imread decodes it by the port's
own decoders, csrc/io_native.cpp, csrc/jpeg.cpp, csrc/webp.cpp,
csrc/raster.cpp, csrc/tiff.cpp and csrc/gif.cpp) are sorted
lexicographically;
pair t produces OUT_DIR/<frame_t>.flo (.pfm for depth modes), cropped to
the frames' size.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue
from typing import List, Optional, Sequence, Tuple

import torch

from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.native import io as native_io
from of_dis_tpu_torch.ops import pyramid
from of_dis_tpu_torch.parallel import mesh as pmesh
from of_dis_tpu_torch.params import op_point_params, pad_amounts
from of_dis_tpu_torch.utils import io as uio

MODES = ("run_OF_INT", "run_OF_RGB", "run_DE_INT", "run_DE_RGB")
# Pairs a batch per device when batch=0, by op-point (1-4): the fastest
# of the batch sizes tried on an NVIDIA H100 80GB HBM3 (700 W) by
# `tools/bench_pipeline.py` (PERF.md section 5 has the table), the JAX
# package's 64 kept where the difference is inside the noise (op-2: 32 to
# 256 within 15%); op-3 at 32 ran 1.45 times as many pairs/s as at 16,
# op-4 at 8 1.5 times as many as at 4. op-1 was not measured: the JAX
# package's 64.
DEFAULT_BATCH = {1: 64, 2: 64, 3: 32, 4: 8}
# frame-decode threads and file-writer threads
DECODE_THREADS = max(1, min(8, os.cpu_count() or 1))
WRITE_THREADS = 4


def default_batch(op_point: int) -> int:
    """The pairs a batch, per device, that batch=0 resolves to."""
    return DEFAULT_BATCH[min(max(op_point, 1), 4)]


# frame file extensions: PNG, PNM, BMP, JPEG, WebP, Sun raster, PAM,
# Radiance HDR, TIFF, GIF and JPEG 2000 (JP2 files and raw codestreams;
# not .pfm: the CLI's depth output)
FRAME_EXTENSIONS = (".png", ".pgm", ".ppm", ".pbm", ".pnm", ".bmp", ".jpg",
                    ".jpeg", ".webp", ".ras", ".sr", ".pam", ".hdr", ".pic",
                    ".tif", ".tiff", ".gif", ".jp2", ".j2k", ".j2c", ".jpc")


def list_frames(frame_dir: str) -> List[str]:
    """The frames (`FRAME_EXTENSIONS`) of a directory, sorted."""
    names = sorted(f for f in os.listdir(frame_dir)
                   if f.lower().endswith(FRAME_EXTENSIONS))
    return [os.path.join(frame_dir, f) for f in names]


class _ProducerError:
    """Queue sentinel carrying a decode exception from the producer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class _Step:
    """One device step: `pairs` (frame paths, padded to the step's size)
    and `writes`, the (row, output name) of the rows to write."""
    pairs: List[Tuple[str, str]]
    writes: List[Tuple[int, str]]


@dataclasses.dataclass
class _Shard:
    """One device's part of a step, decoded: its distinct frames (C, H, W)
    uint8 in a host buffer (pinned for CUDA), and per pair the rows of its
    two frames."""
    frames: torch.Tensor
    ia: torch.Tensor
    ib: torch.Tensor


def _decode_shards(step: _Step, mesh: pmesh.Mesh, shape, pin: bool,
                   pool) -> List[_Shard]:
    """Split a step's pairs over the mesh (`parallel.mesh.shard_bounds`)
    and decode each shard's distinct frames (C, H, W) = `shape` once
    (consecutive pairs share a frame)."""
    shards = []
    for bounds in pmesh.shard_bounds(mesh, len(step.pairs)):
        rows = {}
        own = step.pairs[bounds]
        ia = [rows.setdefault(a, len(rows)) for a, _ in own]
        ib = [rows.setdefault(b, len(rows)) for _, b in own]
        frames = torch.empty((len(rows),) + tuple(shape), dtype=torch.uint8,
                             pin_memory=pin)
        native_io.decode_batch(list(rows), shape[0], pool=pool,
                               out=frames.numpy())
        index = [torch.tensor(i, dtype=torch.int64) for i in (ia, ib)]
        if pin:
            index = [i.pin_memory() for i in index]
        shards.append(_Shard(frames, *index))
    return shards


class _Producer:
    """The decode thread: puts each step's decoded shards on a queue of two
    (or a `_ProducerError`, then stops), and stops early once `close` is
    called."""

    def __init__(self, steps, decode):
        self.queue: Queue = Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        args=(steps, decode), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def _run(self, steps, decode):
        # a decode failure must reach the consumer, not end this thread
        # silently (the consumer would wait on the queue forever): it rides
        # the queue and re-raises there
        try:
            for step in steps:
                if not self._put((step, decode(step))):
                    return
            self._put(None)
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            self._put(_ProducerError(e))

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self.queue.get_nowait()
            except Empty:
                break
        self._thread.join()


class _Devices:
    """The devices a run computes on, with one copy stream per CUDA device."""

    def __init__(self, devs: Sequence[torch.device]):
        self.cuda = all(d.type == "cuda" for d in devs)
        self._copy = {}

    def upload(self, shard: _Shard, dev: torch.device, sc_f: int):
        """A shard's pairs on `dev`, each frame divisibility-padded:
        ((per, C, H', W') first frames, second frames). On CUDA the copy
        runs on the device's copy stream without blocking the host, and
        the compute stream waits for it."""
        frames, ia, ib = shard.frames, shard.ia, shard.ib
        if dev.type == "cuda":
            stream = self._copy.get(dev)
            if stream is None:
                stream = self._copy[dev] = torch.cuda.Stream(device=dev)
            with torch.cuda.stream(stream):
                frames, ia, ib = (t.to(dev, non_blocking=True)
                                  for t in (frames, ia, ib))
            compute = torch.cuda.current_stream(dev)
            compute.wait_stream(stream)
            for t in (frames, ia, ib):
                t.record_stream(compute)
        frames = pyramid.pad_to_divisible(frames, sc_f)
        return frames.index_select(0, ia), frames.index_select(0, ib)


def run_pipeline(frame_dir: str, out_dir: str, *, op_point: int = 2,
                 batch: int = 0, mode: str = "run_OF_INT",
                 mesh: Optional[pmesh.Mesh] = None, streams: int = 0,
                 verbose: bool = True, device="cuda") -> int:
    """Stream a frame directory through the batched DIS pipeline.

    Returns the number of frame pairs processed. Batches overlap: host
    decode of batch k+1 and .flo / .pfm writes of batch k-1 run while the
    device computes batch k. Runs on `device` ("cuda" by default, raising
    without CUDA; "cpu" runs every kernel's plain twin), or on the devices
    of `mesh`.

    batch=0 takes `default_batch(op_point)` pairs a device; a batch is
    rounded up to a multiple of the mesh size, and the ragged tail is
    padded to it by repeating its last pair (whose repeats are not
    written).

    streams=S switches to warm-start sequence serving: the video's pairs
    split into S contiguous segments (S rounded up to the mesh size)
    advancing in lockstep, one S-lane step per time index through
    `dis.dis_step_warm`, each lane warm-starting pair t+1 from its pair t's
    flow. Lanes whose segment is exhausted recompute their last pair, and
    those outputs are not written.
    """
    if mode not in MODES:
        raise ValueError(f"unknown pipeline mode {mode}")
    if mesh is None:
        mesh = pmesh.make_mesh([device])
    devs, n_dev = mesh.devices, mesh.size
    nop = 1 if "DE" in mode else 2
    noc = 3 if "RGB" in mode else 1
    if not batch:
        batch = default_batch(op_point) * n_dev
    batch += -batch % n_dev
    frames = list_frames(frame_dir)
    if len(frames) < 2:
        raise ValueError(f"{frame_dir}: need at least 2 frames")
    os.makedirs(out_dir, exist_ok=True)

    first = native_io.decode_batch(frames[:1], noc)
    h_org, w_org = first.shape[2], first.shape[3]
    params = op_point_params(w_org, op_point, nop=nop, noc=noc, verbosity=0)
    top, bot, left, right = pad_amounts(w_org, h_org, params.sc_f)
    full_h, full_w = h_org + top + bot, w_org + left + right
    ext = ".pfm" if nop == 1 else ".flo"

    def name(path: str) -> str:
        return os.path.join(out_dir,
                            os.path.splitext(os.path.basename(path))[0] + ext)

    pairs = list(zip(frames[:-1], frames[1:]))
    if streams:
        s = max(1, min(streams, len(pairs)))
        s += -s % n_dev
        steps = _stream_steps(pairs, s, name)
        lanes = s
    else:
        steps = _cold_steps(pairs, batch, name)
        lanes = batch
    shards = pmesh.shard_bounds(mesh, lanes)
    carry = [dis.warm_carry_init(s.stop - s.start, params, full_w, full_h,
                                 device=dev)
             for s, dev in zip(shards, devs)] if streams else None

    def compute(d: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dev = devs[d]
        if carry is None:
            return dis.dis_flow_batched(a, b, params, full_w, full_h,
                                        device=dev)
        flow, carry[d] = dis.dis_step_warm(a, b, params, full_w, full_h,
                                           carry[d], device=dev)
        return flow

    where = _Devices(devs)
    write = uio.write_pfm if nop == 1 else uio.write_flo
    writes = []
    decoder = ThreadPoolExecutor(max_workers=DECODE_THREADS)
    writer = ThreadPoolExecutor(max_workers=WRITE_THREADS)
    producer = _Producer(steps, lambda step: _decode_shards(
        step, mesh, first.shape[1:], where.cuda, decoder))
    n_done = 0
    t0 = time.perf_counter()
    pending = []   # (step, pinned results, events) in flight

    def drain(item) -> int:
        step, res, events = item
        for ev in events:
            ev.synchronize()
        rows = res.numpy()
        for k, path in step.writes:
            writes.append(writer.submit(write, path, rows[k]))
        return len(step.writes)

    try:
        while True:
            item = producer.queue.get()
            if item is None:
                break
            if isinstance(item, _ProducerError):
                raise RuntimeError(
                    f"frame decode failed in {frame_dir}") from item.exc
            step, decoded = item
            res = torch.empty((lanes, h_org, w_org, nop), dtype=torch.float32,
                              pin_memory=where.cuda)
            events = []
            for d, (dev, shard) in enumerate(zip(devs, decoded)):
                a, b = where.upload(shard, dev, params.sc_f)
                flow = compute(d, a, b)[:, top:top + h_org,
                                        left:left + w_org].contiguous()
                res[shards[d]].copy_(flow, non_blocking=True)
                if dev.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(dev))
                    events.append(ev)
            pending.append((step, res, events))
            if len(pending) > 1:       # drain all but the batch in flight
                n_done += drain(pending.pop(0))
        while pending:
            n_done += drain(pending.pop(0))
        for fut in writes:
            fut.result()
    finally:
        producer.close()
        decoder.shutdown(wait=True)
        writer.shutdown(wait=True)
    dt = time.perf_counter() - t0
    if verbose:
        what = f" ({lanes} warm-start streams)" if streams else ""
        print(f"{n_done} pairs in {dt:.2f}s -> {n_done / dt:.1f} pairs/s"
              f"{what}")
    return n_done


def _cold_steps(pairs, batch: int, name):
    """Cold batches: `batch` consecutive pairs a step, the ragged tail
    padded by repeating its last pair; every real pair is written."""
    for i in range(0, len(pairs), batch):
        real = pairs[i:i + batch]
        yield _Step(real + [real[-1]] * (batch - len(real)),
                    [(k, name(a)) for k, (a, _) in enumerate(real)])


def _stream_steps(pairs, s: int, name):
    """Warm streams: the pairs split into s contiguous segments (lengths
    differing by at most one); step t runs pair t of every segment, an
    exhausted lane its last pair and an empty lane pair 0, neither
    written."""
    base, extra = divmod(len(pairs), s)
    lens = [base + (1 if i < extra else 0) for i in range(s)]
    starts = [sum(lens[:i]) for i in range(s)]
    for t in range(max(lens)):
        sel = [pairs[starts[i] + min(t, lens[i] - 1)] if lens[i] else pairs[0]
               for i in range(s)]
        yield _Step(sel, [(i, name(sel[i][0])) for i in range(s)
                          if t < lens[i]])


def _mesh_from_spec(spec: str, device: str) -> pmesh.Mesh:
    """--mesh all: every CUDA device; --mesh N: the first N of them (the
    CPU N times with --device cpu)."""
    if device == "cpu":
        if spec == "all":
            raise ValueError("--mesh all needs CUDA devices; give a count")
        return pmesh.make_mesh(["cpu"] * int(spec))
    if spec == "all":
        return pmesh.make_mesh()
    dis.resolve_device("cuda")
    n, count = int(spec), torch.cuda.device_count()
    if n > count:
        raise ValueError(f"--mesh {n}: only {count} CUDA devices")
    return pmesh.make_mesh([torch.device("cuda", i) for i in range(n)])


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    kw = {}
    opts = {}
    for flag in ("--op", "--batch", "--mode", "--streams", "--mesh",
                 "--device"):
        if flag in argv:
            k = argv.index(flag)
            opts[flag] = argv[k + 1]
            del argv[k:k + 2]
    for flag, key in (("--op", "op_point"), ("--batch", "batch"),
                      ("--streams", "streams")):
        if flag in opts:
            kw[key] = int(opts[flag])
    if "--mode" in opts:
        kw["mode"] = opts["--mode"]
    device = opts.get("--device", "cuda")
    if "--mesh" in opts:
        kw["mesh"] = _mesh_from_spec(opts["--mesh"], device)
    frame_dir, out_dir = argv[:2]
    run_pipeline(frame_dir, out_dir, device=device, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
