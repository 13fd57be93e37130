"""Ahead-of-time warm-up of a serving process on the card: the counterpart
of the JAX package's `tools/warmup.py`.

The port's first call of a process builds the nine CUDA libraries with
nvcc (`kernels.build.build`, ~19 s on an H100) and the host PNG decoder
(`kernels.build.load_host`), and allocates at each new shape. A server
that meets them mid-stream stalls its streams. Run this once per
deployment instead, with the shapes the server will use:

    python -m of_dis_tpu_torch.tools.warmup --w 1024 --h 436 --batch 64 \\
        --ops 1,2 --modes of_int,de_int

It builds every library into `build/of_dis_tpu_torch/`, where every later
process of the same checkout finds them, then makes one call of
`dis_flow_batched` per (mode, op-point, batch), printing

  warm {mode} op={op} batch={b} {w}x{h}: ...s

Modes mirror the CLI binaries (of/de x int/rgb; grd runs the int shapes
and needs no entry of its own). --seq also runs a 3-frame
`dis_sequence_batched` per flow entry (the warm-start step). With
`--device cpu` nothing is compiled for the card: the host decoder is
built and every call runs the plain twins.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import pyramid
from of_dis_tpu_torch.params import op_point_params

MODE_SPEC = {"of_int": (2, 1), "of_rgb": (2, 3), "de_int": (1, 1),
             "de_rgb": (1, 3)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--h", type=int, default=436)
    ap.add_argument("--batch", default="64",
                    help="batch size; comma-separated sizes also accepted")
    ap.add_argument("--ops", default="2",
                    help="comma-separated op-points (1-4)")
    ap.add_argument("--modes", default="of_int",
                    help="comma-separated: of_int, of_rgb, de_int, de_rgb")
    ap.add_argument("--seq", action="store_true",
                    help="also warm the sequence-mode (warm-start) step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dis.resolve_device(args.device)
    batches = [int(b) for b in str(args.batch).split(",")]
    ops = [int(o) for o in args.ops.split(",")]
    modes = args.modes.split(",")
    for mode in modes:
        if mode not in MODE_SPEC:
            raise ValueError(f"unknown mode {mode!r}; one of "
                             f"{', '.join(MODE_SPEC)}")

    t0 = time.perf_counter()
    names = build.build() if dev.type == "cuda" else {}
    build.load_host("io_native")
    print(f"build: {time.perf_counter() - t0:.1f}s ({len(names)} CUDA "
          "libraries, the host decoder)", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    for mode in modes:
        nop, noc = MODE_SPEC[mode]
        for op in ops:
            params = op_point_params(args.w, op, nop=nop, noc=noc)
            for b in batches:
                raw = torch.as_tensor(rng.integers(
                    0, 256, (b, noc, args.h, args.w), dtype=np.uint8)).to(dev)
                im = pyramid.pad_to_divisible(raw, params.sc_f)
                fh, fw = im.shape[-2], im.shape[-1]
                t0 = time.perf_counter()
                dis.dis_flow_batched(im, im, params, fw, fh, device=dev)
                sync()
                print(f"warm {mode} op={op} batch={b} {args.w}x{args.h}: "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
                if args.seq and nop == 2:
                    seq = pyramid.pad_to_divisible(torch.stack([raw] * 3),
                                                   params.sc_f + 1)
                    t0 = time.perf_counter()
                    dis.dis_sequence_batched(seq, params, seq.shape[-1],
                                             seq.shape[-2], device=dev)
                    sync()
                    print(f"warm {mode} op={op} batch={b} seq: "
                          f"{time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
