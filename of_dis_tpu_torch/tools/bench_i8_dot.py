"""Tensor-core dot microbenchmark (T1): how fast do int8 x int8 -> int32
products run on the card beside bf16 x bf16 -> float32 ones, at the GN
extraction's product shape?

out[g] = sum_{i < reps} A @ B[:, n i : n i + n] for g < grid, on the kernel
`kernels.i8_dot` (csrc/i8_dot.cu), with the JAX package's
tools/bench_i8_dot.py defaults: (832, 256) @ (256, 256), reps 64, grid 64.
Inputs come from numpy.random.default_rng(0) as the JAX tool draws them: A
integers in [-127, 127), B 1 where a uniform draw is below 0.01. Every value
is a small integer, so both products are exact.

Prints ms, T(FL)OP/s and the int8 speedup over bf16.

Usage: python -m of_dis_tpu_torch.tools.bench_i8_dot [reps] [grid] [m] [k]
           [n] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from of_dis_tpu_torch.kernels import i8_dot
from of_dis_tpu_torch.tools.bench_gn_stages import time_ms


def make_inputs(reps: int, m: int, k: int, n: int, device) -> dict:
    """A (m, k) and Bt = B^T (reps n, k), int8 and bf16, on `device`."""
    rng = np.random.default_rng(0)
    a8 = rng.integers(-127, 127, (m, k), np.int8)
    b8 = (rng.random((k, n * reps)) < 0.01).astype(np.int8)
    a = torch.as_tensor(a8).to(device)
    bt = torch.as_tensor(np.ascontiguousarray(b8.T)).to(device)
    return {torch.int8: (a, bt),
            torch.bfloat16: (a.to(torch.bfloat16), bt.to(torch.bfloat16))}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k:k + 2]
    reps, grid, m, k, n = (int(argv[i]) if len(argv) > i else default
                           for i, default in enumerate((64, 64, 832, 256,
                                                        256)))
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "the plain twin")
    inputs = make_inputs(reps, m, k, n, dev)
    ops = 2.0 * m * k * n * reps * grid
    res = {}
    for name, dtype in (("bf16 -> f32", torch.bfloat16),
                        ("int8 -> int32", torch.int8)):
        a, bt = inputs[dtype]
        out = i8_dot.dot_sum(a, bt, n, grid)
        ms = time_ms(lambda: i8_dot.dot_sum(a, bt, n, grid), 5, dev)
        res[name] = dict(ms=ms, ops=ops, out=out)
        print(f"{name}: {ms:.3f} ms  {ops / ms / 1e9:.1f} T(FL)OPS/s  "
              f"(checksum {out[0, 0, 0].item()})", flush=True)
    print(f"i8 speedup over bf16: "
          f"{res['bf16 -> f32']['ms'] / res['int8 -> int32']['ms']:.2f}x",
          flush=True)
    return res


if __name__ == "__main__":
    main()
