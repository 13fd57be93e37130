"""Quick throughput check of any op-point on the card: the counterpart of
the JAX package's `tools/bench_op.py`.

Usage: python -m of_dis_tpu_torch.tools.bench_op [op_point] [batch] [iters]
           [noc] [nop] [--device cuda|cpu]
(defaults 3, 8, 3, 1, 2). Times `dis_flow_batched` on Sintel-sized
1024x436 u8 pairs of the synthetic workload (`tools/synth.py`; depth pairs
by its disparity field) with `tools/bench.py`'s timing (one warm-up call,
then `iters` back-to-back calls, one synchronize at the end) and prints

  op{op} noc= nop= b= iters=: ... pairs/s (... ms/batch, compile+warm ...s)
"""

from __future__ import annotations

import argparse

from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import pyramid
from of_dis_tpu_torch.params import op_point_params
from of_dis_tpu_torch.tools import bench, synth


def main(argv=None, h: int = bench.H, w: int = bench.W) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default in (("op", 3), ("batch", 8), ("iters", 3), ("noc", 1),
                          ("nop", 2)):
        ap.add_argument(name, type=int, nargs="?", default=default)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dis.resolve_device(args.device)
    params = op_point_params(w, args.op, nop=args.nop, noc=args.noc)
    field = synth.flow_field if args.nop == 2 else synth.disparity_field
    a8, b8, _, _ = synth.make_pairs(args.batch, h, w, bench.SEED, dev,
                                    channels=args.noc, field=field)
    a = pyramid.pad_to_divisible(a8, params.sc_f)
    b = pyramid.pad_to_divisible(b8, params.sc_f)
    dt, warm, _ = bench.time_calls(params, a, b, args.iters, a.shape[-1],
                                   a.shape[-2], dev)
    pairs = args.batch * args.iters / dt
    print(f"op{args.op} noc={args.noc} nop={args.nop} b={args.batch} "
          f"iters={args.iters}: {pairs:.1f} pairs/s "
          f"({dt / args.iters * 1e3:.1f} ms/batch, compile+warm {warm:.1f}s)")
    return pairs


if __name__ == "__main__":
    main()
