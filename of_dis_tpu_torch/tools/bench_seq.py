"""Sequence-mode throughput on the card: S streams advance in lockstep
with warm starts (`dis_sequence_batched`), then the same pairs as cold
batches of S (`dis_flow_batched`, no warm start). The counterpart of the
JAX package's `tools/bench_seq.py`.

Usage: python -m of_dis_tpu_torch.tools.bench_seq [op_point] [streams]
           [frames] [--device cuda|cpu]
(defaults 3, 4, 9). Frame t of stream s is the synthetic base frame s
backward-warped by t times the flow field (`synth.make_sequence`), so
consecutive frames move by about the field. Each mode runs once to build
and warm up, then once timed (host clock, one synchronize at the end).
"""

from __future__ import annotations

import argparse
import time

from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import pyramid
from of_dis_tpu_torch.params import op_point_params
from of_dis_tpu_torch.tools import bench, profile_pipeline, synth


def main(argv=None, h: int = bench.H, w: int = bench.W) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default in (("op", 3), ("streams", 4), ("frames", 9)):
        ap.add_argument(name, type=int, nargs="?", default=default)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dis.resolve_device(args.device)
    op, s, t = args.op, args.streams, args.frames
    params = op_point_params(w, op, nop=2, noc=1)
    frames, _, _ = synth.make_sequence(s, t, h, w, bench.SEED, dev)
    fr = pyramid.pad_to_divisible(frames, params.sc_f + 1)
    fh, fw = fr.shape[-2], fr.shape[-1]
    pairs = s * (t - 1)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        profile_pipeline.sync(dev)
        return time.perf_counter() - t0, out

    def seq():
        return dis.dis_sequence_batched(fr, params, fw, fh, device=dev)

    warm, _ = timed(seq)
    print(f"compile+warm {warm:.1f}s")
    dt, seq_out = timed(seq)
    print(f"seq op{op} S={s} T={t}: {pairs / dt:.1f} pairs/s "
          f"({dt * 1e3 / pairs:.1f} ms/pair)")

    # the same pairs as one cold batch of S a step: no warm start
    def cold():
        return [dis.dis_flow_batched(fr[i], fr[i + 1], params, fw, fh,
                                     device=dev) for i in range(t - 1)]

    warm, _ = timed(cold)
    print(f"  compile+warm batched-b{s} {warm:.1f}s")
    dt_cold, cold_out = timed(cold)
    print(f"cold-batch b={s} x{t - 1}: {pairs / dt_cold:.1f} pairs/s "
          f"({dt_cold * 1e3 / pairs:.1f} ms/pair)")
    return dict(seq_pairs_per_s=pairs / dt, cold_pairs_per_s=pairs / dt_cold,
                seq=seq_out, cold=cold_out)


if __name__ == "__main__":
    main()
