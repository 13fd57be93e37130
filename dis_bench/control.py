"""The readings that a cell's limits are set from, on the card:

    python -m dis_bench.control --workload <name> --seeds 1,2,3 \\
        [--seconds 2] [--control-seeds 1,2,3]

For every seed of `--seeds`, the program's readings: the cell's own
traffic and entry at its own sizes, a short window of `--seconds`, the
sample the run would compare, held against the reference. For every seed
of `--control-seeds`, the control's: the reference put in the program's
place and computed with TF32 matrix products (the precision below the
configuration's float32 with TF32 off), on the same sample, held
against the reference. One JSON line a reading. The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from dis_bench import loops, run


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def control_outputs(loop, reference, inputs, block: int):
    """The sample the loop keeps, as the TF32 reference computes it in the
    program's place: for a batch the kept pairs, for streams each kept
    step from the carry of the program's flow of the step before, and
    the carry of that step summed in float32 (the program states
    float64 for it)."""
    set_tf32(True)
    try:
        if isinstance(loop, loops.BatchLoop):
            out = []
            for a, b, _ in inputs:
                r = torch.cat([reference.flow(a[lo:lo + block],
                                              b[lo:lo + block], loop.params)
                               for lo in range(0, a.shape[0], block)])
                out.append((a, b, r))
            return out
        vids = inputs
        for key, (k, prev, _, _) in list(loop.kept.items()):
            i, j = loops.pingpong(k, loop.traffic["frames"])
            flow = torch.cat([
                reference.flow(vids[i, lo:lo + block], vids[j, lo:lo + block],
                               loop.params,
                               loop.ref_carry(reference, prev, vids, lo, block))
                for lo in range(0, vids.shape[1], block)])
            loop.kept[key] = (k, prev, flow, reference.carry_of(
                flow, loop.params.sc_f, acc=torch.float32))
        return vids
    finally:
        set_tf32(False)


def readings(cell: dict, seed: int, seconds: float, control: bool,
             traffic: dict = None) -> dict:
    """The program's readings on one seed, and with `control` the
    control's; `traffic` replaces the cell's traffic file."""
    cfg, traffic, loop = run.make_loop(cell, seed, "cuda", traffic)
    loop.setup()
    win = loop.window(seconds)
    inputs = loop.check_inputs()
    torch.cuda.empty_cache()
    reference = importlib.import_module(
        f"dis_bench.reference.{cfg['reference']}")
    set_tf32(False)
    out = {"workload": cell["name"], "seed": seed, "calls": win["calls"]}
    with torch.no_grad():
        t = time.perf_counter()
        out["program"] = loop.check(reference, inputs, traffic["ref_block"])
        out["check_s"] = time.perf_counter() - t
        if control:
            inputs = control_outputs(loop, reference, inputs,
                                     traffic["ref_block"])
            out["control"] = loop.check(reference, inputs,
                                        traffic["ref_block"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = run.find_cell(run.load_json(run.ROOT / "BENCHMARK.json"),
                         args.workload)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(cell, s, args.seconds, s in ctrl)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
