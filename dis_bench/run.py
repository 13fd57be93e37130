"""One run of one benchmark cell of the port, on the card.

    python -m dis_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell's entry in `BENCHMARK.json` names
its configuration (`configs/<config>.json`) and traffic mix
(`traffic/<traffic>.json`); its limits are `limits/<workload>.json`, each
per-layer metric's reader `metrics/<metric>.py` and each kernel's work
count `work/<kernel>.py`. The run makes its inputs on the card from the
seed, warms up the cell's shapes (set-up), measures for `--seconds`,
and with `--trace 1` also runs a short stretch under `torch.profiler`.
Then it compares a sample of what the window produced, drawn from the
seed, with the plain reference (`reference/<name>.py`) and prints one
JSON line last: the end-to-end metrics (`--trace 0`) or the per-layer
ones (`--trace 1`), whether the outputs are correct, the device, and
each number compared beside its limit.

It exits non-zero, with no result, without a card (it never falls back to
the CPU), with fewer cards than the cell asks for, or if `jax`, `jaxlib`,
`flax` or the JAX package `of_dis_tpu` is loaded once the window has
closed. The program's kernels build into the checkout's
`build/of_dis_tpu_torch/` on the first run there.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "of_dis_tpu")
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict, kind: str) -> list:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list the cell under `workloads`, or list none."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def load_file(path: Path):
    """A module from a file by path (metric readers are named with dots)."""
    spec = importlib.util.spec_from_file_location(
        "dis_bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


class TraceContext:
    """What a per-layer reader reads: the traced stretch's device and host
    events, their categories, busy time and wall, the window's host
    dispatch spans and step times, and the cell's shapes."""

    def __init__(self, loop, calls: int, dev_events, host_events, hand):
        from dis_bench import trace

        self.kind = loop.kind
        self.loop, self.calls = loop, calls
        self.pairs_per_call = loop.pairs_per_call()
        self.events, self.host = dev_events, host_events
        self.categories = [trace.category(e.name, hand) for e in dev_events]
        everything = dev_events + host_events
        self.t0_us = min((e.start_us for e in everything), default=0.0)
        self.t1_us = max((e.start_us + e.dur_us for e in everything),
                         default=0.0)
        self.window_us = self.t1_us - self.t0_us
        self.busy_us = trace.union_us(dev_events)
        self.spans, self.steps = loop.spans, loop.steps

    def roofline(self, name: str):
        """A kernel's share of its roofline in %, or None where its
        library ran no kernel in the stretch."""
        from dis_bench import peaks

        work = load_file(HERE / "work" / f"{name}.py")
        us = sum(e.dur_us for e, c in zip(self.events, self.categories)
                 if c == f"hand: {work.LIBRARY}")
        if us <= 0:
            return None
        least = peaks.least_s(*work.work(self.pairs_per_call,
                                         self.loop.full_w, self.loop.full_h,
                                         self.loop.params))
        return 100.0 * least / (us / 1e6 / self.calls)


def traced_stretch(loop, calls: int):
    """`calls` calls after a synchronize, under torch.profiler; the
    reader's context and the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dis_bench import trace
    from of_dis_tpu_torch.kernels import build

    hand = trace.hand_kernels(Path(build.SRC_DIR))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.stretch(calls)
    dev = trace.device_events(prof)
    host = trace.host_events(prof)
    ctx = TraceContext(loop, calls, dev, host, hand)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.dur_us
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace.gaps(dev, ctx.t0_us, ctx.t1_us),
                  key=lambda g: g[0] - g[1])[:10]
    breakdown = {
        "device_ops": [[n[:160], us / 1e6] for n, us in ops],
        "idle_gaps": [[trace.host_during(host, a, b)[:160], (b - a) / 1e6]
                      for a, b in idle]}
    return ctx, breakdown


def make_loop(cell: dict, seed: int, device, traffic: dict = None):
    """(configuration, traffic, loop) of a cell: the loop of its traffic's
    kind, driving the port with the configuration's parameters. `traffic`
    replaces the cell's traffic file."""
    import torch

    from dis_bench import geometry, loops
    from of_dis_tpu_torch.params import DISParams

    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    if traffic is None:
        traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    params = geometry.params_for(cfg, traffic["width"])
    prog_params = DISParams(**{f: getattr(params, f)
                               for f in ("sc_f", "sc_l")
                               + geometry.PARAM_KEYS})
    loop = loops.KINDS[traffic["kind"]](traffic, params, prog_params, seed,
                                        torch.device(device))
    return cfg, traffic, loop


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float = _T0,
             traffic: dict = None) -> dict:
    """The result line of one run (see the module docstring). `traffic`
    replaces the cell's traffic file (a small mix for a test on the
    CPU)."""
    import torch

    limits = load_json(HERE / "limits" / f"{cell['name']}.json")
    torch.set_num_threads(1)
    cfg, traffic, loop = make_loop(cell, seed, device, traffic)
    t_loop = time.perf_counter()
    loop.setup()
    setup_s = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = loop.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = breakdown = None
    if trace:
        ctx, breakdown = traced_stretch(loop, traffic["trace_calls"])
    inputs = loop.check_inputs()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reference = importlib.import_module(
        f"dis_bench.reference.{cfg['reference']}")
    t_check = time.perf_counter()
    with torch.no_grad():
        got = loop.check(reference, inputs, traffic["ref_block"])
    dispatch = sorted(e - s for s, e in loop.spans)
    print(f"setup {setup_s:.3f} s (start to loop {t_loop - t0:.3f}, inputs "
          f"{loop.setup_parts['inputs_s']:.3f}, warm-up "
          f"{loop.setup_parts['warm_up_s']:.3f}), window {win['wall_s']:.3f} "
          f"s, {win['calls']} calls, median dispatch "
          f"{dispatch[len(dispatch) // 2] * 1e3:.3f} ms, reference check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        metrics = {}
        for m in metrics_of(bench, cell, "per_layer"):
            v = load_file(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = ctx.busy_us / 1e6
        device_info["window_s"] = ctx.window_us / 1e6
    else:
        have = {"setup_s": setup_s, "peak_mem_gib": peak / GIB,
                "pairs_per_s": win["pairs_per_s"]}
        metrics = {m["name"]: {"value": have[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, cell, "end_to_end")}
    out = {"correct": correct, "attempted": win["pairs"], "failed": 0,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark "
                                             "cell of the port on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
