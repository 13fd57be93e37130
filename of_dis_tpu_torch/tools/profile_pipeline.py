"""Device profile of the port's batched pipeline, on `torch.profiler`: the
counterpart of the JAX package's `tools/profile_pipeline.py`.

Runs one call of `dis_flow_batched` (op-point 2 by default) on B Sintel-
sized 1024x436 u8 pairs of the synthetic workload (`tools/synth.py`) after
a warm-up call, under the profiler, and prints

  - the device total (ms, and us a pair);
  - device ms by category: each hand-written kernel by its library
    (`csrc/<library>.cu`), GEMM, copy, gather/index, reduction,
    elementwise, other;
  - device ms by kernel, grouped by category;
  - the biggest single kernels;
  - per stream, busy over span (first start to last end), and the busy
    share of the call's unprofiled wall;
  - the largest gaps between kernels on the busiest stream, each with
    the innermost program span open over it (`trace`: the markers the
    program stamps on the profiler's clock, e.g. `L3.pconst`, `upload`);
  - the wall of one more unprofiled call, after the profile, beside the
    one before it (whether a profiler session slows what follows).

Usage:
  python -m of_dis_tpu_torch.tools.profile_pipeline [batch] [op] [seq|fb|rgb]
      [--device cuda|cpu]
batch defaults to 64, op to 2. `seq` profiles `dis_sequence_batched` on
[batch] streams x 5 frames (4 warm steps); `fb` the forward-backward
merge; `rgb` RGB frames. With `--device cpu` the same report reads the
host's top-level operators (their wall time on the host), since there is
no device.

`profile_call` and `busy_ms` are the profile readers of `chip_smoke.py`
and `tools/bench.py`.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

import torch

from of_dis_tpu_torch import trace
from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import pyramid
from of_dis_tpu_torch.params import op_point_params
from of_dis_tpu_torch.tools import synth

H, W = 436, 1024
SEQ_FRAMES = 5
# name patterns of the library kernels (CUDA symbol names) and of the
# plain operators (aten names on the CPU), tried in this order
CATEGORIES = (
    ("gemm", r"gemm|cutlass|xmma|cublas|aten::(mm|bmm|addmm|baddbmm|matmul"
             r"|einsum|linear)$"),
    ("copy", r"memcpy|memset|copy|catarray|aten::(cat|stack|clone|contiguous"
             r"|to|_to_copy|copy_|constant_pad_nd|pad)$"),
    ("gather/index", r"index|gather|scatter|take"),
    ("reduction", r"reduce|aten::(sum|mean|amax|amin|max|min|median|norm"
                  r"|linalg_vector_norm|all|any)$"),
    ("elementwise", r"elementwise|vectorized|unrolled|aten::"),
)


class Event(NamedTuple):
    name: str
    start_us: float
    dur_us: float
    track: int


def hand_kernels() -> Dict[str, str]:
    """CUDA symbol name of every `__global__` function of `csrc/` -> the
    library (source file stem) it belongs to."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    return {name: src.stem for src in sorted(Path(build.SRC_DIR).glob("*.cu"))
            for name in pat.findall(src.read_text())}


def category(name: str, hand: Dict[str, str]) -> str:
    """The category of a kernel or operator name (see CATEGORIES)."""
    for sym, lib in hand.items():
        if re.search(rf"\b{sym}\b", name):
            return f"hand: {lib}"
    low = name.lower()
    for cat, pat in CATEGORIES:
        if re.search(pat, low):
            return cat
    return "other"


def events(prof, device_type: str) -> List[Event]:
    """What ran, from a finished profile: on "cuda" every device activity
    (kernels, copies, fills) on its stream; on "cpu" the host's top-level
    operators on their thread."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if device_type == "cuda":
            if e.device_type != DeviceType.CUDA:
                continue
            track = getattr(e, "device_resource_id", e.thread)
        else:
            if e.device_type != DeviceType.CPU or e.cpu_parent is not None:
                continue
            track = e.thread
        out.append(Event(e.name, e.time_range.start,
                         e.time_range.elapsed_us(), track))
    return sorted(out, key=lambda ev: ev.start_us)


class ProgramSpan(NamedTuple):
    key: str
    start_us: float
    end_us: float
    depth: int          # 0 for the call


def program_spans(prof) -> List[ProgramSpan]:
    """The program's spans in a finished profile, paired from the markers
    `trace` stamps at each span's start and end (`of_dis:<key>:b`,
    `of_dis:<key>:e`)."""
    marks = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith(trace.MARK))
    out, stack = [], []
    for t, name in marks:
        key, edge = name[len(trace.MARK):].rsplit(":", 1)
        if edge == "b":
            stack.append((key, t))
        elif stack and stack[-1][0] == key:
            _, t0 = stack.pop()
            out.append(ProgramSpan(key, t0, t, len(stack)))
    return out


def span_over(spans: List[ProgramSpan], start_us: float,
              end_us: float) -> str:
    """The key of the innermost program span open at the middle of
    [start_us, end_us], or "-"."""
    mid = (start_us + end_us) / 2
    best = None
    for sp in spans:
        if sp.start_us <= mid <= sp.end_us and (best is None
                                                or sp.depth > best.depth):
            best = sp
    return best.key if best is not None else "-"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile(fn, device):
    """One call of fn under torch.profiler, synchronized; the profile."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        fn()
        sync(device)
    return prof


def busy_ms(fn, device, tries: int = 3) -> float:
    """Device ms of one call of fn on the card: the summed durations of
    every device activity of a profiled call (one stream: they do not
    overlap). Raises if `tries` profiles in a row see no device activity
    (a call that launches nothing, or a profiler that lost its trace)."""
    for _ in range(tries):
        evs = events(profile(fn, device), "cuda")
        if evs:
            return sum(e.dur_us for e in evs) / 1e3
    raise RuntimeError(f"{tries} profiles saw no device activity")


def profile_call(label, fn, wall_s: float, top: int = 12) -> None:
    """Device time by kernel over one call under torch.profiler, and the
    device's busy share of the call's unprofiled wall time `wall_s` (one
    stream: kernels do not overlap, so their sum is the busy time)."""
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events(profile(fn, "cuda"), "cuda"):
        if e.dur_us > 0:
            by_name[e.name][0] += e.dur_us
            by_name[e.name][1] += 1
    rows = sorted(((us, count, key) for key, (us, count) in by_name.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    print(json.dumps({"profile": label, "device_busy_ms": busy,
                      "wall_ms": wall_s * 1e3,
                      "busy_share": busy / (wall_s * 1e3),
                      "kernels": len(rows),
                      "launches": sum(r[1] for r in rows)}), flush=True)
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3:9.4f} ms {count:5d}x  {key[:90]}")


def report(evs: List[Event], pairs: int, where: str, wall_s=None,
           top: int = 15, spans: List[ProgramSpan] = ()) -> dict:
    """Print the profile's sections (see the module docstring) and return
    their numbers: total, by category and by stream, in ms. `spans`
    (`program_spans`) name the program span over each gap."""
    hand = hand_kernels()
    cats = [category(e.name, hand) for e in evs]
    total = sum(e.dur_us for e in evs)
    print(f"{where} total: {total / 1e3:.3f} ms "
          f"({total / max(pairs, 1):.1f} us/pair at {pairs} pairs), "
          f"{len(evs)} activities")
    by_cat = collections.defaultdict(float)
    n_cat = collections.Counter()
    by_name = collections.defaultdict(float)
    n_name = collections.Counter()
    for e, c in zip(evs, cats):
        by_cat[c] += e.dur_us
        n_cat[c] += 1
        by_name[(c, e.name)] += e.dur_us
        n_name[(c, e.name)] += 1
    print(f"\n{where} ms by category:")
    for c, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"{us / 1e3:9.3f} ms  x{n_cat[c]:5d}  {c}")
    print(f"\n{where} ms by kernel, grouped by category:")
    for c, _ in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        names = sorted(((us, name) for (cc, name), us in by_name.items()
                        if cc == c), reverse=True)
        print(f"  {c}:")
        for us, name in names[:top]:
            print(f"  {us / 1e3:9.3f} ms  x{n_name[(c, name)]:5d}  "
                  f"{name[:90]}")
    print("\nbiggest single activities:")
    for e, c in sorted(zip(evs, cats), key=lambda ec: -ec[0].dur_us)[:12]:
        print(f"{e.dur_us / 1e3:8.3f} ms  [{c}]  {e.name[:100]}")

    tracks = collections.defaultdict(list)
    for e in evs:
        tracks[e.track].append(e)
    print("\nper stream busy / span:" if where == "device"
          else "\nper thread busy / span:")
    streams = {}
    for t, es in sorted(tracks.items(),
                        key=lambda kv: -sum(e.dur_us for e in kv[1])):
        busy = sum(e.dur_us for e in es)
        span = max(e.start_us + e.dur_us for e in es) - es[0].start_us
        streams[t] = dict(busy_ms=busy / 1e3, span_ms=span / 1e3)
        print(f"  {t!s:>8}: busy {busy / 1e3:9.3f} ms  span "
              f"{span / 1e3:9.3f} ms  busy/span {busy / max(span, 1e-9):.3f}"
              f"  x{len(es)}")
    if wall_s:
        what = ("busy share" if where == "device"
                else "operator time over the wall")
        print(f"{what} of the unprofiled call ({wall_s * 1e3:.3f} ms): "
              f"{total / 1e3 / (wall_s * 1e3):.3f}")
    gaps = []
    if tracks:
        main = max(tracks, key=lambda t: sum(e.dur_us for e in tracks[t]))
        es = tracks[main]
        for a, b in zip(es, es[1:]):
            end = a.start_us + a.dur_us
            g = b.start_us - end
            if g > 0:
                gaps.append((g, a.name, b.name,
                             span_over(spans, end, b.start_us)))
        gaps.sort(reverse=True)
        print(f"\ngaps on {main}: {len(gaps)} totaling "
              f"{sum(gap[0] for gap in gaps) / 1e3:.3f} ms; top {top}:")
        for g, na, nb, sp in gaps[:top]:
            print(f"{g / 1e3:8.3f} ms  in {sp:12s} after {na[:40]:40s} "
                  f"before {nb[:40]}")
    return dict(total_ms=total / 1e3,
                by_category_ms={c: us / 1e3 for c, us in by_cat.items()},
                streams=streams,
                gaps_ms=sum(gap[0] for gap in gaps) / 1e3)


def workload(batch: int, op: int, variant: str, device, h: int = H,
             w: int = W):
    """The call to profile and the pairs it computes: `dis_flow_batched` on
    `batch` synthetic pairs, or with variant "seq" `dis_sequence_batched`
    on `batch` streams x SEQ_FRAMES frames."""
    noc = 3 if variant == "rgb" else 1
    params = op_point_params(w, op, nop=2, noc=noc)
    if variant == "fb":
        params = dataclasses.replace(params, usefbcon=True)
    if variant == "seq":
        frames, _, _ = synth.make_sequence(batch, SEQ_FRAMES, h, w, 0, device)
        frames = pyramid.pad_to_divisible(frames, params.sc_f + 1)
        fh, fw = frames.shape[-2], frames.shape[-1]
        return (lambda: dis.dis_sequence_batched(frames, params, fw, fh,
                                                 device=device),
                batch * (SEQ_FRAMES - 1))
    a, b, _, _ = synth.make_pairs(batch, h, w, 0, device, channels=noc)
    a = pyramid.pad_to_divisible(a, params.sc_f)
    b = pyramid.pad_to_divisible(b, params.sc_f)
    fh, fw = a.shape[-2], a.shape[-1]
    return (lambda: dis.dis_flow_batched(a, b, params, fw, fh,
                                         device=device), batch)


def main(argv=None, h: int = H, w: int = W) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=64)
    ap.add_argument("op", type=int, nargs="?", default=2)
    ap.add_argument("variant", nargs="?", default="",
                    choices=("", "seq", "fb", "rgb"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dis.resolve_device(args.device)
    fn, pairs = workload(args.batch, args.op, args.variant, dev, h, w)
    fn()                                    # build, allocate, warm up
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    wall = time.perf_counter() - t0
    print(f"op{args.op} {args.variant or 'pairs'} batch {args.batch} "
          f"{w}x{h} on {dev}: wall {wall * 1e3:.3f} ms unprofiled")
    prof = profile(fn, dev)
    res = report(events(prof, dev.type), pairs,
                 "device" if dev.type == "cuda" else "host", wall,
                 spans=program_spans(prof))
    t0 = time.perf_counter()
    fn()
    sync(dev)
    res["wall_after_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"\nwall of one unprofiled call after the profile: "
          f"{res['wall_after_ms']:.3f} ms (before: {wall * 1e3:.3f} ms)")
    return res


if __name__ == "__main__":
    main()
