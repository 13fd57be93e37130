"""Device activity from a `torch.profiler` trace: what ran on the card, by
name and category, how long the card was busy, and where it sat idle.

The event and category arithmetic is a frozen copy of the port's
`tools/profile_pipeline.py` (`events`, `category`, `hand_kernels`);
`union_us`, `gaps` and `host_during` are the benchmark's own.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, NamedTuple

# name patterns of the library kernels (CUDA symbol names), tried in order
CATEGORIES = (
    ("gemm", r"gemm|cutlass|xmma|cublas"),
    ("copy", r"memcpy|memset|copy|catarray"),
    ("gather/index", r"index|gather|scatter|take"),
    ("reduction", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


class Event(NamedTuple):
    name: str
    start_us: float
    dur_us: float
    track: int


def hand_kernels(csrc: Path) -> Dict[str, str]:
    """CUDA symbol name of every `__global__` function of the program's
    `csrc/*.cu` -> the source file stem (the library) it belongs to."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    return {name: src.stem for src in sorted(Path(csrc).glob("*.cu"))
            for name in pat.findall(src.read_text())}


def category(name: str, hand: Dict[str, str]) -> str:
    """"hand: <library>" for a hand-written kernel, else the first
    CATEGORIES entry whose pattern the name matches, else "other"."""
    for sym, lib in hand.items():
        if re.search(rf"\b{sym}\b", name):
            return f"hand: {lib}"
    low = name.lower()
    for cat, pat in CATEGORIES:
        if re.search(pat, low):
            return cat
    return "other"


def device_events(prof) -> List[Event]:
    """Every device activity (kernels, copies, fills) of a finished
    profile, on its stream, in start order."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        out.append(Event(e.name, e.time_range.start,
                         e.time_range.elapsed_us(),
                         getattr(e, "device_resource_id", e.thread)))
    return sorted(out, key=lambda ev: ev.start_us)


def host_events(prof) -> List[Event]:
    """The host's top-level operators of a finished profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type != DeviceType.CPU or e.cpu_parent is not None:
            continue
        out.append(Event(e.name, e.time_range.start,
                         e.time_range.elapsed_us(), e.thread))
    return sorted(out, key=lambda ev: ev.start_us)


def union_us(evs: List[Event]) -> float:
    """Microseconds in which at least one activity ran (overlaps across
    streams counted once)."""
    total, end = 0.0, None
    for e in sorted(evs, key=lambda ev: ev.start_us):
        s, f = e.start_us, e.start_us + e.dur_us
        if end is None or s > end:
            total += f - s
            end = f
        elif f > end:
            total += f - end
            end = f
    return total


def gaps(evs: List[Event], t0_us: float, t1_us: float):
    """[(start_us, end_us)] where no activity ran in [t0_us, t1_us]."""
    out, cur = [], t0_us
    for e in sorted(evs, key=lambda ev: ev.start_us):
        if e.start_us > cur:
            out.append((cur, min(e.start_us, t1_us)))
        cur = max(cur, e.start_us + e.dur_us)
    if t1_us > cur:
        out.append((cur, t1_us))
    return [(a, b) for a, b in out if b > a]


def host_during(host: List[Event], start_us: float, end_us: float) -> str:
    """The host operator that overlaps [start_us, end_us] the most, or
    "(no operator)"."""
    best, name = 0.0, "(no operator)"
    for e in host:
        o = min(end_us, e.start_us + e.dur_us) - max(start_us, e.start_us)
        if o > best:
            best, name = o, e.name
    return name
