"""Spans and counters of the port: where an entry call's host time goes,
what it launched, and what it copied from host memory to the device.

Counters, always on, each an add or two:
  - per span key, its count and its total host nanoseconds
    (`time.perf_counter_ns` at `begin` and `end`);
  - per kernel library and C symbol, its launches (`count_launch`, called
    by `kernels.build.launch`, the one path of every hand-written kernel);
  - `call`: the span of every entry call (`call`, `entry`), so its count
    is the number of calls. Entries reached from another entry
    (`dis_flow_full` through `dis_flow`, `dis_sequence` through
    `dis_flow_full`) are part of the outer call.
`counters()` reads them; they cover the process's life, or its life
after its first call, which carries the one-time costs (the kernels'
build and load, CUDA's start-up, the uploads of the tables the program
keeps).

Span keys nest as the work does: `call`; `pyramid` and `grid`; per scale
`L<sl>` with the reference's five stages `L<sl>.pconst`, `.pinit`,
`.poptim`, `.cflow`, `.tvopt`; `upscale` (kernel K4) and `carry`
(`warm_start_from_full`); and `upload`, every copy the program makes from
host memory to the device (`upload`, the one place it makes one). A span
is a `begin` / `end` pair, not a context manager: a `with` block costs
more than the two clock reads, and a call opens ~60 spans.

The timeline is on for an entry call when a `torch.profiler` session is
active as the call starts, and in the verbosity-2 path (`call(settle=)`).
Then each span is also recorded, in memory (`spans()`): its key, its
level where it has one, start and end in ns, its id, its parent's id and
its call's id; and its start and end are marked on the profiler's own
clock by a zero-length `record_function` (`of_dis:<key>:b`,
`of_dis:<key>:e`). A marker closes before anything else runs, so it is
the parent of no operator: the top-level operators of a profile are those
of the same profile without markers, and a trace viewer or
`tools/profile_pipeline.py` can place each stretch of the device's
timeline under the program span that was open over it.

Spans keep their nesting for calls made from one thread at a time, as
the port's entries are driven.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

MARK = "of_dis:"             # prefix of the profiler markers

_now = time.perf_counter_ns
_acc: Dict[str, List[int]] = {}             # key -> [count, ns]
_first: Dict[str, Tuple[int, int]] = {}     # _acc at the first call's end
_launches: Dict[Tuple[str, str], int] = {}
_on = False                  # the open call records its spans
_settle = None               # the CUDA device its spans synchronize at
_depth = 0                   # entry calls open, nested ones included
_call_id = 0
_stack: List[int] = []       # ids of the open recorded spans
_records: List[list] = []    # [key, level, start, end, parent, call]


class Span(NamedTuple):
    """One recorded span: `name` is its key, `level` the scale it belongs
    to (or None), times in `time.perf_counter_ns` nanoseconds."""
    name: str
    level: Optional[int]
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: int


def _mark(label: str) -> None:
    with torch.autograd.profiler.record_function(label):
        pass


def _open(key: str, level) -> None:
    _mark(MARK + key + ":b")
    _stack.append(len(_records))
    _records.append([key, level, 0, 0, _stack[-2] if len(_stack) > 1
                     else None, _call_id])


def _close(t0: int, t1: int) -> None:
    rec = _records[_stack.pop()]
    rec[2], rec[3] = t0, t1
    _mark(MARK + rec[0] + ":e")


def begin(key: str, level: Optional[int] = None) -> int:
    """Open span `key` (of scale `level`, if it has one): its start, for
    `end`."""
    if _on:
        _open(key, level)
    return _now()


def end(key: str, t0: int) -> None:
    """Close span `key`, opened by `begin` at `t0`: counted and, while the
    timeline is on, recorded and marked. In the verbosity-2 path the span
    ends in a synchronize of the card, so it holds the card's work too."""
    if _on:
        if _settle is not None:
            torch.cuda.synchronize(_settle)
        t1 = _now()
        _close(t0, t1)
    else:
        t1 = _now()
    try:
        acc = _acc[key]
    except KeyError:
        acc = _acc[key] = [0, 0]
    acc[0] += 1
    acc[1] += t1 - t0


class call:
    """`with call():` the span of an entry call, key `call`. The outermost
    entry opens it: it decides whether the call's timeline is on (a
    profiler session active, or `settle` given) and numbers the call
    (`id`); an entry reached from inside a call adds nothing. `settle`:
    the device of the verbosity-2 path, whose spans end in a synchronize
    where it is a CUDA device."""

    __slots__ = ("settle", "id", "t0")

    def __init__(self, settle: Optional[torch.device] = None):
        self.settle, self.id, self.t0 = settle, None, None

    def __enter__(self):
        global _depth, _on, _settle, _call_id
        _depth += 1
        if _depth == 1:
            _call_id += 1
            self.id = _call_id
            _stack.clear()
            _on = self.settle is not None or \
                torch.autograd._profiler_enabled()
            _settle = self.settle if self.settle is not None and \
                self.settle.type == "cuda" else None
            self.t0 = begin("call")
        return self

    def __exit__(self, *exc) -> bool:
        global _depth, _on, _settle
        _depth -= 1
        if self.t0 is None:
            return False
        try:
            if _on:
                del _stack[1:]   # spans an exception left open
            end("call", self.t0)
        finally:
            _on, _settle = False, None
        if not _first:
            _first.update((k, tuple(v)) for k, v in _acc.items())
        return False


def entry(fn):
    """`fn` run inside a `call` span: the decorator of the port's entry
    points."""
    @functools.wraps(fn)
    def entered(*args, **kwargs):
        with call():
            return fn(*args, **kwargs)
    return entered


def upload(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)` of host data `x`
    (a NumPy array, a number or a CPU tensor) in an `upload` span: the one
    place the program copies from host memory to the device. The copy is
    the plain one, from pageable memory."""
    t0 = begin("upload")
    out = torch.as_tensor(x, dtype=dtype, device=device)
    end("upload", t0)
    return out


def count_launch(library: str, symbol: str) -> None:
    """One launch of the C entry `symbol` of kernel library `library`."""
    key = (library, symbol)
    _launches[key] = _launches.get(key, 0) + 1


def launches(library: str, symbol: Optional[str] = None) -> int:
    """Launches so far of `library`'s C entry `symbol`, or of all its
    entries where `symbol` is None."""
    return sum(n for (lib, sym), n in _launches.items()
               if lib == library and symbol in (None, sym))


def counters(after_first: bool = False) -> dict:
    """A copy of the counters: {"call": entry calls, "spans": {key:
    (count, total ns)}, "launches": {(library, symbol): count}}. With
    `after_first` the calls and spans after the process's first call
    alone."""
    before = _first if after_first else {}
    spans = {}
    for k, (n, ns) in _acc.items():
        n0, ns0 = before.get(k, (0, 0))
        spans[k] = (n - n0, ns - ns0)
    return {"call": spans.get("call", (0, 0))[0], "spans": spans,
            "launches": dict(_launches)}


def spans(call_id: Optional[int] = None) -> List[Span]:
    """The recorded spans, in the order they opened; of call `call_id`
    alone where it is given. A span still open reads 0 for both times."""
    return [Span(r[0], r[1], r[2], r[3], i, r[4], r[5])
            for i, r in enumerate(_records)
            if call_id is None or r[5] == call_id]
