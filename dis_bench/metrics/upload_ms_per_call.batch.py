"""Host ms a batch call spends in its copies from host memory to the card
(each waits for the work queued before it): the program's `upload` spans'
total over its `call` spans.

The counts are the process's after its first call
(`of_dis_tpu_torch.trace.counters(after_first=True)`), which carries the
one-time costs (the kernels' build and load, CUDA's start-up, the uploads
of the tables the program keeps): the second warm-up call, the untraced
window and the traced stretch (8 calls of ~1,400 at b256, 4 of ~320 at
op-4, 8 steps of ~1,500 in the stream cell), so the profiler's slowdown
of the host (~1.5x) moves them by under 1%. A program without the trace
module, a loop of the other kind or no call after the first reads
None."""


def read(ctx):
    if ctx.kind != "batch":
        return None
    try:
        from of_dis_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters(after_first=True)
    if not c["call"]:
        return None
    return c["spans"].get("upload", (0, 0))[1] / 1e6 / c["call"]
