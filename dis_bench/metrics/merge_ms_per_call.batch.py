"""Host ms a batch call spends in the forward-backward merge's splats:
the program's `L<sl>.merge` spans' total over its `call` spans, after the
process's first call (`of_dis_tpu_torch.trace.counters(after_first=True)`,
as `upload_ms_per_call.batch` reads `upload`). A program without the
trace module or without the spans (none before K8 took the merge), a
loop of the other kind or no call after the first reads None."""


def read(ctx):
    if ctx.kind != "batch":
        return None
    try:
        from of_dis_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters(after_first=True)
    merge = [ns for key, (_, ns) in c["spans"].items()
             if key.startswith("L") and key.endswith(".merge")]
    if not c["call"] or not merge:
        return None
    return sum(merge) / 1e6 / c["call"]
