"""The port's spans and counters (`of_dis_tpu_torch.trace`), on the CPU at
the goldens' 192x160.

An op-2 call under torch.profiler records its span tree and marks it on
the profiler's clock without parenting any operator, so the benchmark's
profile readers (`dis_bench.trace`) read what they read without the
markers; with no profiler active nothing is recorded and the counters
still count. Every hand-kernel launch is counted in `build.launch`, every
copy from host memory to the device is an `upload`, and the benchmark's
four counter readers divide what they should."""

import ast
import importlib.util
import inspect
import os
import re
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dis_bench import trace as bench_trace
from of_dis_tpu_torch import trace
from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.kernels import upscale as upscale_kernel
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import densify, patch_solver, pyramid
from of_dis_tpu_torch.params import op_point_params
from of_dis_tpu_torch.parallel import mesh
from of_dis_tpu_torch.tools import profile_pipeline

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
PKG = os.path.join(ROOT, "of_dis_tpu_torch")
H, W = 160, 192
PARAMS = op_point_params(W, 2)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    a = torch.as_tensor((rng.random((1, 1, H, W)) * 255).astype(np.uint8))
    return a, torch.roll(a, (1, 2), (-2, -1))


def _call(pair):
    return dis.dis_flow_batched(*pair, PARAMS, W, H, device="cpu")


def _profiled(pair):
    """A profile of one op-2 call, the call's id and its recorded spans."""
    _call(pair)                       # the cached tables made beforehand
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(pair)
    last = trace.spans()[-1].call
    return prof, last, trace.spans(last)


def test_profiled_call_records_the_span_tree(pair):
    """(a) Every child inside its parent, one call id, three scales with
    the five stages each in order, uploads as leaves."""
    _, call_id, spans = _profiled(pair)
    by_id = {s.id: s for s in spans}
    root = spans[0]
    assert root.name == "call" and root.parent is None
    assert {s.call for s in spans} == {call_id}
    for s in spans[1:]:
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    levels = list(range(PARAMS.sc_f, PARAMS.sc_l - 1, -1))
    assert len(levels) == 3
    top = [s.name for s in spans if s.parent == root.id]
    assert top == ["pyramid", "grid"] + [f"L{sl}" for sl in levels] + \
        ["upscale"]
    for sl in levels:
        lv = next(s for s in spans if s.name == f"L{sl}")
        kids = [s for s in spans if s.parent == lv.id]
        assert [s.name for s in kids] == [f"L{sl}.{st}" for st in dis.STAGES]
        assert lv.level == sl and all(s.level == sl for s in kids)
    uploads = [s for s in spans if s.name == "upload"]
    assert uploads
    assert not any(by_id[s.parent].name == "upload"
                   for s in spans if s.parent is not None)
    # every span closed once in the counters too
    counted = trace.counters()["spans"]
    assert all(counted[s.name][0] >= 1 for s in spans)


def test_markers_leave_the_benchmark_readers_as_they_were(pair,
                                                          monkeypatch):
    """(b) The markers are user annotations that parent nothing: the
    profile's top-level host operators and its device activities are
    those of the same call profiled with the markers stubbed out."""
    prof, _, spans = _profiled(pair)
    marks = [e.name for e in prof.events()
             if e.name.startswith(trace.MARK)]
    assert len(marks) == 2 * len(spans)
    host = bench_trace.host_events(prof)
    dev = bench_trace.device_events(prof)
    monkeypatch.setattr(trace, "_mark", lambda label: None)
    bare, _, _ = _profiled(pair)
    assert not [e for e in bare.events() if e.name.startswith(trace.MARK)]
    assert [e.name for e in host] == \
        [e.name for e in bench_trace.host_events(bare)]
    assert [e.name for e in dev] == \
        [e.name for e in bench_trace.device_events(bare)]
    assert host and not any(e.name.startswith(trace.MARK) for e in host)


def test_no_profiler_no_records_and_the_counters_count(pair):
    """(c) Outside a profiler session nothing is recorded, the counters
    count the call, its spans and its uploads, and an entry reached from
    another entry is part of the outer call."""
    _call(pair)
    before, n_records = trace.counters(), len(trace.spans())
    _call(pair)
    dis.dis_flow_full(pair[0][0], pair[1][0], PARAMS, W, H, device="cpu")
    after = trace.counters()
    assert len(trace.spans()) == n_records
    assert after["call"] == before["call"] + 2
    for key in ("pyramid", "grid", "upscale", "L3.poptim", "upload"):
        n0, ns0 = before["spans"].get(key, (0, 0))
        n1, ns1 = after["spans"][key]
        assert n1 >= n0 + 2 and ns1 > ns0
    first = trace.counters(after_first=True)
    assert first["call"] == after["call"] - 1


def test_build_launch_is_where_a_launch_is_counted(monkeypatch):
    """(d) `build.launch` counts a launch under its library and C entry
    once the entry returned no error, and a failed launch not at all."""
    results = iter([0, 2])
    monkeypatch.setattr(build, "entry",
                        lambda name, symbol, argtypes:
                        lambda *args: next(results))
    monkeypatch.setattr(build, "stream_handle", lambda device: 0)

    class Here:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(torch.cuda, "device", lambda device: Here())
    before = trace.launches("warp", "of_warp")
    build.launch("cuda", "warp", "of_warp", ())
    assert trace.launches("warp", "of_warp") == before + 1
    assert trace.launches("warp") >= before + 1
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        build.launch("cuda", "warp", "of_warp", ())
    assert trace.launches("warp", "of_warp") == before + 1


def test_smoke_and_bench_read_each_c_entry_apart():
    """`chip_smoke.py` and `tools/bench.py` read the launch counter per
    kernel since their last reset: the single-pair TV entry counts under
    its own name in the smoke and not at all in the bench's batched
    kernels."""
    import chip_smoke
    from of_dis_tpu_torch.tools import bench

    chip_smoke.reset_launches()
    bench.reset_launches()
    trace.count_launch("tv_of_inner", "of_tv_of_inner_single")
    trace.count_launch("warp", "of_warp")
    trace.count_launch("warp", "of_warp")
    assert chip_smoke.read_launches() == {"tv_of_inner_single": 1,
                                          "warp": 2}
    assert bench.read_launches() == {"warp": 2}
    chip_smoke.reset_launches()
    assert chip_smoke.read_launches() == {}
    assert set(k["library"] for k in chip_smoke.KERNELS.values()) == \
        set(build.KERNELS)


def _host_copies(path):
    """(line, call) of every torch.as_tensor / torch.tensor call with a
    device= keyword in one source file."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in ("as_tensor", "tensor") \
                and any(k.arg == "device" for k in node.keywords):
            out.append((node.lineno, ast.unparse(node)[:60]))
    return out


def test_every_upload_goes_through_the_helper():
    """(e) No torch.as_tensor(..., device=) / torch.tensor(..., device=)
    of host data is left in models/, ops/ or kernels/, and each site that
    copies host tables to the device calls `trace.upload`."""
    found = []
    for sub in ("models", "ops", "kernels"):
        for name in sorted(os.listdir(os.path.join(PKG, sub))):
            if name.endswith(".py"):
                path = os.path.join(PKG, sub, name)
                found += [(f"{sub}/{name}", *c) for c in _host_copies(path)]
    assert found == []
    sites = (pyramid._resize_mm, patch_solver._template_indices,
             patch_solver._grid_tables.__wrapped__, patch_solver._gn_plain,
             densify._cover_pair.__wrapped__,
             upscale_kernel._device_tables.__wrapped__, dis._as_batch)
    for fn in sites:
        assert "trace.upload(" in inspect.getsource(fn), fn.__name__
    assert "_as_batch(" in inspect.getsource(mesh._chunks)


def test_upload_copies_as_before_and_counts():
    n0 = trace.counters()["spans"].get("upload", (0, 0))[0]
    x = np.arange(6, dtype=np.int64).reshape(2, 3)
    got = trace.upload(x, "cpu", torch.float64)
    assert got.dtype == torch.float64 and got.tolist() == x.tolist()
    assert trace.upload(7, torch.device("cpu"), torch.int32).dtype == \
        torch.int32
    assert trace.counters()["spans"]["upload"][0] == n0 + 2


def _reader(name):
    path = os.path.join(ROOT, "dis_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# 11 calls, the first (1 upload, 2 s) left out: 10 calls of 30 uploads
# (36.9 ms of them) and 25.2 ms each
STATE = {"call": [11, 2_000_000_000 + 10 * 25_200_000],
         "upload": [301, 1_000_000 + 369_000_000]}
FIRST = {"call": (1, 2_000_000_000), "upload": (1, 1_000_000)}


@pytest.mark.parametrize("name,kind,want", [
    ("uploads_per_call.batch", "batch", 30.0),
    ("upload_ms_per_call.batch", "batch", 36.9),
    ("host_ms_per_call.batch", "batch", 25.2),
    ("upload_ms_per_step.stream", "stream", 36.9)])
def test_counter_readers_on_a_hand_set_state(monkeypatch, name, kind, want):
    """(f) Each reader divides the counts after the first call by the
    calls after it; another loop kind, or no call after the first, reads
    None."""
    read = _reader(name).read
    monkeypatch.setattr(trace, "_acc", {k: list(v) for k, v in
                                        STATE.items()})
    monkeypatch.setattr(trace, "_first", dict(FIRST))
    assert read(types.SimpleNamespace(kind=kind)) == pytest.approx(want)
    other = "stream" if kind == "batch" else "batch"
    assert read(types.SimpleNamespace(kind=other)) is None
    monkeypatch.setattr(trace, "_acc", {k: list(v) for k, v in
                                        FIRST.items()})
    assert read(types.SimpleNamespace(kind=kind)) is None


def test_profile_pipeline_names_the_span_over_each_gap(capsys):
    """The profiling tool pairs the markers into spans and names the
    innermost one open over each gap between kernels."""
    def ev(name, start, dur, dtype):
        return types.SimpleNamespace(
            name=name, device_type=dtype, device_resource_id=7, thread=1,
            cpu_parent=None, is_user_annotation=name.startswith("of_dis"),
            time_range=types.SimpleNamespace(
                start=start, elapsed_us=lambda d=dur: d))

    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    evs = [ev("of_dis:call:b", 0.0, 0.0, cpu), ev("of_dis:L3:b", 1.0, 0, cpu),
           ev("of_dis:upload:b", 12.0, 0, cpu),
           ev("of_dis:upload:e", 19.0, 0, cpu), ev("of_dis:L3:e", 40, 0, cpu),
           ev("of_dis:call:e", 50.0, 0, cpu),
           ev("k1", 2.0, 8.0, gpu), ev("k2", 20.0, 5.0, gpu),
           ev("k3", 45.0, 1.0, gpu)]
    prof = types.SimpleNamespace(events=lambda: evs)
    spans = profile_pipeline.program_spans(prof)
    assert [(s.key, s.depth) for s in spans] == [
        ("upload", 2), ("L3", 1), ("call", 0)]
    profile_pipeline.report(profile_pipeline.events(prof, "cuda"), 1,
                            "device", spans=spans)
    out = capsys.readouterr().out
    gaps = [ln for ln in out.splitlines() if re.match(r" +\d+\.\d+ ms  in ",
                                                        ln)]
    assert [ln.split()[3] for ln in gaps] == ["L3", "upload"]
