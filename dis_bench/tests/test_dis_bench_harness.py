"""The harness on the CPU: every cell of BENCHMARK.json resolves by name
to its files, the file keeps to the benchmark's contract, each metric
reader reads the expected value off a recorded event list, and a run
with no card exits non-zero and prints no result."""

import json
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

from dis_bench import run, trace
from dis_bench.trace import Event

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def one_line(text):
    return 1 <= len(text) <= 200 and "\t" not in text and "\n" not in text


def test_the_file_has_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dis_bench"]
    assert BENCH["command"] == ["python3", "-m", "dis_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert CELLS == ["dis_op2_gray.sintel_b256", "dis_op4_gray.sintel_b16",
                     "dis_op2_gray.sintel_stream256"]
    assert all(one_line(w) for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"])
    for c in BENCH["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["traffic"]) and one_line(c["why"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=CELLS)
def test_every_cell_resolves_by_name(cell):
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json")
                        .read_text())
    assert cfg["name"] == cell["config"]
    assert traffic["name"] == cell["traffic"]
    assert traffic["kind"] in ("batch", "stream")
    assert (HERE / "reference" / f"{cfg['reference']}.py").exists()
    assert limits and all(v >= 0 for v in limits.values())
    entry = [c for c in BENCH["configs"] if c["name"] == cell["config"]][0]
    assert entry["file"] == f"dis_bench/configs/{cell['config']}.json"
    assert entry["reduced"] == cfg["reduced"] == []
    e2e = {m["name"] for m in run.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_every_metric_keeps_to_the_contract(metric):
    assert NAME.match(metric["name"])
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert one_line(metric["layer"])
        assert (HERE / "metrics" / f"{metric['name']}.py").exists()
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for cell in metric["workloads"]:
            assert metric["moves"] in {m["name"] for m in run.metrics_of(
                BENCH, {"name": cell}, "end_to_end")}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def context(kind, events, spans=(), steps=(), calls=2, pairs=4):
    """A reader's context on a recorded event list: device events on one
    stream, host events, one call of a 1024x448 op-2 batch per call."""
    hand = {"of_gn_fused_kernel": "gn_fused", "of_gn_tiled_kernel": "gn_tiled"}
    dev = [e for e in events if e.track == 7]
    host = [e for e in events if e.track != 7]
    ctx = types.SimpleNamespace(
        kind=kind, events=dev, host=host, calls=calls, pairs_per_call=pairs,
        categories=[trace.category(e.name, hand) for e in dev],
        spans=list(spans), steps=list(steps), window_us=1000.0,
        busy_us=trace.union_us(dev))
    ctx.roofline = lambda name: {"k1": 12.5, "k6": 20.0}[name] if any(
        c == f"hand: {'gn_fused' if name == 'k1' else 'gn_tiled'}"
        for c in ctx.categories) else None
    return ctx


EVENTS = [Event("void of_gn_fused_kernel<8>(float*)", 0.0, 100.0, 7),
          Event("ampere_sgemm_128x64_nn", 150.0, 50.0, 7),
          Event("Memcpy HtoD (Pageable -> Device)", 180.0, 40.0, 7),
          Event("void at::native::vectorized_elementwise_kernel", 400.0,
                200.0, 7),
          Event("aten::to", 200.0, 150.0, 1)]


def read(name, ctx):
    return run.load_file(HERE / "metrics" / f"{name}.py").read(ctx)


def test_readers_on_a_recorded_event_list():
    b = context("batch", EVENTS)
    s = context("stream", EVENTS, spans=[(0.0, 0.010), (1.0, 1.030),
                                         (2.0, 2.020)],
                steps=[0.001 * (k + 1) for k in range(100)])
    assert read("launches_per_call.batch", b) == 2.0
    assert read("launches_per_call.batch", s) is None
    # 50 + 40 + 200 us of plain work over 2 calls of 4 pairs
    assert read("torch_ops_ms_per_pair.batch", b) == pytest.approx(
        0.29 / 8)
    # busy: 0-100, 150-220, 400-600 -> 370 of 1000 us
    assert read("idle_share.batch", b) == pytest.approx(0.63)
    assert read("idle_share.stream", s) == pytest.approx(0.63)
    assert read("idle_share.stream", b) is None
    assert read("host_ms_per_step.stream", s) == pytest.approx(20.0)
    assert read("host_ms_per_step.stream", b) is None
    # the 95th percentile of 1..100 ms, numpy's linear interpolation
    assert read("step_ms_p95.stream", s) == pytest.approx(95.05)
    assert read("step_ms_p95.stream", b) is None
    assert read("k1_roofline", b) == 12.5
    assert read("k6_roofline", b) is None


def test_trace_arithmetic():
    evs = [Event("a", 0, 10, 7), Event("b", 5, 10, 8), Event("c", 30, 5, 7)]
    assert trace.union_us(evs) == 20
    assert trace.gaps(evs, 0, 40) == [(15, 30), (35, 40)]
    host = [Event("aten::to", 14, 10, 1), Event("aten::add", 26, 1, 1)]
    assert trace.host_during(host, 15, 30) == "aten::to"
    hand = trace.hand_kernels(ROOT / "of_dis_tpu_torch" / "csrc")
    assert set(hand.values()) >= {"gn_fused", "gn_tiled", "warp",
                                  "tv_of_inner", "upscale"}
    assert trace.category("Memcpy HtoD (Pageable -> Device)", hand) == "copy"


def test_roofline_from_the_work_count():
    """The context's roofline: least time of the work over the kernel's
    device time a call."""
    from dis_bench import geometry, peaks
    from dis_bench.work import k1

    cfg = json.loads((HERE / "configs" / "dis_op2_gray.json").read_text())
    params = geometry.params_for(cfg, 1024)
    loop = types.SimpleNamespace(full_w=1024, full_h=448, params=params,
                                 spans=[], pairs_per_call=lambda: 256)
    ctx = run.TraceContext.__new__(run.TraceContext)
    ctx.loop, ctx.calls, ctx.pairs_per_call = loop, 2, 256
    ctx.events = [Event("of_gn_fused_kernel", 0, 500.0, 7)] * 2
    ctx.categories = ["hand: gn_fused"] * 2
    least = peaks.least_s(*k1.work(256, 1024, 448, params))
    assert ctx.roofline("k1") == pytest.approx(100 * least / 500e-6)
    assert ctx.roofline("k6") is None


def test_run_exits_non_zero_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "dis_bench.run", "--workload", CELLS[0],
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_exits_non_zero_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and dis_bench/."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "dis_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "dis_bench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
