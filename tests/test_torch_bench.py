"""The port's throughput bench (`of_dis_tpu_torch.tools.bench`) and its
synthetic workload (`tools/synth.py`) on the CPU, against the JAX
package's `bench.py`: the same motion field, the same rows (read from
`bench.py`'s source) but the TPU-only `op3_nocache`, one JSON line in its
form, a timed row's output equal to `dis_flow_batched` on its inputs.
The bench runs once for the module, every row, at 48x96, batch 2, one
iteration (secondary rows at their own counts)."""

import contextlib
import importlib
import importlib.util
import io as io_mod
import json
import os
import re

import numpy as np
import pytest
import torch

from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.params import make_level_spec, op_point_params
from of_dis_tpu_torch.tools import bench, synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes run one torch thread (see test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench():
    """The JAX package's bench.py as a module (it imports numpy only at
    the top; JAX inside main)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_secondary_names():
    with open(os.path.join(ROOT, "bench.py")) as fh:
        return re.findall(r'_secondary\(\s*"(\w+)"', fh.read())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One run of the bench on the CPU: its stdout and its result."""
    env = {"BENCH_BATCH": "2", "BENCH_ITERS": "1", "BENCH_SECONDARY": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = io_mod.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = bench.main(["--device", "cpu"], h=H, w=W, hd=(H, W))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out.getvalue(), res


@pytest.mark.parametrize("h,w", [(64, 128), (436, 1024)])
def test_flow_field_is_bench_py_field(h, w):
    u, v = synth.flow_field(h, w, "cpu")
    ju, jv = _jax_bench()._flow_field(h, w)
    assert u.shape == v.shape == (h, w)
    np.testing.assert_allclose(u.numpy(), ju, atol=1e-5, rtol=0)
    np.testing.assert_allclose(v.numpy(), jv, atol=1e-5, rtol=0)


@pytest.mark.parametrize("channels,field", [
    (1, synth.flow_field), (3, synth.flow_field),
    (1, synth.disparity_field)])
def test_first_pairs_of_a_draw_are_the_smaller_draw(channels, field):
    big = synth.make_pairs(5, 24, 40, 0, "cpu", channels=channels,
                           field=field)
    small = synth.make_pairs(2, 24, 40, 0, "cpu", channels=channels,
                             field=field)
    assert big[0].dtype == torch.uint8 and big[0].shape == (5, channels, 24,
                                                            40)
    for x, y in zip(big[:2], small[:2]):
        assert torch.equal(x[:2], y)
    assert not torch.equal(big[0][0], big[1][0])


def test_sequence_streams_are_the_pairs_first_frames():
    """Frame 0 of stream s is the first frame of pair s; with scale 1 frame
    1 is that pair's second frame (the same warp)."""
    seq, u, v = synth.make_sequence(3, 4, 24, 40, 0, "cpu")
    a, b, pu, pv = synth.make_pairs(3, 24, 40, 0, "cpu")
    assert seq.shape == (4, 3, 1, 24, 40)
    assert torch.equal(seq[0], a) and torch.equal(seq[1], b)
    assert torch.equal(u, pu) and torch.equal(v, pv)
    slow, _, _ = synth.make_sequence(3, 4, 24, 40, 0, "cpu", scale=0.7)
    assert torch.equal(slow[0], seq[0]) and not torch.equal(slow[1], seq[1])


def test_line_is_one_json_object_in_bench_py_form(run):
    out, res = run
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "sintel_1024x436_op2_pairs_per_sec"
    assert line["unit"] == "frame-pairs/s"
    assert line["vs_baseline"] is None
    assert line["value"] > 0 and line["device"] == "cpu"
    assert line["card"] is None
    assert all(isinstance(v, float) and v > 0
               for v in line["secondary"].values())
    rows = [line["metric"]] + list(line["secondary"])
    assert list(line["busy_share"]) == rows
    # no device on the CPU: no busy share, and the wrappers launch nothing
    assert all(v is None for v in line["busy_share"].values())
    assert all(v == {} for v in line["launches"].values())
    assert {k: v for k, v in res.items() if k != "rows"} == line


def test_secondary_rows_are_bench_py_rows_but_the_cache_row(run):
    names = _jax_secondary_names()
    assert "op3_nocache_pairs_per_sec" in names and len(names) == 13
    want = [n for n in names if n != "op3_nocache_pairs_per_sec"]
    assert [r.name for r in bench.SECONDARY] == want
    assert list(json.loads(run[0])["secondary"]) == want


def test_rows_keep_bench_py_batch_caps_and_iterations():
    """min(batch, cap) and the timed iterations of bench.py's rows."""
    want = {"op1": (384, 6), "op3": (8, 4), "op4": (4, 2),
            "rgb_op3": (8, 3), "rgb_op2": (96, 4), "de_op2": (256, 4),
            "de_op3": (8, 4), "de_rgb_op2": (96, 4), "fbcon_op2": (64, 4),
            "op2_1080p": (32, 3)}
    got = {r.name[:-len("_pairs_per_sec")]: (r.cap, r.iters)
           for r in bench.SECONDARY if r.kind == "pairs"}
    assert got == want
    with open(os.path.join(ROOT, "bench.py")) as fh:
        src = fh.read()
    for cap, _ in want.values():
        assert f"min(batch, {cap})" in src
    seq = {r.kind: r for r in bench.SECONDARY if r.kind != "pairs"}
    assert (seq["seq"].streams, seq["seq"].frames, seq["seq"].iters) == (
        4, 9, 2)
    assert (seq["serving"].op, seq["serving"].streams,
            seq["serving"].frames) == (3, 4, 33)


def test_timed_row_equals_dis_flow_batched(run):
    """The primary row's last timed call (one iteration: (a, b)) is
    `dis_flow_batched` on the row's inputs, bit for bit."""
    r = run[1]["rows"][bench.PRIMARY]
    a, b = r["inputs"]
    assert a.shape[0] == 2 and a.dtype == torch.uint8
    want = dis.dis_flow_batched(a, b, r["params"], a.shape[-1], a.shape[-2],
                                device="cpu")
    assert torch.equal(r["out"], want)


def test_alternating_calls_end_on_the_swapped_pair():
    p = op_point_params(W, 1)
    a, b, _, _ = synth.make_pairs(2, H, W, 0, "cpu")
    a = a[..., :32, :]
    b = b[..., :32, :]
    _, _, out = bench.time_calls(p, a, b, 2, W, 32, "cpu", alternate=True)
    assert torch.equal(out, dis.dis_flow_batched(b, a, p, W, 32,
                                                 device="cpu"))


@pytest.mark.parametrize("op,nop,want", [
    (1, 2, {"gn_fused", "upscale"}),
    (2, 2, {"gn_fused", "tv_of_inner", "warp", "upscale"}),
    (2, 1, {"gn_fused", "tv_de_inner", "warp", "upscale"}),
    (3, 2, {"gn_fused", "gn_tiled", "tv_of_inner", "warp", "upscale"}),
    (4, 2, {"gn_fused", "gn_tiled", "tv_of_inner", "warp"}),
    (4, 1, {"gn_fused", "gn_tiled", "tv_de_inner", "warp"}),
])
def test_expected_kernels_at_sintel_size(op, nop, want):
    """Which kernels a row must launch at 1024x448 (chip_smoke.py's
    paths A, B, E, F, I and op-1 without TV)."""
    p = op_point_params(1024, op, nop=nop)
    assert bench.expected_kernels(p, 1024, 448) == want


def test_expected_kernels_of_the_unfused_route():
    import dataclasses
    p = dataclasses.replace(op_point_params(1024, 3), p_samp_s=16)
    spec = make_level_spec(p.sc_l, 1024, 448, p)
    assert spec.nopatches > 512
    assert bench.expected_kernels(p, 1024, 448) == {
        "bilerp_extract", "tv_of_inner", "warp", "upscale"}


def test_a_kernel_launched_no_time_fails_its_row():
    with pytest.raises(RuntimeError, match=r"\['warp'\] launched no time"):
        bench.check_launches("op2", {"gn_fused": 3, "tv_of_inner": 3,
                                     "upscale": 1},
                             {"gn_fused", "tv_of_inner", "warp", "upscale"})
    bench.check_launches("op2", {"gn_fused": 3, "tv_of_inner": 3,
                                 "warp": 3, "upscale": 1},
                         {"gn_fused", "tv_of_inner", "warp", "upscale"})


def test_a_row_that_raises_ends_the_bench(monkeypatch, capsys):
    """No error string in the line: the exception leaves the bench, and
    nothing is printed."""
    def broken(*args, **kw):
        raise ValueError("row broke")

    monkeypatch.setattr(bench, "seq_row", broken)
    monkeypatch.setenv("BENCH_BATCH", "1")
    monkeypatch.setenv("BENCH_ITERS", "1")
    with pytest.raises(ValueError, match="row broke"):
        bench.main(["--device", "cpu"], rows=["seq_op3_pairs_per_sec"],
                   h=32, w=64)
    assert capsys.readouterr().out == ""


def test_launch_counters_read_and_reset(monkeypatch):
    for name, mod in bench.KERNELS.items():
        monkeypatch.setattr(mod, "launches", 0)
    bench.KERNELS["warp"].launches = 3
    assert bench.read_launches() == {"warp": 3}
    bench.reset_launches()
    assert bench.read_launches() == {}


@pytest.mark.parametrize("tool", ["bench", "bench_op", "bench_seq", "warmup",
                                  "profile_pipeline", "bench_stages",
                                  "bench_tv_parts"])
def test_each_tool_runs_on_cuda_by_default_and_raises_without_it(
        tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"of_dis_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
