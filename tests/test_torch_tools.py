"""The port's measurement and operations tools (`of_dis_tpu_torch/tools/`)
on the CPU at tiny sizes: `eval_epe` against the JAX package's
`tools/eval_epe.py` on the same files (identical stdout and statistics,
invalid and NaN pixels included); `warmup`'s lines; `bench_op` and
`bench_seq`'s lines; `bench_stages`' stages chained equal to
`dis_flow_batched` and `bench_tv_parts`' parts chained equal to
`_tv_refine`, bit for bit; `profile_pipeline`'s sections, its category
sums equal to its total, and its card-side reader on stand-in events."""

import contextlib
import dataclasses
import importlib.util
import io as io_mod
import json
import os
import re
import types

import numpy as np
import pytest
import torch

from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import patch_solver
from of_dis_tpu_torch.tools import (bench_op, bench_seq, bench_stages,
                                    bench_tv_parts, eval_epe,
                                    profile_pipeline, warmup)
from of_dis_tpu_torch.utils import io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes run one torch thread (see test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- eval_epe

def _jax_eval_epe():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_epe", os.path.join(ROOT, "tools", "eval_epe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def epe_files(tmp_path_factory):
    """out/ and gt/ directories of .flo and .pfm files: noise around the
    truth, gt > 1e9 and NaN pixels, NaN in an output, a file without a
    valid pixel, a file only one side has, a file of another suffix."""
    root = tmp_path_factory.mktemp("epe")
    out, gt = root / "out", root / "gt"
    out.mkdir()
    gt.mkdir()
    rng = np.random.default_rng(7)

    def flo(h, w, c=2, scale=2.0):
        return (rng.standard_normal((h, w, c)) * scale).astype(np.float32)

    g = flo(12, 20)
    io.write_flo(str(gt / "a.flo"), g)
    io.write_flo(str(out / "a.flo"), g + flo(12, 20, scale=1.5))
    g = flo(10, 16)
    g[2, 3, 0] = 2e9
    g[4, :, 1] = np.nan
    g[5, 5, 0] = np.inf
    f = g + flo(10, 16, scale=3.0)
    f[1, 1, 0] = np.nan
    io.write_flo(str(gt / "b.flo"), g)
    io.write_flo(str(out / "b.flo"), f)
    d = flo(9, 14, 1)[..., 0]
    io.write_pfm(str(gt / "c.pfm"), d)
    io.write_pfm(str(out / "c.pfm"), d + flo(9, 14, 1)[..., 0])
    io.write_flo(str(gt / "d.flo"), np.full((6, 8, 2), 5e9, np.float32))
    io.write_flo(str(out / "d.flo"), flo(6, 8))
    io.write_flo(str(out / "only_out.flo"), flo(6, 8))
    (out / "note.txt").write_text("x")
    (gt / "note.txt").write_text("x")
    return out, gt


def _run(main, argv):
    buf = io_mod.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("which", [
    ("a.flo",), ("b.flo",), ("c.pfm",), ("d.flo",), ("dirs",),
    ("dirs_valid",), ("no_common",)])
def test_eval_epe_prints_what_the_jax_tool_prints(which, epe_files,
                                                  tmp_path):
    out, gt = epe_files
    if which[0] == "dirs":
        argv = [str(out), str(gt)]
    elif which[0] == "dirs_valid":
        # without d.flo (no valid pixel) and b.flo (an output NaN at a
        # valid pixel): a finite mean
        sub_o, sub_g = tmp_path / "o", tmp_path / "g"
        sub_o.mkdir()
        sub_g.mkdir()
        for n in ("a.flo", "c.pfm"):
            (sub_o / n).write_bytes((out / n).read_bytes())
            (sub_g / n).write_bytes((gt / n).read_bytes())
        argv = [str(sub_o), str(sub_g)]
    elif which[0] == "no_common":
        empty = tmp_path / "empty"
        empty.mkdir()
        argv = [str(out), str(empty)]
    else:
        argv = [str(out / which[0]), str(gt / which[0])]
    jax_tool = _jax_eval_epe()
    rc, text = _run(eval_epe.main, argv)
    jrc, jtext = _run(jax_tool.main, argv)
    assert (rc, text) == (jrc, jtext)
    assert text.strip()
    if which[0] == "dirs":
        # the JAX tool's quirk: a file without a valid pixel makes the
        # mean NaN
        assert text.strip().splitlines()[-1] == "mean over 4 files: EPE nan"
    if which[0] == "dirs_valid":
        assert re.fullmatch(r"mean over 2 files: EPE \d+\.\d{4}",
                            text.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["a.flo", "b.flo", "c.pfm", "d.flo"])
def test_eval_epe_stats_equal_the_jax_tools(name, epe_files):
    out, gt = epe_files
    jax_tool = _jax_eval_epe()
    ours = eval_epe.epe_stats(eval_epe._load(str(out / name)),
                              eval_epe._load(str(gt / name)))
    theirs = jax_tool.epe_stats(jax_tool._load(str(out / name)),
                                jax_tool._load(str(gt / name)))
    np.testing.assert_array_equal(np.array(ours), np.array(theirs))
    np.testing.assert_array_equal(eval_epe._load(str(gt / name)),
                                  jax_tool._load(str(gt / name)))


def test_eval_epe_directory_mean_weights_by_all_pixels(tmp_path):
    """The JAX tool's weighting, kept: each file's mean over its valid
    pixels counts with all its pixels."""
    out, gt = tmp_path / "o", tmp_path / "g"
    out.mkdir()
    gt.mkdir()
    g1 = np.zeros((2, 2, 2), np.float32)
    g1[0, :, 0] = 2e9                      # 2 of 4 pixels valid
    io.write_flo(str(gt / "x.flo"), g1)
    io.write_flo(str(out / "x.flo"), np.ones((2, 2, 2), np.float32) * [3, 4])
    io.write_flo(str(gt / "y.flo"), np.zeros((1, 4, 2), np.float32))
    io.write_flo(str(out / "y.flo"), np.ones((1, 4, 2), np.float32) * [0, 1])
    rc, text = _run(eval_epe.main, [str(out), str(gt)])
    # x: EPE 5 over its 2 valid pixels, weighted by 4; y: 1, by 4
    assert rc == 0 and text.splitlines()[-1] == "mean over 2 files: EPE 3.0000"


def test_eval_epe_usage_returns_2(capsys):
    assert eval_epe.main(["one"]) == 2
    assert "Usage" in capsys.readouterr().out


# ------------------------------------------------- warmup, bench_op, seq

def test_warmup_prints_a_line_per_call(capsys):
    warmup.main(["--w", str(W), "--h", str(H), "--batch", "1,2", "--ops",
                 "1,2", "--modes", "of_int,de_int", "--seq", "--device",
                 "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("build: ")
    warm = [re.sub(r": [\d.]+s$", "", ln) for ln in lines[1:]]
    want = []
    for mode in ("of_int", "de_int"):
        for op in (1, 2):
            for b in (1, 2):
                want.append(f"warm {mode} op={op} batch={b} {W}x{H}")
                if mode == "of_int":
                    want.append(f"warm {mode} op={op} batch={b} seq")
    assert warm == want
    assert all(re.search(r": \d+\.\ds$", ln) for ln in lines[1:])


def test_warmup_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        warmup.main(["--modes", "of_xyz", "--device", "cpu"])


@pytest.mark.parametrize("argv", [["2", "2", "1"], ["3", "1", "1", "3", "1"],
                                  ["2", "1", "2", "1", "1"]])
def test_bench_op_prints_its_line(argv, capsys):
    rate = bench_op.main(argv + ["--device", "cpu"], h=H, w=W)
    out = capsys.readouterr().out.strip()
    op, b, it = argv[0], argv[1], argv[2]
    noc = argv[3] if len(argv) > 3 else "1"
    nop = argv[4] if len(argv) > 4 else "2"
    assert re.fullmatch(
        rf"op{op} noc={noc} nop={nop} b={b} iters={it}: [\d.]+ pairs/s "
        r"\([\d.]+ ms/batch, compile\+warm [\d.]+s\)", out), out
    assert rate > 0


def test_bench_seq_prints_both_modes(capsys):
    res = bench_seq.main(["2", "2", "3", "--device", "cpu"], h=H, w=W)
    lines = capsys.readouterr().out.splitlines()
    assert [re.sub(r"[\d.]+", "#", ln) for ln in lines] == [
        "compile+warm #s", "seq op# S=# T=#: # pairs/s (# ms/pair)",
        "  compile+warm batched-b# #s",
        "cold-batch b=# x#: # pairs/s (# ms/pair)"]
    assert res["seq"].shape == (2, 2, H, W, 2)
    assert len(res["cold"]) == 2 and res["cold"][0].shape == (2, H, W, 2)


# -------------------------------------------------- stages and TV parts

@pytest.mark.parametrize("op,nop,tiled", [(2, 2, False), (2, 1, False),
                                          (3, 2, True), (1, 2, False)])
def test_stages_chained_equal_the_full_call(op, nop, tiled, monkeypatch):
    """The stages, chained, are `dis_flow_batched` bit for bit; with the
    large-level route forced (`TILED_MIN_PATCHES = 0`) the GN stage
    builds its templates and no extraction stage runs."""
    if tiled:
        monkeypatch.setattr(patch_solver, "TILED_MIN_PATCHES", 0)
    a, b, params = bench_stages.flow_pairs(2, op, "cpu", H, W, nop)
    fh, fw = a.shape[-2], a.shape[-1]
    out, stages = bench_stages.run_stages(a, b, params, fw, fh)
    assert torch.equal(out, dis.dis_flow_batched(a, b, params, fw, fh,
                                                 device="cpu"))
    names = [s.name for s in stages]
    levels = range(params.sc_f, params.sc_l - 1, -1)
    assert names[0].startswith("pyramids")
    assert sum("extract_templates" in n for n in names) == (
        0 if tiled else len(levels))
    assert sum(" GN " in n for n in names) == len(levels)
    assert sum("tv_refine" in n for n in names) == (
        len(levels) if params.usetvref else 0)
    assert names[-1].startswith("upscale") == bool(params.sc_l)
    # each stage again on its recorded inputs gives what it gave the chain
    last = stages[-1]
    assert torch.equal(last.fn(*last.args), out)


def test_stages_refuse_the_merge():
    a, b, params = bench_stages.flow_pairs(1, 2, "cpu", H, W)
    with pytest.raises(ValueError, match="merge"):
        bench_stages.run_stages(a, b, dataclasses.replace(
            params, usefbcon=True), a.shape[-1], a.shape[-2])


def test_bench_stages_prints_a_line_per_stage(capsys):
    res = bench_stages.main(["1", "--reps", "1", "--device", "cpu"], h=H,
                            w=W)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 + len(res["stages_ms"]) + 2
    assert lines[-2].startswith("sum of the stages")
    assert lines[-1].startswith("dis_flow_batched")
    assert all(re.search(r"ms/step \( *[\d.]+ us/pair\)$", ln)
               for ln in lines[1:])


@pytest.mark.parametrize("op,level,nop", [(2, 1, 2), (2, 0, 2), (4, 0, 1),
                                          (3, 1, 1)])
def test_tv_parts_chained_equal_tv_refine(op, level, nop):
    args = bench_tv_parts.level_inputs(2, level, op, nop, "cpu", H, W)
    flow, im_a, im_b, spec, params = args
    assert spec.level == level and params.nop == nop
    p = bench_tv_parts.parts(*args)
    want = dis._tv_refine(*args)
    assert torch.equal(p.compose(), want)
    fn, fargs = p.full
    assert torch.equal(fn(*fargs), want)
    w_im2, mask = p.warp[0](*p.warp[1])
    assert p.derivs[0](*p.derivs[1]).shape == (2, 8, 1) + w_im2.shape[-2:]


def test_tv_parts_refuse_a_level_without_tv():
    with pytest.raises(ValueError, match="refines no level"):
        bench_tv_parts.level_inputs(1, 0, 1, 2, "cpu", H, W)


def test_bench_tv_parts_prints_the_parts_and_the_share(capsys):
    res = bench_tv_parts.main(["1", "0", "--op", "4", "--depth", "--reps",
                               "1", "--device", "cpu"], h=H, w=W)
    ms = res["ms"]
    assert res["device_ms"] == {}
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("op4 depth L0 48x96 B=1")
    assert [ln.split("  ")[0].strip() for ln in lines[1:5]] == [
        "warp (K3)", "derivative stack (plain torch)", "inner loop (K5)",
        "full _tv_refine"]
    assert lines[5] == (f"derivative stack: {ms['derivs'] / ms['full']:.3f}"
                        " of the level's full _tv_refine")


# ------------------------------------------------------ profile_pipeline

@pytest.mark.parametrize("variant", ["", "seq", "fb", "rgb"])
def test_profile_pipeline_prints_its_sections(variant, capsys):
    argv = ["2", "2"] + ([variant] if variant else []) + ["--device", "cpu"]
    res = profile_pipeline.main(argv, h=32, w=64)
    out = capsys.readouterr().out
    for head in ("host total:", "host ms by category:",
                 "host ms by kernel, grouped by category:",
                 "biggest single activities:", "per thread busy / span:",
                 "operator time over the wall of the unprofiled call",
                 "gaps on ", "unprofiled call after the profile"):
        assert head in out, head
    assert res["total_ms"] > 0
    assert sum(res["by_category_ms"].values()) == pytest.approx(
        res["total_ms"], rel=1e-12)
    assert sum(s["busy_ms"] for s in res["streams"].values()) == \
        pytest.approx(res["total_ms"], rel=1e-12)
    pairs = 2 * (profile_pipeline.SEQ_FRAMES - 1) if variant == "seq" else 2
    assert f"at {pairs} pairs" in out


@pytest.mark.parametrize("name,cat", [
    ("void gn_fused_kernel<1, 2>(float const*, int)", "hand: gn_fused"),
    ("void tv_de_cluster<3>(float const*)", "hand: tv_de_inner"),
    ("warp_kernel", "hand: warp"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>", "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::direct_copy_kernel_cuda>", "copy"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("sm90_xmma_gemm_f32f32_tf32f32", "gemm"),
    ("void at::native::indexSelectLargeIndex<float>", "gather/index"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("aten::mm", "gemm"), ("aten::cat", "copy"), ("aten::mul", "elementwise"),
    ("aten::index_select", "gather/index"), ("aten::sum", "reduction"),
    ("something else", "other")])
def test_categories(name, cat):
    assert profile_pipeline.category(
        name, profile_pipeline.hand_kernels()) == cat


def test_every_library_has_its_kernels_named():
    libs = set(profile_pipeline.hand_kernels().values())
    assert libs == set(build.KERNELS)


def _fake_profile(kernels):
    """A stand-in for a finished torch.profiler profile on the card:
    (name, start us, duration us, stream) device events and a CPU op."""
    from torch.autograd import DeviceType

    def ev(name, start, dur, dtype, stream=7, parent=None):
        return types.SimpleNamespace(
            name=name, device_type=dtype, device_resource_id=stream,
            thread=1, cpu_parent=parent,
            time_range=types.SimpleNamespace(
                start=start, elapsed_us=lambda d=dur: d))

    evs = [ev(n, s, d, DeviceType.CUDA, st) for n, s, d, st in kernels]
    evs.append(ev("aten::add", 0.0, 99.0, DeviceType.CPU))
    return types.SimpleNamespace(events=lambda: evs)


def test_card_reader_on_stand_in_events(monkeypatch, capsys):
    prof = _fake_profile([("warp_kernel", 10.0, 5.0, 7),
                          ("gn_fused_kernel", 0.0, 8.0, 7),
                          ("warp_kernel", 20.0, 5.0, 7),
                          ("Memcpy HtoD", 1.0, 2.0, 9)])
    evs = profile_pipeline.events(prof, "cuda")
    assert [e.name for e in evs] == ["gn_fused_kernel", "Memcpy HtoD",
                                     "warp_kernel", "warp_kernel"]
    assert [e.track for e in evs] == [7, 9, 7, 7]
    res = profile_pipeline.report(evs, 4, "device", wall_s=40e-6)
    out = capsys.readouterr().out
    assert res["total_ms"] == pytest.approx(0.020)
    assert res["by_category_ms"] == pytest.approx(
        {"hand: warp": 0.010, "hand: gn_fused": 0.008, "copy": 0.002})
    assert res["streams"][7] == pytest.approx(dict(busy_ms=0.018,
                                                   span_ms=0.025))
    # gaps on stream 7: 8 -> 10 and 15 -> 20
    assert res["gaps_ms"] == pytest.approx(0.007)
    assert "busy share of the unprofiled call (0.040 ms): 0.500" in out

    monkeypatch.setattr(profile_pipeline, "profile", lambda fn, dev: prof)
    profile_pipeline.profile_call("stand-in", None, 40e-6, top=2)
    lines = capsys.readouterr().out.splitlines()
    head = json.loads(lines[0])
    assert head == {"profile": "stand-in", "device_busy_ms": 0.02,
                    "wall_ms": 0.04, "busy_share": pytest.approx(0.5),
                    "kernels": 3, "launches": 4}
    assert len(lines) == 3 and "warp_kernel" in lines[1]
    assert profile_pipeline.busy_ms(None, "cuda") == pytest.approx(0.020)


def test_busy_ms_raises_when_no_profile_sees_the_device(monkeypatch):
    monkeypatch.setattr(profile_pipeline, "profile",
                        lambda fn, dev: _fake_profile([]))
    with pytest.raises(RuntimeError, match="no device activity"):
        profile_pipeline.busy_ms(None, "cuda")
