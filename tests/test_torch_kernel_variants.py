"""The kernel-version timing script (`kernel_variants.py`) on the CPU: its
kernels are kernels of the build with a wrapper each, its paths are
`chip_smoke.py`'s paths that launch the kernel, it refuses what it cannot
time — no kernel or version named, a kernel it does not know, no CUDA
device — and `build.bind` puts a library in place of a kernel's. It
measures only on the card."""

import ctypes.util

import pytest
import torch

import chip_smoke
import kernel_variants
from of_dis_tpu_torch.kernels import build


@pytest.mark.parametrize("name", sorted(kernel_variants.KERNELS))
def test_kernels_are_the_builds_with_paths_of_the_smoke(name):
    assert name in build.KERNELS and callable(kernel_variants.KERNELS[name])
    assert build.source(name).exists()
    launching = {cfg["name"] for cfg in chip_smoke.PATHS
                 if name in cfg["launches"] or name in cfg.get("at_least", {})}
    assert set(kernel_variants.PATHS[name]) == launching


@pytest.mark.parametrize("argv", [[], ["gn_fused"], ["upscale", "u.cu"]])
def test_refuses_without_a_kernel_it_times_and_a_version(argv):
    with pytest.raises(SystemExit):
        kernel_variants.main(argv)


def test_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_variants.main(["bilerp_extract", str(tmp_path / "a.cu")])


def test_bind_replaces_the_library_and_drops_its_entries(monkeypatch):
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_entries", {("warp", "of_warp"): abs,
                                            ("upscale", "of_upscale"): abs})
    build.bind("warp", libc)
    assert build.load("warp")._name == libc
    assert build.entry("warp", "getpid", []) is build.load("warp").getpid
    assert set(build._entries) == {("warp", "getpid"),
                                   ("upscale", "of_upscale")}


def test_every_kernel_has_its_twin():
    assert set(kernel_variants.TWINS) == set(kernel_variants.KERNELS)
    assert kernel_variants.TWINS["tv_de_inner"] is \
        chip_smoke.PLAIN["tv_de_inner"]
    assert kernel_variants.TWINS["i8_dot"] is chip_smoke.PLAIN["i8_dot"]


def test_the_dot_tools_calls_are_recorded_at_its_defaults():
    """T1 runs on no path: its calls are the dot tool's, both types, and
    each agrees with its twin (on the CPU the wrapper is the twin)."""
    calls = kernel_variants.record("i8_dot", torch.device("cpu"))
    assert [label for label, _, _ in calls] == ["int8", "bf16"]
    for label, (a, bt, n, grid), kw in calls:
        assert (tuple(a.shape), tuple(bt.shape), n, grid, kw) == (
            (832, 256), (64 * 256, 256), 256, 64, {})
        assert a.dtype == (torch.int8 if label == "int8" else torch.bfloat16)
    a, bt, n, grid = calls[0][1]
    a, bt = a[:64], bt[:3 * n]
    assert kernel_variants.agrees("i8_dot", kernel_variants.KERNELS[
        "i8_dot"](a, bt, n, 2), kernel_variants.TWINS["i8_dot"](a, bt, n, 2))


def test_route_timing_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_variants.main(["tv_de_inner", "--routes"])


def test_the_stage_tools_calls_are_recorded_on_both_layouts(monkeypatch):
    """T2 runs on no path: its calls are the stage tool's, every stage and
    variant at both geometries, each on its geometry's layout, and each
    agrees with its twin (on the CPU the wrapper is the twin)."""
    from of_dis_tpu_torch.kernels import gn_stages
    from of_dis_tpu_torch.tools import bench_gn_stages as bgs
    small = {"op2-l3": bgs.Geometry(8, 30, 60, 5, 3, 3, 2, 10),
             "op4-l0": bgs.Geometry(12, 40, 80, 7, 2, 0, 1, 25,
                                    gn_stages.COLUMNS)}
    monkeypatch.setattr(bgs, "GEOMETRIES", small)
    calls = kernel_variants.record("gn_stages", torch.device("cpu"))
    assert [label for label, _, _ in calls] == [
        f"{g} {label}" for g in small for label, _, _ in bgs.RUNS]
    for label, args, kw in calls:
        geom = small[label.split()[0]]
        assert (args[6], args[-1], kw) == (geom.psz, geom.layout, {})
        out = kernel_variants.KERNELS["gn_stages"](*args)
        assert kernel_variants.agrees("gn_stages", out,
                                      kernel_variants.TWINS["gn_stages"](
                                          *args))
