"""Guards on the port's boundaries: it never loads JAX or the JAX package,
never runs on the CPU in place of CUDA, and every kernel has its source,
its C entry and a launch counter."""

import importlib
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import of_dis_tpu_torch
from of_dis_tpu_torch import cli
from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.params import op_point_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "of_dis_tpu_torch")
WRAPPERS = {"gn_fused": "gn_fused", "gn_tiled": "gn_tiled",
            "bilerp_extract": "bilerp_extract",
            "tv_of_inner": "of_inner",
            "tv_de_inner": "de_inner", "warp": "warp_image_batched",
            "upscale": "upscale_batched", "i8_dot": "dot_sum",
            "gn_stages": "gn_stages"}


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        of_dis_tpu_torch.__path__, "of_dis_tpu_torch."))


def test_import_loads_neither_jax_nor_reference_package():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'of_dis_tpu' or "
            "m.startswith('of_dis_tpu.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_sources_never_import_reference_or_jax():
    pat = re.compile(r"^\s*(from|import)\s+(of_dis_tpu|jax)(\.|\s|$)",
                     re.MULTILINE)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            src = fh.read()
        assert not pat.search(src), f


def test_cuda_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = op_point_params(64, 2)
    x = np.zeros((1, 1, 32, 64), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dis.dis_flow_batched(x, x, p, 64, 32)            # default: cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dis.dis_flow_full(x[0], x[0], p, 64, 32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run_OF_INT", os.path.join(ROOT, "tests/goldens/a.png"),
                  os.path.join(ROOT, "tests/goldens/b.png"),
                  str(tmp_path / "o.flo"), "2"])


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_each_kernel_has_source_entry_and_counter(name):
    mod = importlib.import_module(f"of_dis_tpu_torch.kernels.{name}")
    assert isinstance(mod.launches, int)
    assert callable(getattr(mod, WRAPPERS[name]))
    src = build.source(name)
    assert src.is_file()
    text = src.read_text()
    assert f'extern "C" int of_{name}(' in text
    # the JAX package's kernel, or the kernel of one of its tools
    assert re.search(r"Replaces: (of_dis_tpu|tools)/\S+\.py::", text)
    assert name in build.KERNELS


@pytest.mark.parametrize("name,entry", [("tv_of_inner", "of_inner_single"),
                                        ("tv_de_inner", "de_inner_single")])
def test_single_pair_entries_have_their_own_counter(name, entry):
    """The single-pair TV entries count apart from the batched ones, and a
    CPU tensor moves neither count."""
    mod = importlib.import_module(f"of_dis_tpu_torch.kernels.{name}")
    assert isinstance(mod.launches_single, int)
    before = (mod.launches, mod.launches_single)
    f = torch.zeros((4, 5))
    args = (f, f, f) if name == "tv_of_inner" else (f, f)
    kw = dict(quarter_alpha=2.5, hd3=0.8, hg3=1.6, n_inner=1, n_solver=1,
              omega=1.6)
    if name == "tv_de_inner":
        kw["camlr"] = 0
    out = getattr(mod, entry)(*args, torch.zeros((8, 1, 4, 5)), **kw)
    out = out if torch.is_tensor(out) else out[0]
    assert out.shape == (4, 5)
    assert (mod.launches, mod.launches_single) == before


@pytest.mark.parametrize("mode,channels,suffix", [
    ("run_OF_INT", 1, ".flo"), ("run_OF_RGB", 3, ".flo"),
    ("run_OF_GRD", 1, ".flo"), ("run_DE_INT", 1, ".pfm"),
    ("run_DE_RGB", 3, ".pfm"), ("run_DE_GRD", 1, ".pfm")])
def test_cli_mode_table(mode, channels, suffix):
    """Every mode of the reference parses to its parameter and channel
    counts; flow writes .flo (2 parameters), depth .pfm (1)."""
    _, nop, noc, *_ = cli.parse_args([mode, "a", "b", "o" + suffix])
    assert noc == channels
    assert nop == (2 if suffix == ".flo" else 1)


def test_kernel_wrappers_reject_cpu_kernel_launch_paths():
    """A CPU tensor takes the plain twin and leaves the count alone; the
    wrapper never tries to build or launch there."""
    from of_dis_tpu_torch.kernels import warp
    before = warp.launches
    src = torch.zeros((1, 1, 4, 5))
    f = torch.zeros((1, 4, 5))
    out, mask = warp.warp_image_batched(src, f, f)
    assert warp.launches == before and out.shape == src.shape
    assert not build._libs


def test_gn_tiled_cpu_tensors_take_the_twin_and_count_nothing():
    from of_dis_tpu_torch.kernels import gn_tiled
    from of_dis_tpu_torch.ops import patch_solver
    from of_dis_tpu_torch.params import make_level_spec
    p = op_point_params(64, 3)
    spec = make_level_spec(0, 64, 32, p)
    rng = np.random.default_rng(0)
    planes = [torch.as_tensor(rng.random((1, 1, 32 + 24, 64 + 24)) * 255,
                              dtype=torch.float32) for _ in range(4)]
    pt_ref = patch_solver.grid_ref_points(spec).T[None].contiguous()
    before = gn_tiled.launches
    out = gn_tiled.gn_tiled(spec, p, planes[0], planes[1:],
                            torch.zeros((1, 2, spec.nopatches)), pt_ref)
    assert gn_tiled.launches == before and not build._libs
    assert out[0].shape == (1, 2, spec.nopatches)
    assert out[1].shape == (1, 144, spec.nopatches)
    assert 0 < int(out[2]) <= p.max_iter


def test_shared_header_is_part_of_each_library_hash(tmp_path, monkeypatch):
    """An edit to a shared header under csrc/ rebuilds the kernels."""
    before = build.library_path("gn_tiled")
    src = tmp_path / "csrc"
    src.mkdir()
    for f in build.SRC_DIR.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "SRC_DIR", src)
    assert build.library_path("gn_tiled") == before
    with open(src / "gn_common.cuh", "a") as fh:
        fh.write("// edited\n")
    assert build.library_path("gn_tiled") != before
    assert '#include "gn_common.cuh"' in build.source("gn_fused").read_text()


def test_build_command_targets_sm90a():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR.parts[-2:] == ("build", "of_dis_tpu_torch")
    assert str(build.library_path("warp")).endswith(".so")


def test_unported_cli_modes_raise(tmp_path):
    for argv in (["run_DE_RGB", "a", "b", "o", "--init-flow", "x"],
                 ["run_OF_INT", "a", "b", "o", "--init-flow", "x"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(argv)
    with pytest.raises(ValueError, match="unknown mode"):
        cli.main(["run_OF_XYZ", "a", "b", "o"])
