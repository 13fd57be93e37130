"""Guards on the port's boundaries: it never loads JAX, the JAX package or
the JAX system's bench and tools (`bench.py`, `tools/`), nor an image
library (cv2, PIL, imageio: each would hide the port's own decoders on a
machine that has it) nor a codec library (libwebp, libjpeg, libpng, ...),
never runs on the CPU in place of CUDA, and every kernel has its source,
its C entry and a launch counter."""

import ast
import importlib
import os
import pkgutil
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import of_dis_tpu_torch
from of_dis_tpu_torch import cli, trace
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


FORBIDDEN = ("jax", "of_dis_tpu", "bench", "tools", "cv2", "PIL",
             "imageio")
JPEG = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg", "variants",
                    "s420.jpg")


def test_import_loads_neither_jax_nor_reference_package():
    """Every module of the port and chip_smoke.py imported, and a JPEG and
    a PNG decoded through `load_image` and `decode_batch`: none of
    FORBIDDEN (nor a submodule) is loaded."""
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "from of_dis_tpu_torch.native import io as nio\n"
            "from of_dis_tpu_torch.utils import io as uio\n"
            f"for p in ({JPEG!r}, {os.path.join(ROOT, 'tests/goldens/a.png')!r}):\n"
            "    uio.load_image(p, 3); nio.decode_batch([p], 1)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_sources_never_import_reference_or_jax():
    pat = re.compile(r"^\s*(from|import)\s+(of_dis_tpu|jax|bench|tools|cv2|"
                     r"PIL|imageio)(\.|\s|$)", re.MULTILINE)
    dynamic = re.compile(r"(import_module|__import__)\(\s*[\"'](cv2|PIL|"
                         r"imageio)")
    for line in ("import cv2\n", "from PIL import Image\n",
                 "    import imageio.v3 as iio\n"):
        assert pat.search(line), line
    assert dynamic.search("importlib.import_module('cv2')")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            src = fh.read()
        assert not pat.search(src), f
        assert not dynamic.search(src), f


WEBP = os.path.join(ROOT, "tests", "torch_fixtures", "webp", "variants")
TIFF = os.path.join(ROOT, "tests", "torch_fixtures", "tiff", "variants")
GIF = os.path.join(ROOT, "tests", "torch_fixtures", "gif", "variants")
JP2 = os.path.join(ROOT, "tests", "torch_fixtures", "jp2", "variants")
PNG = os.path.join(ROOT, "tests", "goldens", "a.png")
# image codec libraries the host decoders must neither link nor load
CODEC_LIBS = ("libwebp", "libsharpyuv", "libjpeg", "libturbojpeg", "libpng",
              "libtiff", "libgif", "libopenjp2", "libavif")
# and zlib, which they must not link: Deflate data (PNG's, TIFF's) is
# inflated by Python's own zlib module, which loads it


def _needed(path):
    """The DT_NEEDED entries of an ELF64 little-endian shared library."""
    with open(path, "rb") as f:
        elf = f.read()
    assert elf[:6] == b"\x7fELF\x02\x01", path
    shoff, = struct.unpack_from("<Q", elf, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", elf, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", elf, shoff + k * shentsize)
                for k in range(shnum)]
    out = []
    for sh in sections:
        if sh[1] != 6:                                  # SHT_DYNAMIC
            continue
        strtab = sections[sh[6]]                        # sh_link: .dynstr
        for k in range(sh[5] // 16):
            tag, val = struct.unpack_from("<qQ", elf, sh[4] + 16 * k)
            if tag == 1:                                # DT_NEEDED
                at = strtab[4] + val
                out.append(elf[at:elf.index(b"\0", at)].decode())
    return out


def test_host_decoders_link_and_load_no_codec_library():
    """The JPEG 2000, TIFF, GIF, WebP, JPEG and PNG decoders are the
    port's own: the host libraries (jp2, tiff and gif among them) need no
    codec library nor zlib (their DT_NEEDED entries), their sources
    include none, and decoding every format in a fresh process maps no
    codec library but the port's own builds."""
    assert {"tiff", "gif", "jp2"} <= set(build.HOST_LIBS)
    for name in build.HOST_LIBS:
        src = (build.SRC_DIR / f"{name}.cpp").read_text()
        assert not re.search(r"#include\s*[<\"](webp|jpeglib|png|zlib|"
                             r"tiff|gif_lib|openjpeg|opj_)", src), name
        needed = _needed(build.load_host(name)._name)
        assert not [n for n in needed
                    if n.startswith(CODEC_LIBS + ("libz",))], needed
    files = [os.path.join(WEBP, f) for f in ("q50.webp", "alpha_lossy.webp",
                                             "anim_offset.webp",
                                             "gray_lossless.webp")]
    files += [os.path.join(TIFF, f) for f in ("cv2_jpeg_bgr.tif",
                                              "rgb8_lzw_pred.tif",
                                              "gray8_deflate_pred.tif",
                                              "rgb8_tiled_packbits.tif")]
    files += [os.path.join(GIF, f) for f in ("palette.gif",
                                             "interlaced.gif")]
    files += [os.path.join(JP2, f) for f in ("lossy_20.jp2", "rgb.j2k",
                                             "prog_rpcl.jp2")]
    code = ("import sys\n"
            "from of_dis_tpu_torch.kernels import build\n"
            "from of_dis_tpu_torch.native import io as nio\n"
            "from of_dis_tpu_torch.utils import io as uio\n"
            f"for p in {files + [JPEG, PNG]!r}:\n"
            "    uio.load_image(p, 3); nio.decode_batch([p], 1)\n"
            "own = str(build.BUILD_DIR)\n"
            "maps = {l.split()[-1] for l in open('/proc/self/maps')\n"
            "        if l.split()[-1].endswith('.so') or '.so.' in l}\n"
            f"bad = [m for m in maps if m.rsplit('/', 1)[-1].startswith("
            f"{CODEC_LIBS!r}) and not m.startswith(own)]\n"
            "mine = [m for m in maps if m.startswith(own)]\n"
            "assert len(mine) >= 5, mine\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


# the JAX system's measurement and operations tools that have a module in
# the port's tools/ (the rest are listed in ROADMAP.md)
TOOLS = ("synth", "bench", "bench_op", "bench_seq", "warmup",
         "profile_pipeline", "bench_stages", "bench_tv_parts", "eval_epe",
         "bench_gn_stages", "bench_i8_dot", "bench_pipeline")


def test_every_tool_module_is_walked_by_the_guards():
    """The import guards above walk every tools module."""
    mods = set(_modules())
    assert {f"of_dis_tpu_torch.tools.{t}" for t in TOOLS} <= mods


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
    # launches are counted per library and C entry in `trace` alone
    assert not hasattr(mod, "launches")
    assert isinstance(trace.launches(name, f"of_{name}"), int)
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
    assert f'extern "C" int of_{name}_single(' in \
        build.source(name).read_text()

    def counts():
        return (trace.launches(name, f"of_{name}"),
                trace.launches(name, f"of_{name}_single"))

    before = counts()
    f = torch.zeros((4, 5))
    args = (f, f, f) if name == "tv_of_inner" else (f, f)
    kw = dict(quarter_alpha=2.5, hd3=0.8, hg3=1.6, n_inner=1, n_solver=1,
              omega=1.6)
    if name == "tv_de_inner":
        kw["camlr"] = 0
    out = getattr(mod, entry)(*args, torch.zeros((8, 1, 4, 5)), **kw)
    out = out if torch.is_tensor(out) else out[0]
    assert out.shape == (4, 5)
    assert counts() == before


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
    before = trace.launches("warp")
    src = torch.zeros((1, 1, 4, 5))
    f = torch.zeros((1, 4, 5))
    out, mask = warp.warp_image_batched(src, f, f)
    assert trace.launches("warp") == before and out.shape == src.shape
    assert not build._libs


def _cpu_call(name):
    """One call of kernel `name`'s wrapper on small CPU tensors, and the
    output shape it must return."""
    from of_dis_tpu_torch.kernels import (bilerp_extract, gn_fused,
                                          gn_stages, gn_tiled, i8_dot,
                                          tv_de_inner, tv_of_inner, upscale,
                                          warp)
    from of_dis_tpu_torch.ops import patch_solver, pyramid
    from of_dis_tpu_torch.params import make_level_spec
    from of_dis_tpu_torch.tools import bench_gn_stages
    rng = np.random.default_rng(1)
    f = torch.as_tensor(rng.standard_normal((2, 6, 10)), dtype=torch.float32)
    tv_kw = dict(quarter_alpha=2.5, hd3=0.8, hg3=1.6, n_inner=1, n_solver=1,
                 omega=1.6)
    deriv = torch.as_tensor(rng.standard_normal((2, 8, 1, 6, 10)),
                            dtype=torch.float32)
    if name in ("gn_fused", "gn_tiled"):
        p = op_point_params(64, 2)
        spec = make_level_spec(0, 64, 32, p)
        im = torch.as_tensor(rng.random((1, 1, 32, 64)) * 255,
                             dtype=torch.float32)
        ims, dxs, dys = pyramid.build_pyramid(im, 0, p.p_samp_s)
        pt_ref = patch_solver.grid_ref_points(spec).T[None].contiguous()
        p0 = torch.zeros((1, 2, spec.nopatches))
        if name == "gn_fused":
            tpl = patch_solver.extract_templates(spec, p, ims[0], dxs[0],
                                                 dys[0])
            out = gn_fused.gn_fused(spec, p, ims[0], tpl, p0, pt_ref)
        else:
            out = gn_tiled.gn_tiled(spec, p, ims[0], (ims[0], dxs[0], dys[0]),
                                    p0, pt_ref)
        return out[0], (1, 2, spec.nopatches)
    if name == "bilerp_extract":
        im = torch.as_tensor(rng.random((2, 1, 20, 24)), dtype=torch.float32)
        pts = torch.as_tensor(rng.random((2, 5, 2)) * 8 + 4,
                              dtype=torch.float32)
        return bilerp_extract.bilerp_extract(im, pts, 4, 4), (2, 16, 5)
    if name == "tv_of_inner":
        return tv_of_inner.of_inner(f, f, f, deriv, **tv_kw)[0], (2, 6, 10)
    if name == "tv_de_inner":
        return (tv_de_inner.de_inner(f, f, deriv, camlr=0, **tv_kw),
                (2, 6, 10))
    if name == "warp":
        return warp.warp_image_batched(f[:, None], f, f)[0], (2, 1, 6, 10)
    if name == "upscale":
        return (upscale.upscale_batched(f[..., None], 1, 12, 20),
                (2, 12, 20, 1))
    if name == "i8_dot":
        a = torch.ones((16, 32), dtype=torch.int8)
        bt = torch.ones((24, 32), dtype=torch.int8)
        return i8_dot.dot_sum(a, bt, 8, 2), (2, 16, 8)
    geom = bench_gn_stages.Geometry(5, 20, 30, 7, 2, 1, 2, 20 - 5 - 3)
    x = bench_gn_stages.make_inputs(geom, 2, "cpu")
    args = bench_gn_stages.call_args(x, geom, "A4")
    return gn_stages.gn_stages(*args), (2, 7)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_wrapper_takes_the_twin_on_cpu_and_binds_nothing(name):
    """A CPU tensor runs the plain twin: the launch count stays, no library
    is loaded and no C entry is bound."""
    before = trace.launches(name)
    out, shape = _cpu_call(name)
    assert tuple(out.shape) == shape and out.device.type == "cpu"
    assert trace.launches(name) == before
    assert not build._libs and not build._entries


def test_entry_binds_a_symbol_once(monkeypatch):
    """build.entry loads the library and sets argtypes and restype at the
    first call only, then hands back the same function object."""
    import ctypes

    class Lib:
        def __init__(self):
            self.of_k = lambda *args: 0

    loads = []

    def load(name):
        loads.append(name)
        return Lib()

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "_entries", {})
    argtypes = (ctypes.c_void_p, ctypes.c_int)
    fn = build.entry("k", "of_k", argtypes)
    assert build.entry("k", "of_k", argtypes) is fn
    assert loads == ["k"]
    assert fn.argtypes == list(argtypes) and fn.restype is ctypes.c_int
    assert build._entries == {("k", "of_k"): fn}


# what a wrapper module may not touch: the C entries are reached through
# build.launch / build.query only, which make the tensor's device current
_UNGUARDED = {"entry", "load", "stream_handle", "_entries", "_libs"}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_c_entry_is_called_through_the_device_helper(name):
    """Walk kernels/<name>.py with ast: no C entry is bound, loaded or
    called other than through `build.launch` (kernels) and `build.query`
    (numbers read from the device), and the wrapper launches through
    `build.launch`."""
    path = os.path.join(PKG, "kernels", f"{name}.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    launches = 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                           ast.Name):
            where = f"{name}.py:{node.lineno}"
            if node.value.id == "build":
                assert node.attr not in _UNGUARDED, \
                    f"{where}: build.{node.attr} outside the helper"
                launches += node.attr == "launch"
            if node.value.id == "ctypes":
                assert node.attr.startswith("c_"), \
                    f"{where}: ctypes.{node.attr}"
        if isinstance(node, ast.Call):
            # calling what a call returned, e.g. a bound entry
            assert not isinstance(node.func, ast.Call), \
                f"{name}.py:{node.lineno}: a call of a call's result"
        if isinstance(node, ast.Name):
            assert node.id not in ("CDLL", "getattr"), \
                f"{name}.py:{node.lineno}: {node.id}"
    assert launches >= 1


def test_build_binds_entries_only_inside_the_helpers():
    """In build.py itself, `entry` is called only by `launch` and
    `query`."""
    path = os.path.join(PKG, "kernels", "build.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    callers = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "entry"):
                    callers.add(fn.name)
    assert callers == {"launch", "query"}


def test_launch_makes_the_tensor_device_current(monkeypatch):
    """`build.launch` enters the tensor's device around the C call, passes
    that device's current stream after the arguments, leaves the caller's
    device current after, and raises on a CUDA error; `build.query` calls
    with the device current too."""
    current = ["cuda:0"]
    entered = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)
            self.prev, current[0] = current[0], str(self.device)

        def __exit__(self, *exc):
            current[0] = self.prev

    calls = []

    def fake(*args):
        calls.append((current[0], args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(build, "entry", lambda name, symbol, argtypes: fake)
    dev = torch.device("cuda", 1)
    build.launch(dev, "k", "of_k", [], 7, 8)
    assert entered == [dev]
    assert calls == [("cuda:1", (7, 8, 1001))]
    assert current == ["cuda:0"]
    monkeypatch.setattr(build, "entry", lambda *a: (lambda *args: 9))
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        build.launch(dev, "k", "of_k", [], 7)
    assert current == ["cuda:0"]
    monkeypatch.setattr(build, "entry",
                        lambda *a: (lambda: 10 * int(current[0][-1])))
    assert build.query(torch.device("cuda", 2), "k", "of_q") == 20
    assert entered[-1] == torch.device("cuda", 2)


def test_upscale_tile_window_spans_every_tile():
    """The window the wrapper hands the K4 kernel is the widest span of
    input columns any tile of output columns reads, for the path's x8 and
    x2 and for ragged widths."""
    from of_dis_tpu_torch.kernels import upscale
    for out_w, w in ((1024, 128), (1024, 512), (2398, 300), (26, 13),
                     (1047, 131), (16, 8)):
        i0, i1, _, _ = upscale.tap_tables(out_w, w)
        for tile in (512, 1024):
            spans = [int(i1[s:s + tile].max() - i0[s:s + tile].min()) + 1
                     for s in range(0, out_w, tile)]
            assert upscale.tile_window(i0, i1, tile) == max(spans)
    # the x8 path's staged rows: a 512-pixel tile (nop 2) reads 64 input
    # columns and the next one's first
    assert upscale._window(1024, 128, 512) == 65


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
    before = trace.launches("gn_tiled")
    out = gn_tiled.gn_tiled(spec, p, planes[0], planes[1:],
                            torch.zeros((1, 2, spec.nopatches)), pt_ref)
    assert trace.launches("gn_tiled") == before and not build._libs
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
    with pytest.raises(ValueError, match="unknown mode"):
        cli.main(["run_OF_XYZ", "a", "b", "o"])
