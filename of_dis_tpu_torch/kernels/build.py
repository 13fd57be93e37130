"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions (no PyTorch headers, so a
build takes seconds) and compiles on first use into
`build/of_dis_tpu_torch/lib<name>-<hash>.so` at the repository root; the
hash covers the source, the shared headers (`csrc/*.cuh`, `csrc/*.h` for
the host libraries) and the flags, so an edited source rebuilds.
`build()` starts one nvcc per missing library, all at once, and waits for
all of them. `entry()` binds a kernel's C entry once, at its first launch,
so that a launch costs one ctypes call. `load_host()` builds and loads
the host C++ libraries of `csrc/` (`HOST_LIBS`: plain C entries, no CUDA)
with the host compiler in the same way. The wrappers call an entry only
through `launch()` (a kernel, on the current stream of the tensor's device,
the error checked) or `query()` (a number the library reads from the
device): both make the tensor's device the current one around the call,
so a kernel and any per-device query in C run on that device whichever
device the calling thread had current. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

from of_dis_tpu_torch import trace

KERNELS = ("gn_fused", "gn_tiled", "bilerp_extract", "tv_of_inner",
           "tv_de_inner", "warp", "upscale", "i8_dot", "gn_stages")
SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "of_dis_tpu_torch"
# --fmad=false: no fused multiply-add contraction, so each kernel rounds
# exactly as its plain PyTorch twin's separate multiplies and adds do (the
# GN solve's explicit fmaf calls excepted: the twin computes those as one
# rounding too, `patch_solver._fms`).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# host libraries: `csrc/<name>.cpp`, compiled with the host C++ compiler
HOST_LIBS = ("io_native", "jpeg", "webp", "raster", "tiff", "gif", "jp2")
# -ffp-contract=off: no fused multiply-add, so the decoders' float
# arithmetic rounds as OpenCV's and libpng's separate operations do
HOST_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()
# (kernel, symbol) -> the bound C entry, argtypes and restype set
_entries: Dict[Tuple[str, str], Callable[..., int]] = {}


def nvcc() -> str:
    """The nvcc of $CUDA_HOME, else the one on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def source(name: str) -> Path:
    return SRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source(name).read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc
    process each, all started together. Returns each kernel's ptxas report
    (registers, spills) from this build, or "" where the library existed.
    Raises RuntimeError with the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def host_compiler() -> str:
    """The host C++ compiler: c++, else g++, from PATH."""
    cc = shutil.which("c++") or shutil.which("g++")
    if cc is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")
    return cc


def host_library_path(name: str) -> Path:
    """The built library of host source `name`; its hash covers the source,
    the host headers (`csrc/*.h`) and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.h")))
    source_bytes = (SRC_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(source_bytes + headers
                            + " ".join(HOST_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library `name` (one of `HOST_LIBS`), compiled at
    its first use in this checkout. The build writes a name of its own
    (process and thread) and renames it into place, so processes that
    build at once each load a whole library. Raises RuntimeError with the
    compiler's output if the build fails."""
    lib = _host_libs.get(name)      # loaded: no lock on a decoder's path
    if lib is not None:
        return lib
    with _host_lock:
        lib = _host_libs.get(name)
        if lib is not None:
            return lib
        out = host_library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp),
                   str(SRC_DIR / f"{name}.cpp")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {name} failed: {' '.join(cmd)}"
                                   f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _host_libs[name] = lib
        return lib


def bind(name: str, path) -> None:
    """Load the library at `path` in place of kernel `name`'s built one,
    its entries bound anew at their next call: for timing versions of a
    kernel's source against each other (`kernel_variants.py`)."""
    _libs[name] = ctypes.CDLL(str(path))
    for key in [k for k in _entries if k[0] == name]:
        del _entries[key]


def entry(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry `symbol` of kernel `name`, bound once: the library built
    and loaded and the entry's argtypes and restype (int: a launch's
    cudaError_t) set at the first call, the same function object returned
    after. Called on the card only, never for CPU tensors."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError_t "
                           f"{err}")


def check_tensor(kernel: str, what: str, t: torch.Tensor, shape,
                 dtype=torch.float32) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be a contiguous CUDA "
                         f"{dtype} tensor, got {t.device} {t.dtype}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`, as
    the integer a `c_void_p` argument takes."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def launch(device, name: str, symbol: str, argtypes: Sequence, *args
           ) -> None:
    """Launch kernel `name` through its C entry `symbol` on `device`:
    `device` made current around the call, that device's current stream
    passed after `args`, the returned cudaError_t checked, and the launch
    counted (`trace.count_launch`): every hand kernel launches here."""
    fn = entry(name, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, stream_handle(device))
    check(err, name)
    trace.count_launch(name, symbol)


def query(device, name: str, symbol: str, argtypes: Sequence = (),
          *args) -> int:
    """The int that the C entry `symbol(*args)` of kernel `name` returns
    with `device` current (a property the library reads from the device,
    or a constant of the kernel)."""
    fn = entry(name, symbol, argtypes)
    with torch.cuda.device(device):
        return fn(*args)


def ptr(t) -> int:
    """A tensor's device address, as the integer a `c_void_p` argument
    takes."""
    return t.data_ptr()
