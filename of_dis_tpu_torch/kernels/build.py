"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions (no PyTorch headers, so a
build takes seconds) and compiles on first use into
`build/of_dis_tpu_torch/lib<name>-<hash>.so` at the repository root; the
hash covers the source, the shared headers (`csrc/*.cuh`) and the flags, so
an edited source rebuilds.
`build()` starts one nvcc per missing library, all at once, and waits for
all of them. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

KERNELS = ("gn_fused", "gn_tiled", "bilerp_extract", "tv_of_inner",
           "tv_de_inner", "warp", "upscale", "i8_dot", "gn_stages")
SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "of_dis_tpu_torch"
# --fmad=false: no fused multiply-add contraction, so each kernel rounds
# exactly as its plain PyTorch twin's separate multiplies and adds do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


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


def stream_handle(device) -> ctypes.c_void_p:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
