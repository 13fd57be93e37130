"""Batch frame decoder of the serving pipeline (the counterpart of the JAX
package's native `decode_batch`).

A PNG frame is read, its chunks parsed and its image data inflated in
Python (`utils.io.png_chunks`, `zlib.decompress`); the row filters are
undone and the pixels converted to (C, H, W) uint8 by the C entries of
`csrc/io_native.cpp`. A JPEG frame is decoded whole by `csrc/jpeg.cpp`,
pixel for pixel as cv::imread decodes it (gray is the image's Y plane,
colour BGR, the EXIF orientation applied). Both libraries are built with
the host compiler at first use (`kernels.build.load_host`). zlib and
ctypes release the interpreter lock, so a thread pool over the frames of
a batch decodes them side by side. Binary PGM / PPM frames skip the
unfilter. The plain twin is `utils.io.load_image`, which gives the same
pixels (through the same JPEG decoder); there is no fallback to it, nor to
cv2 or PIL: if a library cannot be built or loaded, `decode_batch`
raises.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import Executor
from typing import Optional, Sequence

import numpy as np

from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.utils import io as uio

_ARGS = {
    "of_png_unfilter": ((ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                         ctypes.c_int, ctypes.c_void_p), ctypes.c_int64),
    "of_to_chw": ((ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p), ctypes.c_int),
}


def _bind(lib_name: str, args: dict):
    """The C entries `args` names of host library `lib_name`, in order,
    their argtypes and restypes set."""
    lib = build.load_host(lib_name)
    fns = []
    for name, (argtypes, restype) in args.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), restype
        fns.append(fn)
    return fns


def _entries():
    """The PNG library's two C entries."""
    return _bind("io_native", _ARGS)


_JPEG_ARGS = {
    "of_jpeg_info": ((ctypes.c_void_p, ctypes.c_int64,
                      ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int)), ctypes.c_int),
    "of_jpeg_decode": ((ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_void_p), ctypes.c_int),
    "of_jpeg_strerror": ((ctypes.c_int,), ctypes.c_char_p),
}


def _jpeg_entries():
    """The JPEG library's three C entries."""
    return _bind("jpeg", _JPEG_ARGS)


def _jpeg_error(code: int) -> ValueError:
    return ValueError(_jpeg_entries()[2](code).decode())


def jpeg_info(raw: bytes):
    """(width, height, components) of a JPEG, the size after its EXIF
    orientation. Raises ValueError on a file the decoder refuses in its
    header (arithmetic coding, 12-bit samples, lossless, CMYK, ...)."""
    info = _jpeg_entries()[0]
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    src = np.frombuffer(raw, np.uint8)
    err = info(src.ctypes.data, src.size, ctypes.byref(w), ctypes.byref(h),
               ctypes.byref(n))
    if err:
        raise _jpeg_error(err)
    return w.value, h.value, n.value


def decode_jpeg(raw: bytes, channels: int,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """A JPEG as cv::imread reads it, (channels, H, W) uint8: channels 1
    its Y plane (IMREAD_GRAYSCALE), 3 BGR (IMREAD_COLOR), the EXIF
    orientation applied. `out`, if given, is the C-contiguous array to
    fill. Raises ValueError naming the cause on a JPEG it cannot decode."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    w, h, _ = jpeg_info(raw)
    if out is None:
        out = np.empty((channels, h, w), np.uint8)
    elif (out.dtype != np.uint8 or not out.flags.c_contiguous
          or out.shape != (channels, h, w)):
        raise ValueError(f"out must be a C-contiguous uint8 array of shape "
                         f"{(channels, h, w)}, got {out.dtype} {out.shape}")
    src = np.frombuffer(raw, np.uint8)
    err = _jpeg_entries()[1](src.ctypes.data, src.size, channels,
                             out.ctypes.data)
    if err:
        raise _jpeg_error(err)
    return out


def _read(path: str):
    """(width, height, channels, data, kind) of one frame: "png" image data
    still filtered, "pnm" pixels, or the "jpeg" file's bytes."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] == b"\x89PNG\r\n\x1a\n":
        return (*uio.png_chunks(raw), "png")
    if raw[:1] == b"P" and raw[1:2] in (b"5", b"6"):
        pix = uio.decode_pnm(raw)
        return pix.shape[1], pix.shape[0], pix.shape[2], pix, "pnm"
    if raw[:3] == uio.JPEG_MAGIC:
        try:
            return (*jpeg_info(raw), raw, "jpeg")
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: unsupported image format (PNG, PGM, PPM and "
                     "JPEG supported)")


def _decode_into(fns, frame, channels: int, out: np.ndarray,
                 path: str) -> None:
    """Decode one frame into `out` (channels, H, W) uint8, C-contiguous:
    a JPEG whole, a PNG unfiltered and converted."""
    unfilter, to_chw = fns
    w, h, nch, data, kind = frame
    if kind == "jpeg":
        try:
            decode_jpeg(data, channels, out=out)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        return
    filtered = kind == "png"
    if not filtered:
        pix = np.ascontiguousarray(data)
    elif nch == 1 and channels == 1:
        pix = out                       # gray to gray: unfilter in place
    else:
        pix = np.empty((h, w * nch), np.uint8)
    if filtered:
        src = np.frombuffer(data, np.uint8)
        err = unfilter(src.ctypes.data, h, w * nch, nch, pix.ctypes.data)
        if err:
            raise ValueError(f"PNG row {err - 1}: unknown filter type"
                             if err > 0 else "PNG unfilter failed")
    if pix is not out and to_chw(pix.ctypes.data, h, w, nch, channels,
                                 out.ctypes.data):
        raise ValueError(f"cannot convert {nch} channels to {channels}")


def decode_batch(paths: Sequence[str], channels: int,
                 pool: Optional[Executor] = None,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode 8-bit PNG / PGM / PPM and JPEG frames of one size, mixed or
    not, to (B, C, H, W) uint8 as cv::imread gives them (equal to
    `utils.io.load_image`'s values): C = 1 gray (PNG / PNM through
    OpenCV's fixed-point BGR2GRAY, JPEG its decoded Y plane), C = 3 in BGR
    order. `pool`, if given, decodes the frames side by side; `out`, if
    given, is the C-contiguous (B, C, H, W) uint8 array to fill (a pinned
    host buffer, say). Raises ValueError on a frame it cannot decode or of
    another size, and RuntimeError if the decoder library cannot be
    built."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    paths = list(paths)
    if not paths:
        raise ValueError("decode_batch: no frames")
    fns = _entries()
    first = _read(paths[0])
    shape = (len(paths), channels, first[1], first[0])
    if out is None:
        out = np.empty(shape, np.uint8)
    elif (out.dtype != np.uint8 or not out.flags.c_contiguous
          or out.shape[:2] != shape[:2]):
        raise ValueError(f"out must be a C-contiguous uint8 array of shape "
                         f"{shape}, got {out.dtype} {out.shape}")

    def one(i: int) -> None:
        frame = first if i == 0 else _read(paths[i])
        if (frame[1], frame[0]) != out.shape[2:]:
            raise ValueError(f"{paths[i]}: {frame[0]}x{frame[1]} frame in a "
                             f"batch of {out.shape[3]}x{out.shape[2]}")
        _decode_into(fns, frame, channels, out[i], paths[i])

    if pool is None:
        for i in range(len(paths)):
            one(i)
    else:
        for fut in [pool.submit(one, i) for i in range(len(paths))]:
            fut.result()
    return out
