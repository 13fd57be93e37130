"""Batch frame decoder of the serving pipeline (the counterpart of the JAX
package's native `decode_batch` and of its cv2.imread fallback), and the
decoder under `utils.io.load_image`.

Every frame gets the pixels cv::imread gives it (gray IMREAD_GRAYSCALE,
colour IMREAD_COLOR in BGR order), with no OpenCV or PIL:
  - PNG, every variant cv::imread reads (gray, RGB, palette, gray+alpha,
    RGBA; 1, 2, 4, 8 and 16 bits; Adam7): chunks parsed and the image data
    inflated in Python (`utils.io.png_chunks`, `zlib.decompress`), then
    unfiltered, unpacked, de-interlaced and converted by
    `csrc/io_native.cpp`. Gray of a colour PNG is libpng's rgb_to_gray,
    the rule OpenCV asks libpng for (0.299 / 0.587 in 1/32768ths,
    truncated, or through the file's gamma when it has an sRGB or a
    significant gAMA chunk), not OpenCV's BGR2GRAY; 16-bit samples keep
    their high byte; alpha and tRNS are dropped.
  - PNM P1-P6 (`utils.io.pnm_header`, pixels by `csrc/io_native.cpp`):
    bitmaps, ASCII and binary, maxval 1-65535 as OpenCV's PxM reader
    takes them; gray of colour by OpenCV's BGR2GRAY.
  - BMP (`utils.io.bmp_header`, pixels by `csrc/io_native.cpp`): 1, 4 and
    8-bit palettes with RLE4 / RLE8, 16-bit 5-5-5 and 5-6-5, 24 and 32-bit,
    bottom-up or top-down; gray by OpenCV's BGR2GRAY.
  - JPEG, decoded whole by `csrc/jpeg.cpp`: Huffman or arithmetic
    coding, sequential, progressive or lossless (predictors 1-7, point
    transform, precision 2-8, samples unscaled as libjpeg returns them);
    gray is a YCbCr image's Y plane, colour BGR; a CMYK or YCCK image goes
    through OpenCV's CMYK to BGR and to gray rules; the EXIF orientation
    applied. What libjpeg decodes with a warning (a file cut short, bytes
    before a marker, bad codes, wrong restart markers, unfinished
    progressive scans) reads as cv::imread reads the file. What cv::imread
    fails on (12-bit, hierarchical, lossless arithmetic, 2 components, a
    lossless frame read in a colour space libjpeg would have to convert)
    is refused with "cv::imread fails on it too".
  - WebP (`utils.io.webp_chunks`, the bitstream by `csrc/webp.cpp`): lossy
    VP8 and lossless VP8L, simple and extended (VP8X) files, alpha dropped
    (a lossy image's ALPH chunk decoded only to fail where libwebp fails),
    an animation's frame 0 on a canvas of zeros, the EXIF orientation of
    an extended file applied; colour as libwebp's WebPDecodeBGRInto gives
    it, gray OpenCV 5's cvtColor BGR2GRAY of that colour (1/32768ths).
  - Sun raster (`utils.io.ras_header`, pixels by `csrc/raster.cpp`, as
    for PAM, HDR and PFM):
    depths 1, 8 (with or without a colour map), 24 and 32, types old and
    standard; gray by the reader's BGR2GRAY in 1/16384ths, and 0 for a
    1 or 8-bit raster without a colour map, as OpenCV's reader gives it.
  - PAM (`utils.io.pam_header`): GRAYSCALE, BLACKANDWHITE and RGB, maxval
    1-65535 (1: bits, as OpenCV's reader takes them; above 255 the high
    byte); colour in the file's sample order, gray of RGB in 1/16384ths.
  - Radiance HDR (`utils.io.hdr_header`): RGBE scanlines, run-length or
    flat, to floats as OpenCV's rgbe.cpp, times 255 rounded; gray by
    cvtColor's BGR2GRAY of those bytes.
  - PFM (`utils.io.pfm_header`): gray `Pf` read as gray, colour `PF` read
    as colour (BGR), each sample divided by |scale| and rounded, with no
    factor of 255; the other two reads fail in cv::imread and are refused.
  - TIFF (`utils.io.tiff_ifd`, pixels by `csrc/tiff.cpp`): page 0,
    strips and tiles, chunky and planar, classic and BigTIFF;
    uncompressed, CCITT fax (Modified Huffman, Group 3 1-D and 2-D, Group
    4, as libtiff's tif_fax3.c decodes them), LZW, PackBits, Deflate
    (inflated by zlib here) and JPEG (each strip or tile by
    `csrc/jpeg.cpp` after the JPEGTables stream, YCbCr to RGB as libtiff
    has libjpeg convert it, 4-sample RGB + alpha and CMYK left as they
    are); predictor 2; gray 1, 8, 16 bits, palette 1, 4, 8 bits, RGB 8
    and 16 bits with or without alpha, CMYK, YCbCr (4x4 to 1x1
    subsampling, libtiff's fixed-point conversion over the file's
    coefficients and reference black and white); orientations 1-4. Every
    value as libtiff's RGBA reader, through which cv::imread reads any
    8-bit TIFF, gives it; gray by the readers' BGR2GRAY in 1/16384ths of
    that colour. Damaged strips and tiles (corrupt or short LZW,
    Deflate, PackBits and CCITT data, damaged JPEG strips, byte counts
    past the file's end) read as that reader leaves them: what each codec
    decoded before its fault, zeros after it, no predictor or byte swap
    where the codec failed.
  - GIF (`utils.io.gif_blocks`, pixels by `csrc/gif.cpp`): GIF87a and
    GIF89a, the first image on its logical screen as OpenCV 5's GIF
    reader draws it (background colour, local and global tables, the
    transparent index not drawn, interlace); gray by cvtColor's BGR2GRAY
    in 1/32768ths.
  - JPEG 2000 (`utils.io.jp2_header`, the codestream by `csrc/jp2.cpp`):
    JP2 files and raw codestreams, 5/3 and 9/7, tiles and tile-parts,
    precincts, code-block sizes, the five progression orders, quality
    layers, the component transforms, as OpenJPEG 2.5 (cv::imread's
    reader) decodes them; samples above 8 bits shifted down to 8; colour
    components 2, 1, 0 as B, G, R (a gray colour space's one component
    replicated), alpha dropped; gray the one component, or cvtColor's
    BGR2GRAY in 1/32768ths of three.
The libraries are built with the host compiler at first use
(`kernels.build.load_host`). zlib and ctypes release the interpreter lock,
so a thread pool over the frames of a batch decodes them side by side.
There is no fallback to cv2 or PIL: a file refused raises ValueError
naming the cause, and a library that cannot be built raises RuntimeError.
"""

from __future__ import annotations

import ctypes
import functools
import zlib
from concurrent.futures import Executor
from typing import NamedTuple, Optional, Sequence

import numpy as np

from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.utils import io as uio

_I64, _PTR = ctypes.c_int64, ctypes.c_void_p
_ARGS = {
    "of_png_decode": ((_PTR, _I64, _I64, _I64, _PTR, _I64, _I64, _I64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, _PTR, _I64,
                       ctypes.c_int, ctypes.c_int, _PTR), _I64),
    "of_pnm_decode": ((_PTR, _I64, ctypes.c_int, _I64, _I64, ctypes.c_int,
                       ctypes.c_int, _PTR), _I64),
    "of_bmp_decode": ((_PTR, _I64, _I64, _I64, _I64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, _PTR, _PTR, ctypes.c_int,
                       _PTR), _I64),
}


# library name -> (the loaded library, its bound entries)
_bound: dict = {}


def _bind(lib_name: str, args: dict):
    """The C entries `args` names of host library `lib_name`, in order,
    their argtypes and restypes set once for each library loaded (a
    rebuilt library is bound anew)."""
    lib = build.load_host(lib_name)
    bound = _bound.get(lib_name)
    if bound is None or bound[0] is not lib:
        fns = []
        for name, (argtypes, restype) in args.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), restype
            fns.append(fn)
        bound = _bound[lib_name] = (lib, tuple(fns))
    return bound[1]


def _entries():
    """The PNG, PNM and BMP entries of `csrc/io_native.cpp`."""
    return _bind("io_native", _ARGS)


_RASTER_ARGS = {
    "of_ras_decode": ((_PTR, _I64, _I64, _I64, _I64, ctypes.c_int, _PTR,
                       ctypes.c_int, _PTR), _I64),
    "of_pam_decode": ((_PTR, _I64, _I64, _I64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _PTR), _I64),
    "of_hdr_decode": ((_PTR, _I64, _I64, _I64, ctypes.c_int, _PTR), _I64),
    "of_pfm_decode": ((_PTR, _I64, _I64, _I64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_double, ctypes.c_int, _PTR), _I64),
}


_JPEG_ARGS = {
    "of_jpeg_info": ((ctypes.c_void_p, ctypes.c_int64,
                      ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int)), ctypes.c_int),
    "of_jpeg_decode": ((ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_void_p), ctypes.c_int),
    "of_jpeg_strerror": ((ctypes.c_int,), ctypes.c_char_p),
    "of_jpeg_decode_tiff": ((_PTR, _I64, _PTR, _I64) + (ctypes.c_int,) * 7
                            + (_PTR,), ctypes.c_int),
}


def _jpeg_entries():
    """The JPEG library's four C entries."""
    return _bind("jpeg", _JPEG_ARGS)


def _jpeg_error(code: int) -> ValueError:
    return ValueError(_jpeg_entries()[2](code).decode())


def jpeg_info(raw: bytes):
    """(width, height, components) of a JPEG (1, 3 or 4 components), the
    size after its EXIF orientation. Raises ValueError on a file the
    decoder refuses in its header (12-bit samples, hierarchical or lossless
    arithmetic frames, 2 components, ...)."""
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
    its Y plane, or OpenCV's gray of a CMYK image (IMREAD_GRAYSCALE), 3 BGR
    (IMREAD_COLOR), the EXIF orientation applied. `out`, if given, is the C-contiguous array to
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


_WEBP_ARGS = {
    "of_webp_decode": ((_PTR, _I64, ctypes.c_int, _PTR, _I64) +
                       (ctypes.c_int,) * 8 + (_PTR,), ctypes.c_int),
    "of_webp_strerror": ((ctypes.c_int,), ctypes.c_char_p),
}


def decode_webp(raw: bytes, info: uio.WebP, channels: int,
                out: np.ndarray) -> None:
    """A parsed WebP (`utils.io.webp_chunks`) into `out` (channels, H, W)
    uint8, C-contiguous. Raises ValueError naming the cause."""
    decode, strerror = _bind("webp", _WEBP_ARGS)
    src = np.frombuffer(raw, np.uint8)
    base = src.ctypes.data
    err = decode(base + info.data_at, info.data_size, int(info.lossless),
                 None if info.alpha_at < 0 else base + info.alpha_at,
                 info.alpha_size, info.frame_width, info.frame_height,
                 info.canvas_width, info.canvas_height, info.x0, info.y0,
                 info.orientation, channels, out.ctypes.data)
    if err:
        raise ValueError(strerror(err).decode())


class JpegHeader(NamedTuple):
    width: int              # after the EXIF orientation
    height: int


class Frame(NamedTuple):
    kind: str               # a `utils.io.image_kind`
    width: int
    height: int
    info: object            # utils.io.Png / Pnm / Bmp / WebP / Ras / Pam /
                            # Hdr / Pfm / Tiff / Gif / Jp2, or a
                            # JpegHeader
    raw: bytes              # the file


def _jpeg_header(raw: bytes) -> JpegHeader:
    return JpegHeader(*jpeg_info(raw)[:2])


# kind -> its header parser
_HEADERS = {"png": uio.png_chunks, "pnm": uio.pnm_header,
            "bmp": uio.bmp_header, "jpeg": _jpeg_header,
            "webp": uio.webp_chunks, "ras": uio.ras_header,
            "pam": uio.pam_header, "hdr": uio.hdr_header,
            "pfm": uio.pfm_header, "tiff": uio.tiff_ifd,
            "gif": uio.gif_blocks, "jp2": uio.jp2_header}


def parse(raw: bytes) -> Frame:
    """A frame's format, size and parsed header (for a PNG its inflated
    image data too). Raises ValueError naming the cause on a file the
    decoders refuse in its header or chunks, or larger than cv::imread
    reads (`utils.io.check_cv_size`)."""
    raw = bytes(raw)        # the decoders take its buffer (no copy of bytes)
    kind = uio.image_kind(raw)
    info = _HEADERS[kind](raw)
    uio.check_cv_size(info.width, info.height)
    return Frame(kind, info.width, info.height, info, raw)


def _read(path: str) -> Frame:
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return parse(raw)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _check(err: int, msgs: dict) -> None:
    """Raise ValueError for a C decoder's error code (0: none)."""
    if err:
        raise ValueError(msgs.get(err, f"decoder error {err}"))


_PNG_ERRORS = {-1: "out of memory", -2: "bad PNG layout",
               -4: "PNG image data of the wrong size",
               -5: "PNG IDAT chunk: CRC error"}
_PNM_ERRORS = {-1: "truncated PNM data",
               -2: "bad byte or number in ASCII PNM data"}
_BMP_ERRORS = {-1: "truncated BMP data", -2: "bad BMP layout",
               -3: "corrupt BMP: an RLE run crosses its row's end"}
_RAS_ERRORS = {-1: "truncated Sun raster data", -2: "bad Sun raster layout"}
_PAM_ERRORS = {-1: "truncated PAM data", -2: "bad PAM layout"}
_HDR_ERRORS = {-1: "truncated Radiance HDR data",
               -2: "bad Radiance HDR layout",
               -3: "corrupt Radiance HDR run-length scanline"}
_PFM_ERRORS = {-1: "truncated PFM data", -2: "bad PFM layout"}


def _decode_png(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    if channels == 1 and info.color_type & 2:
        if uio.icc_may_be_srgb(info.iccp):
            raise ValueError("colour PNG with an sRGB ICC profile read as "
                             "gray: libpng's gamma for it is not "
                             "reproduced")
        if 0 < info.gamma < 5 or info.gamma > 0x7FFFFFFF:
            raise ValueError(f"PNG gAMA {info.gamma} out of range for a "
                             "gray read")
    # bytes pass as pointers to their buffers, without a copy
    err = _entries()[0](frame.raw, len(frame.raw), info.idat_at,
                        info.idat_count, info.data, len(info.data),
                        info.width, info.height, info.bit_depth,
                        info.color_type, info.interlace, info.palette,
                        info.gamma, info.sig_bit, channels, out.ctypes.data)
    if err > 0:
        raise ValueError(f"bad PNG filter: row {err - 1}: unknown filter "
                         "type")
    _check(err, _PNG_ERRORS)


def _decode_pnm(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    body = np.frombuffer(frame.raw, np.uint8)[info.offset:]
    _check(_entries()[1](body.ctypes.data, body.size, info.kind, info.width,
                         info.height, info.maxval, channels,
                         out.ctypes.data), _PNM_ERRORS)


def _decode_bmp(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    src = np.frombuffer(frame.raw, np.uint8)
    pal = np.frombuffer(info.palette, np.uint8)
    masks = None if info.masks is None else \
        np.asarray(info.masks, np.uint32)
    _check(_entries()[2](src.ctypes.data, src.size, info.offset, info.width,
                         info.height, int(info.top_down), info.bpp, info.rle,
                         pal.ctypes.data,
                         None if masks is None else masks.ctypes.data,
                         channels, out.ctypes.data), _BMP_ERRORS)


def _decode_jpeg(frame: Frame, channels: int, out: np.ndarray) -> None:
    decode_jpeg(frame.raw, channels, out=out)


def _decode_webp(frame: Frame, channels: int, out: np.ndarray) -> None:
    decode_webp(frame.raw, frame.info, channels, out)


def _decode_ras(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    src = np.frombuffer(frame.raw, np.uint8)
    pal = None if info.palette is None else \
        np.frombuffer(info.palette, np.uint8)
    _check(_bind("raster", _RASTER_ARGS)[0](
        src.ctypes.data, src.size, info.offset, info.width, info.height,
        info.depth, None if pal is None else pal.ctypes.data, channels,
        out.ctypes.data), _RAS_ERRORS)


def _decode_pam(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    body = np.frombuffer(frame.raw, np.uint8)[info.offset:]
    _check(_bind("raster", _RASTER_ARGS)[1](
        body.ctypes.data, body.size, info.width, info.height, info.depth,
        info.maxval, channels, out.ctypes.data), _PAM_ERRORS)


def _decode_hdr(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    body = np.frombuffer(frame.raw, np.uint8)[info.offset:]
    _check(_bind("raster", _RASTER_ARGS)[2](
        body.ctypes.data, body.size, info.width, info.height, channels,
        out.ctypes.data), _HDR_ERRORS)


_TIFF_ARGS = {
    "of_tiff_decode": ((_PTR, _PTR, _PTR, _I64, _PTR, _PTR, _PTR,
                        ctypes.c_int, _PTR), _I64),
}
_TIFF_ERRORS = {-2: "bad TIFF layout", -4: "out of memory",
                -5: "old-style TIFF LZW (TIFF 5.0) is not supported",
                -6: "corrupt TIFF CCITT data on which libtiff reads memory "
                    "outside its run arrays"}


# byte -> the byte with its bits reversed (FillOrder 2)
_REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))

# RFC 1951's length and distance bases and extra bits
_LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
             43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
_LEN_EXTRA = (0,) * 8 + tuple(k for k in range(1, 6) for _ in range(4)) + (0,)
_DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
              257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
              12289, 16385, 24577)
_DIST_EXTRA = (0,) * 4 + tuple(k for k in range(1, 14) for _ in range(2))
_CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15)


class _Stop(Exception):
    """zlib's inflate stops: corrupt data, or the data end."""


def _huffman(lengths, kind):
    """{(length, code): symbol} of canonical code `lengths`, or _Stop
    where zlib's inflate_table fails: an over-subscribed set, or an
    incomplete one but for a literal / length or distance set of one
    code of one bit (all lengths 0 builds a set that matches nothing)."""
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    count[0] = 0
    left, top = 1, max(lengths, default=0)
    for n in range(1, 16):
        left = 2 * left - count[n]
        if left < 0:
            raise _Stop
    if top and left > 0 and (kind == "codes" or top != 1):
        raise _Stop
    code, nxt, table = 0, [0] * 16, {}
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        nxt[n] = code
    for sym, n in enumerate(lengths):
        if n:
            table[(n, nxt[n])] = sym
            nxt[n] += 1
    return table


@functools.lru_cache(maxsize=None)
def _fixed_codes():
    """RFC 1951's fixed literal / length and distance codes."""
    return (_huffman([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, "lens"),
            _huffman([5] * 32, "dists"))


def _inflate_prefix(data: bytes, need: int) -> bytes:
    """The bytes zlib's inflate writes from the zlib stream `data` into a
    buffer of `need` before it stops on corrupt data or at the data's end
    (libtiff's ZIPDecode then returns what it wrote): every symbol
    decoded before the faulty one, the last match cut at `need`. Used
    where `zlib` raises, whose error keeps no partial output."""
    out = bytearray()
    pos = 0
    hold = nbits = 0

    def bits(n):
        nonlocal pos, hold, nbits
        while nbits < n:
            if pos >= len(data):
                raise _Stop
            hold |= data[pos] << nbits
            pos += 1
            nbits += 8
        v = hold & ((1 << n) - 1)
        hold >>= n
        nbits -= n
        return v

    def symbol(table):
        code = 0
        for n in range(1, 16):
            code = code << 1 | bits(1)
            sym = table.get((n, code))
            if sym is not None:
                return sym
        raise _Stop

    try:
        cmf, flg = bits(8), bits(8)
        if (cmf << 8 | flg) % 31 or cmf & 15 != 8 or cmf >> 4 > 7 \
                or flg & 0x20:
            raise _Stop
        last = 0
        while not last and len(out) < need:
            last, kind = bits(1), bits(2)
            if kind == 0:
                bits(nbits & 7)
                n, inv = bits(16), bits(16)
                if n != inv ^ 0xFFFF:
                    raise _Stop
                for _ in range(n):
                    if len(out) >= need:
                        return bytes(out)
                    out.append(bits(8))
                continue
            if kind == 1:
                lit, dist = _fixed_codes()
            elif kind == 2:
                nlen, ndist, ncode = bits(5) + 257, bits(5) + 1, bits(4) + 4
                if nlen > 286 or ndist > 30:
                    raise _Stop
                cl = [0] * 19
                for k in range(ncode):
                    cl[_CL_ORDER[k]] = bits(3)
                codes = _huffman(cl, "codes")
                lens = []
                while len(lens) < nlen + ndist:
                    sym = symbol(codes)
                    if sym < 16:
                        lens.append(sym)
                        continue
                    if sym == 16:
                        if not lens:
                            raise _Stop
                        rep, val = 3 + bits(2), lens[-1]
                    elif sym == 17:
                        rep, val = 3 + bits(3), 0
                    else:
                        rep, val = 11 + bits(7), 0
                    if len(lens) + rep > nlen + ndist:
                        raise _Stop
                    lens += [val] * rep
                if lens[256] == 0:
                    raise _Stop
                lit = _huffman(lens[:nlen], "lens")
                dist = _huffman(lens[nlen:], "dists")
            else:
                raise _Stop
            while True:
                if len(out) >= need:
                    return bytes(out)
                sym = symbol(lit)
                if sym < 256:
                    out.append(sym)
                    continue
                if sym == 256:
                    break
                if sym > 285:
                    raise _Stop
                k = sym - 257
                length = _LEN_BASE[k] + bits(_LEN_EXTRA[k])
                d = symbol(dist)
                if d > 29:
                    raise _Stop
                d = _DIST_BASE[d] + bits(_DIST_EXTRA[d])
                if d > len(out):
                    raise _Stop
                for _ in range(min(length, need - len(out))):
                    out.append(out[-d])
    except _Stop:
        pass
    return bytes(out[:need])


def _inflate_chunk(data: bytes, need: int):
    """(`need` bytes, whether ZIPDecode succeeds) of a Deflate chunk:
    zlib's output, or where zlib fails (corrupt data, a bad check
    after the last byte, data that end early) what it wrote before it
    stopped, zeros after it."""
    try:
        buf = zlib.decompressobj().decompress(data, need)
        if len(buf) == need:
            return buf, True
    except zlib.error:
        pass
    buf = _inflate_prefix(data, need)
    return buf + bytes(need - len(buf)), False


def _tiff_chunks(frame: Frame):
    """(addresses, sizes, states, buffers to keep alive) of a TIFF's
    strips or tiles as `of_tiff_decode` takes them: stored bytes for
    compression 1 to 5 and 32773; each Deflate chunk inflated to the bytes
    libtiff decodes from it (`utils.io.tiff_chunk_bytes`: its ZIPDecode
    stops there too), state 1 where ZIPDecode fails (what it wrote, zeros
    after it: libtiff then undoes no predictor); each JPEG chunk decoded
    by csrc/jpeg.cpp after the JPEGTables stream, to 8-bit samples, as
    libtiff's tif_jpeg.c has libjpeg decode it. A chunk libtiff cannot read
    (`utils.io.Tiff.unread`: a byte count of 0 or past the file's end in a
    plane after the first) is given as state 1 and no bytes: zeros."""
    info = frame.info
    src = np.frombuffer(frame.raw, np.uint8)
    base = src.ctypes.data
    states = np.asarray([int(i in info.unread)
                         for i in range(len(info.offsets))], np.uint8)
    if info.compression in (1, 2, 3, 4, 5, 32773):
        return ([base + o for o in info.offsets],
                [0 if u else c for u, c in zip(states, info.counts)], states,
                None)
    spc = 1 if info.planar == 2 and info.spp > 1 else info.spp
    across = -(-info.width // info.chunk_width)
    per_plane = across * -(-info.height // info.chunk_height)
    keep, addrs = [], []
    for i, (off, cnt) in enumerate(zip(info.offsets, info.counts)):
        y0 = (i % per_plane) // across * info.chunk_height
        rows = info.chunk_height if info.tiled else min(
            info.chunk_height, info.height - y0)
        if states[i]:
            buf = np.zeros(0, np.uint8)
        elif info.compression == 7:
            buf = np.empty((rows, info.chunk_width, spc), np.uint8)
            tables = info.jpeg_tables or (0, 0)
            last = not info.tiled and y0 + rows == info.height
            err = _jpeg_entries()[3](
                base + tables[0], tables[1], base + off, cnt,
                int(info.photometric == 6), info.chunk_width, rows, spc,
                *info.subsampling, int(last), buf.ctypes.data)
            if err:
                raise _jpeg_error(err)
        else:
            data = frame.raw[off:off + cnt]
            if info.fill_order == 2:
                data = data.translate(_REVERSED_BITS)
            buf, ok = _inflate_chunk(data, uio.tiff_chunk_bytes(info, rows))
            buf = np.frombuffer(buf, np.uint8)
            states[i] = not ok
        keep.append(buf)
        addrs.append(buf.ctypes.data)
    return addrs, [b.nbytes for b in keep], states, keep


def _decode_tiff(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    addrs, sizes, states, keep = _tiff_chunks(frame)
    decoded = keep is not None      # inflated or JPEG-decoded: as stored
    jpeg = info.compression == 7
    params = np.array([
        info.width, info.height, 8 if jpeg else info.bits, info.spp,
        1 if decoded else info.compression,
        2 if jpeg and info.photometric == 6 else info.photometric,
        info.planar, info.predictor, 1 if decoded else info.fill_order,
        info.alpha, int(info.big_endian), int(info.tiled), info.chunk_width,
        info.chunk_height, info.orientation, info.fax_options,
        *info.subsampling], np.int64)
    pal = np.frombuffer(info.palette or bytes(768), np.uint8)
    ycc = np.asarray(info.ycbcr or (0.0,) * 9, np.float32)
    sizes = np.asarray(sizes, np.int64)     # alive through the call
    _check(_bind("tiff", _TIFF_ARGS)[0](
        (ctypes.c_void_p * len(addrs))(*addrs), sizes.ctypes.data,
        states.ctypes.data, len(addrs), params.ctypes.data,
        pal.ctypes.data, ycc.ctypes.data, channels, out.ctypes.data),
        _TIFF_ERRORS)


_GIF_ARGS = {
    "of_gif_decode": ((_PTR, _I64, _I64, ctypes.c_int, _I64, _I64, _I64,
                       _I64, ctypes.c_int, _I64, _I64, _PTR, ctypes.c_int,
                       ctypes.c_int, _PTR, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _PTR), _I64),
}
_GIF_ERRORS = {-1: "truncated GIF image data (no LZW End code)",
               -2: "bad GIF layout", -3: "corrupt GIF LZW data",
               -4: "GIF image data of more or fewer pixels than the image, "
                   "or data after its End code",
               -5: "GIF pixel index outside its colour tables",
               -6: "out of memory"}


def _decode_gif(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    src = np.frombuffer(frame.raw, np.uint8)
    base = src.ctypes.data
    gct, ngct = (base + info.gct[0], info.gct[1]) if info.gct else (None, 0)
    lct, nlct = (base + info.lct[0], info.lct[1]) if info.lct else (None, 0)
    _check(_bind("gif", _GIF_ARGS)[0](
        base, src.size, info.data_at, info.min_code_size, info.frame_width,
        info.frame_height, info.left, info.top, int(info.interlace),
        info.width, info.height, gct, ngct, info.background, lct, nlct,
        info.transparent, channels, out.ctypes.data), _GIF_ERRORS)


_JP2_ARGS = {
    "of_jp2_decode": ((_PTR, _I64, _I64, _PTR, ctypes.c_int, ctypes.c_int,
                       _PTR), ctypes.c_int),
    "of_jp2_strerror": ((ctypes.c_int,), ctypes.c_char_p),
}


def _decode_jp2(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    # which components cv::imread's reader lays out (OpenCV 5's
    # grfmt_jpeg2000_openjpeg.cpp): gray space, component 0 (replicated
    # for colour); sRGB or unknown, B, G, R of components 2, 1, 0 (gray:
    # their BGR2GRAY) from three components up, component 0 for gray below
    if info.colour == "gray" or (channels == 1 and info.components < 3):
        layout = 0
    elif info.components < 3:
        raise ValueError(f"JPEG 2000 of {info.components} components in an "
                         "sRGB or unspecified colour space read as colour "
                         "(cv::imread fails on it too)")
    else:
        layout = 1 if channels == 3 else 2
    decode, strerror = _bind("jp2", _JP2_ARGS)
    src = np.frombuffer(frame.raw, np.uint8)
    params = np.frombuffer(info.params, np.int64)
    err = decode(src.ctypes.data + info.stream_at, info.stream_size,
                 info.sot_at, params.ctypes.data, channels, layout,
                 out.ctypes.data)
    if err:
        raise ValueError(strerror(err).decode())


def _decode_pfm(frame: Frame, channels: int, out: np.ndarray) -> None:
    info = frame.info
    if (channels == 3) != info.colour:
        read = "colour" if channels == 3 else "gray"
        raise ValueError(f"{'colour PF' if info.colour else 'gray Pf'} PFM "
                         f"read as {read}: cv::imread fails on it too")
    body = np.frombuffer(frame.raw, np.uint8)[info.offset:]
    _check(_bind("raster", _RASTER_ARGS)[3](
        body.ctypes.data, body.size, info.width, info.height,
        int(info.colour), int(info.big_endian), info.scale, channels,
        out.ctypes.data), _PFM_ERRORS)


# kind -> its decoder
_DECODERS = {"png": _decode_png, "pnm": _decode_pnm, "bmp": _decode_bmp,
             "jpeg": _decode_jpeg, "webp": _decode_webp, "ras": _decode_ras,
             "pam": _decode_pam, "hdr": _decode_hdr, "pfm": _decode_pfm,
             "tiff": _decode_tiff, "gif": _decode_gif, "jp2": _decode_jp2}


def decode_into(frame: Frame, channels: int, out: np.ndarray) -> None:
    """Decode one parsed frame into `out` (channels, H, W) uint8,
    C-contiguous. Raises ValueError naming the cause."""
    _DECODERS[frame.kind](frame, channels, out)


def decode_image(raw: bytes, channels: int) -> np.ndarray:
    """One image file's bytes (any format of `utils.io.FORMATS`) to
    (channels, H, W) uint8, as cv::imread gives it (see the module
    docstring)."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    frame = parse(raw)
    out = np.empty((channels, frame.height, frame.width), np.uint8)
    decode_into(frame, channels, out)
    return out


def decode_batch(paths: Sequence[str], channels: int,
                 pool: Optional[Executor] = None,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode frames of one size in any format of `utils.io.FORMATS`,
    mixed or not, to (B, C, H, W) uint8 as cv::imread gives them (equal to
    `utils.io.load_image`'s values): C = 1 gray (IMREAD_GRAYSCALE), C = 3
    in BGR order. Each frame is read, parsed and decoded on `pool`'s
    threads, if given; `out`, if given, is the C-contiguous (B, C, H, W)
    uint8 array to fill (a pinned host buffer, say). Raises ValueError on
    a frame it cannot decode or of another size, and RuntimeError if a
    decoder library cannot be built."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    paths = list(paths)
    if not paths:
        raise ValueError("decode_batch: no frames")
    first = _read(paths[0])
    shape = (len(paths), channels, first.height, first.width)
    if out is None:
        out = np.empty(shape, np.uint8)
    elif (out.dtype != np.uint8 or not out.flags.c_contiguous
          or out.shape[:2] != shape[:2]):
        raise ValueError(f"out must be a C-contiguous uint8 array of shape "
                         f"{shape}, got {out.dtype} {out.shape}")

    def one(i: int) -> None:
        frame = first if i == 0 else _read(paths[i])
        if (frame.height, frame.width) != out.shape[2:]:
            raise ValueError(f"{paths[i]}: {frame.width}x{frame.height} "
                             f"frame in a batch of {out.shape[3]}x"
                             f"{out.shape[2]}")
        try:
            decode_into(frame, channels, out[i])
        except ValueError as e:
            raise ValueError(f"{paths[i]}: {e}") from None

    if pool is None:
        for i in range(len(paths)):
            one(i)
    else:
        for fut in [pool.submit(one, i) for i in range(len(paths))]:
            fut.result()
    return out
