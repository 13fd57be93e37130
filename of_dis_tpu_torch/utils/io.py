"""Flow/depth/image file I/O for the port, in numpy and the standard library.

Byte-compatible with the reference writers/readers:
  - `.flo`: "PIEH" magic + int32 width/height + row-major float32 payload with
    1 (depth), 2 (flow) or 4 (scene flow) channels (reference: run_dense.cpp:17-58).
  - `.pfm`: "Pf" header, bottom-up rows, NEGATED depth values, scale -1.0
    written via printf("%f") (reference: run_dense.cpp:61-82).
  - image loading reads PNG, PNM (P1-P6), BMP, JPEG, WebP, Sun raster,
    PAM, Radiance HDR, PFM, TIFF, GIF and JPEG 2000 frames with the values
    cv::imread gives (run_dense.cpp:200-210), with no OpenCV, PIL,
    libwebp, libtiff, giflib or OpenJPEG: the headers, chunks, IFDs,
    blocks, boxes and main headers are parsed here (PNG image data and
    TIFF Deflate chunks inflated by zlib) and the pixels decoded by the
    port's host libraries (`native.io`: csrc/io_native.cpp,
    csrc/jpeg.cpp, csrc/webp.cpp, csrc/raster.cpp, csrc/tiff.cpp,
    csrc/gif.cpp, csrc/jp2.cpp). Gray is what cv::imread(GRAYSCALE)
    gives, by each reader's own rule (see `native.io`); the EXIF
    orientation of a JPEG and a WebP, and a TIFF's orientation tag, are
    applied; a CMYK or YCCK JPEG is turned into BGR and gray by OpenCV's
    own CMYK rules, as cv::imread turns it.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

_FLO_MAGIC = b"PIEH"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"  # SOI, then a marker's FF
FORMATS = ("PNG, PNM (P1-P6), BMP, JPEG (Huffman or arithmetic, sequential, "
           "progressive or lossless; gray, YCbCr, RGB, CMYK or YCCK), WebP, "
           "Sun raster, PAM, Radiance HDR, PFM, TIFF (CCITT fax, YCbCr and "
           "JPEG-in-TIFF among them), GIF and JPEG 2000")


def write_flo(path: str, data: np.ndarray) -> None:
    """Write a (H, W, C) float32 array as .flo (reference: run_dense.cpp:17-58)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, nc = data.shape
    if nc not in (1, 2, 4):
        raise ValueError(f"flo supports 1/2/4 channels, got {nc}")
    with open(path, "wb") as f:
        f.write(_FLO_MAGIC)
        f.write(struct.pack("<ii", w, h))
        f.write(data.tobytes())


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file, inferring the channel count from the payload size
    (run_dense.cpp:85-129)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != _FLO_MAGIC:
        raise ValueError(f"{path}: bad .flo magic {raw[:4]!r}")
    w, h = struct.unpack("<ii", raw[4:12])
    payload = np.frombuffer(raw, dtype=np.float32, offset=12)
    nc = payload.size // (w * h)
    if nc * w * h != payload.size or nc not in (1, 2, 4):
        raise ValueError(f"{path}: payload size {payload.size} != {w}x{h}xC")
    return payload.reshape(h, w, nc).copy()


def write_pfm(path: str, depth: np.ndarray) -> None:
    """Write a (H, W) float32 depth map as .pfm, negated + bottom-up
    (run_dense.cpp:61-82)."""
    depth = np.ascontiguousarray(depth, dtype=np.float32)
    if depth.ndim == 3:
        depth = depth[:, :, 0]
    h, w = depth.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n%d %d\n%f\n" % (w, h, -1.0))
        f.write((-depth[::-1]).tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Read a .pfm written by `write_pfm` (returns the un-negated depth)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"Pf":
            raise ValueError(f"{path}: expected grayscale Pf, got {magic!r}")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4",
                             count=h * w)
    return (-data.reshape(h, w)[::-1]).copy()




# ------------------------------------------------------------------- PNG

# samples a pixel and the bit depths allowed, by PNG colour type
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
              3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# libpng's limit on either side (PNG_USER_WIDTH_MAX / HEIGHT_MAX)
MAX_SIDE = 1_000_000
# cv::imread's limits on any image (validateInputImageSize with the
# defaults of CV_IO_MAX_IMAGE_WIDTH, _HEIGHT and _PIXELS): it fails on a
# larger header before it reads the data
CV_MAX_SIDE = 1 << 20
CV_MAX_PIXELS = 1 << 30
# Lengths of the ICC sRGB profiles that libpng 1.6 recognises in an iCCP
# chunk and then treats as an sRGB chunk (gamma 45455): a colour PNG with
# such a profile is refused when read as gray (see `icc_may_be_srgb`).
_SRGB_ICC_LENGTHS = frozenset((3024, 3048, 3052, 3144, 60960, 60988))


class Png(NamedTuple):
    """A PNG's header, what of its ancillary chunks cv::imread's pixels
    depend on, and its inflated image data (filtered rows, pass after pass
    if interlaced)."""
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int
    palette: bytes      # 256 RGB triples, black past PLTE's entries
    gamma: int          # file gamma in 1e-5 (sRGB 45455), 0 for none
    sig_bit: int        # sBIT of a 16-bit colour image, 0 for none
    iccp: tuple         # the iCCP chunks' compressed profiles
    idat_at: int        # offset in the file of its first IDAT chunk
    idat_count: int     # its IDAT chunks, consecutive
    data: bytes


def check_cv_size(width: int, height: int) -> None:
    """Raise ValueError for an image larger than cv::imread reads."""
    if width > CV_MAX_SIDE or height > CV_MAX_SIDE \
            or width * height > CV_MAX_PIXELS:
        raise ValueError(f"image of {width}x{height} pixels, above cv::"
                         "imread's limits of 2^20 a side and 2^30 pixels "
                         "(it fails on it too)")


def png_data_size(width: int, height: int, bit_depth: int, color_type: int,
                  interlace: int) -> int:
    """Bytes of a PNG's inflated image data: a filter byte and the packed
    samples of each row of each non-empty pass."""
    nch = _PNG_TYPES[color_type][0]
    size = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:
            size += ph * ((pw * nch * bit_depth + 7) // 8 + 1)
    return size


def _exif_orientation(tiff: bytes) -> Optional[int]:
    """The orientation tag (0x0112) of IFD0 of a TIFF-structured EXIF
    block, None if IFD0 has none; raises ValueError if the block cannot
    be read."""
    order = {b"II*\0": "<", b"MM\0*": ">"}.get(tiff[:4])
    if order is None or len(tiff) < 8:
        raise ValueError("unreadable eXIf")
    ifd = struct.unpack(order + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        raise ValueError("unreadable eXIf")
    n = struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]
    for k in range(n):
        e = ifd + 2 + 12 * k
        if e + 12 > len(tiff):
            raise ValueError("unreadable eXIf")
        tag, typ, count = struct.unpack(order + "HHI", tiff[e:e + 8])
        if tag == 0x0112:
            if typ != 3 or count != 1:
                raise ValueError("unreadable eXIf orientation")
            return struct.unpack(order + "H", tiff[e + 8:e + 10])[0]
    return None


def _check_idat_crcs(view: memoryview, at: int, count: int) -> None:
    """Raise ValueError if one of the `count` consecutive IDAT chunks from
    offset `at` has a wrong CRC: the cause libpng finds first in image data
    that does not inflate (where it does, the pixel decoder checks them)."""
    for _ in range(count):
        length = struct.unpack(">I", view[at:at + 4])[0]
        if struct.unpack(">I", view[at + 8 + length:at + 12 + length])[0] \
                != zlib.crc32(view[at + 4:at + 8 + length]):
            raise ValueError("PNG IDAT chunk: CRC error")
        at += 12 + length


def png_chunks(raw: bytes) -> Png:
    """Parse a PNG as libpng 1.6 reads it for cv::imread and inflate its
    image data. Critical chunks (IHDR first, PLTE for colour type 3, one
    run of IDAT, IEND) must be whole, with good CRCs (IDAT's are checked by
    the pixel decoder, `native.io.decode_into`, in the same C call as the
    pixels: a thread that hands the interpreter lock over once more a
    frame waits for it once more); an unknown critical chunk is refused. sRGB, gAMA, sBIT and iCCP count only before PLTE and
    IDAT, with the right length and a good CRC, the first of each (an sRGB
    chunk sets gamma 45455 whatever gAMA says); other ancillary chunks are
    skipped. Raises ValueError naming the cause, also for a PNG cv::imread
    would give other pixels for than `native.io` does (an eXIf orientation
    other than 1, which cv::imread applies)."""
    if raw[:8] != PNG_MAGIC:
        raise ValueError("not a PNG")
    pos, n = 8, len(raw)
    view = memoryview(raw)          # chunk payloads without copies
    ihdr = None
    palette = None
    gamma = srgb = sig_bit = None
    iccp = []
    idat, idat_at, idat_done, ended = [], 0, False, False
    while not ended:
        if pos + 12 > n:
            raise ValueError("truncated PNG (no IEND chunk)")
        length = struct.unpack(">I", raw[pos:pos + 4])[0]
        ctype = raw[pos + 4:pos + 8]
        if length > 0x7FFFFFFF or not ctype.isalpha():
            raise ValueError(f"corrupt PNG chunk {ctype!r}")
        if pos + 12 + length > n:
            raise ValueError(f"truncated PNG (in chunk {ctype!r})")
        payload = view[pos + 8:pos + 8 + length]
        if ctype == b"IDAT":        # its CRC checked by `of_png_decode`
            crc_ok = True
            idat_at = idat_at or pos
        else:
            payload = bytes(payload)
            crc_ok = struct.unpack(">I", raw[pos + 8 + length:
                                             pos + 12 + length])[0] == \
                zlib.crc32(view[pos + 4:pos + 8 + length])
        critical = ctype[:1].isupper()
        pos += 12 + length
        if critical and not crc_ok:
            raise ValueError(f"PNG {ctype.decode()} chunk: CRC error")
        if (ihdr is None) != (ctype == b"IHDR"):
            raise ValueError("corrupt PNG: IHDR is not the first chunk")
        if idat and ctype != b"IDAT":
            idat_done = True
        before_data = palette is None and not idat
        if ctype == b"IHDR":
            if length != 13:
                raise ValueError("corrupt PNG IHDR")
            ihdr = struct.unpack(">IIBBBBB", payload)
            w, h, bd, ct, comp, filt, lace = ihdr
            if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE):
                raise ValueError(f"PNG size {w}x{h} out of range")
            check_cv_size(w, h)     # before the image data is inflated
            if (ct not in _PNG_TYPES or bd not in _PNG_TYPES[ct][1]
                    or comp != 0 or filt != 0 or lace > 1):
                raise ValueError(f"corrupt PNG IHDR: bit depth {bd}, colour "
                                 f"type {ct}, methods {comp} {filt} {lace}")
        elif ctype == b"PLTE":
            ct, bd = ihdr[3], ihdr[2]
            if ct in (0, 4) or palette is not None or idat:
                raise ValueError("corrupt PNG: PLTE out of place")
            if length % 3 or not 3 <= length <= 768:
                raise ValueError(f"corrupt PNG PLTE of {length} bytes")
            # entries past 2^bit_depth are dropped, as libpng does
            palette = payload[:3 << bd].ljust(768, b"\0")
        elif ctype == b"IDAT":
            if idat_done:
                raise ValueError("corrupt PNG: IDAT chunks not consecutive")
            if ihdr[3] == 3 and palette is None:
                raise ValueError("corrupt PNG: no PLTE before IDAT")
            idat.append(payload)
        elif ctype == b"IEND":
            ended = True
        elif critical:
            raise ValueError(f"unsupported critical PNG chunk {ctype!r}")
        elif not crc_ok:
            continue
        elif ctype == b"eXIf":
            try:
                orientation = _exif_orientation(payload)
            except (ValueError, struct.error):
                raise ValueError("PNG eXIf block cannot be read (cv::imread "
                                 "applies its orientation)") from None
            if orientation not in (None, 1):
                raise ValueError(f"PNG eXIf orientation {orientation} is not "
                                 "supported (cv::imread applies it)")
        elif not before_data:
            continue
        elif ctype == b"gAMA" and gamma is None and length == 4:
            gamma = struct.unpack(">I", payload)[0]
        elif ctype == b"sRGB" and srgb is None and length == 1 \
                and payload[0] < 4:
            srgb = 45455
        elif ctype == b"sBIT" and sig_bit is None:
            ct, bd = ihdr[3], ihdr[2]
            want = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}[ct]
            depth = 8 if ct == 3 else bd
            if length == want and all(0 < v <= depth for v in payload):
                sig_bit = max(payload[:3]) if ct in (2, 6) else 0
        elif ctype == b"iCCP":
            iccp.append(payload[payload.find(b"\0") + 2:])
    w, h, bd, ct, _, _, lace = ihdr
    if not idat:
        raise ValueError("corrupt PNG: no IDAT chunk")
    size = png_data_size(w, h, bd, ct, lace)
    try:   # one output buffer of the image's size: no regrowth, no copy
        data = zlib.decompress(idat[0] if len(idat) == 1 else b"".join(idat),
                               bufsize=max(size, 1))
    except zlib.error as e:
        _check_idat_crcs(view, idat_at, len(idat))
        raise ValueError(f"PNG image data: {e}") from None
    if len(data) != size:
        _check_idat_crcs(view, idat_at, len(idat))
        raise ValueError(f"PNG image data of {len(data)} bytes, expected "
                         f"{size}")
    file_gamma = srgb or gamma or 0
    return Png(w, h, bd, ct, lace, palette or bytes(768), file_gamma,
               sig_bit or 0, tuple(iccp), idat_at, len(idat), data)


def icc_may_be_srgb(profiles) -> bool:
    """Whether libpng 1.6 may take one of a PNG's iCCP profiles (`Png.iccp`)
    for sRGB, and so read a colour PNG as gray through sRGB's gamma: a
    profile of one of the known sRGB profiles' lengths, or one that does
    not inflate. Inflated only here, for a gray read of a colour PNG."""
    for z in profiles:
        try:
            if len(zlib.decompress(z)) in _SRGB_ICC_LENGTHS:
                return True
        except zlib.error:
            return True
    return False


# ------------------------------------------------------------------- PNM

def _read_number(raw: bytes, pos: int):
    """OpenCV's PxM ReadNumber: whitespace and '#' comments skipped, any
    other byte an error, the digits read and the byte after them consumed.
    Returns (value, position after it)."""
    n = len(raw)
    while True:
        if pos >= n:
            raise ValueError("truncated PNM header")
        c = raw[pos]
        if 48 <= c <= 57:
            break
        if c == 35:                          # '#': to the end of the line
            while pos < n and raw[pos] not in (10, 13):
                pos += 1
        elif c not in b" \t\n\v\f\r":
            raise ValueError(f"corrupt PNM header: byte {c:#x}")
        pos += 1
    start = pos
    while pos < n and 48 <= raw[pos] <= 57:
        pos += 1
    if pos >= n:
        raise ValueError("truncated PNM header")
    value = int(raw[start:pos])
    if value > 0x7FFFFFFF:
        raise ValueError("corrupt PNM header: number too large")
    return value, pos + 1


class Pnm(NamedTuple):
    kind: int           # 1-6: P1 ... P6
    width: int
    height: int
    maxval: int         # 1 for P1 / P4
    offset: int         # first byte of the pixel data


def pnm_header(raw: bytes) -> Pnm:
    """The header of a P1-P6 file as OpenCV's PxM reader takes it: 'P', the
    kind, a whitespace byte, then width, height and (but for P1 / P4)
    maxval in 1..65535, the pixel data from the byte after maxval's
    first following byte. Raises ValueError naming the cause."""
    if raw[:1] != b"P" or raw[1:2] not in b"123456" or len(raw) < 3 \
            or raw[2] not in b" \t\n\v\f\r":
        raise ValueError("not a PNM (P1-P6) file")
    kind = raw[1] - 48
    width, pos = _read_number(raw, 2)
    height, pos = _read_number(raw, pos)
    maxval = 1
    if kind not in (1, 4):
        maxval, pos = _read_number(raw, pos)
    if not (0 < width <= MAX_SIDE and 0 < height <= MAX_SIDE):
        raise ValueError(f"PNM size {width}x{height} out of range")
    if not 0 < maxval <= 65535:
        raise ValueError(f"PNM maxval {maxval} out of range")
    return Pnm(kind, width, height, maxval, pos)


# ------------------------------------------------------------------- BMP

_BMP_COMPRESSION = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4",
                    3: "BI_BITFIELDS", 4: "BI_JPEG", 5: "BI_PNG",
                    6: "BI_ALPHABITFIELDS", 11: "BI_CMYK",
                    12: "BI_CMYKRLE8", 13: "BI_CMYKRLE4"}


class Bmp(NamedTuple):
    width: int
    height: int
    top_down: bool
    bpp: int            # 1, 4, 8, 15 (5-5-5), 16 (5-6-5), 24, 32
    rle: int            # 0, 8 (BI_RLE8), 4 (BI_RLE4)
    palette: bytes      # 256 B, G, R, reserved entries (zeros past its end)
    offset: int         # first byte of the pixel data
    masks: Optional[tuple]  # R, G, B masks of a masked 32-bit BMP


def bmp_header(raw: bytes) -> Bmp:
    """The header of a BMP as OpenCV's BMP reader takes it: a core (OS/2,
    12 bytes) header, or one of 36 bytes or more (INFO, V4, V5) with
    BI_RGB at 1, 4, 8, 16 (5-5-5), 24 and 32 bits, BI_RLE8 at 8, BI_RLE4
    at 4, BI_BITFIELDS at 16 (the 5-5-5 or 5-6-5 masks, read from the
    12 bytes after the header whatever its size) and 32 (the R, G, B masks
    of a header of 56 bytes or more applied where none is 0, else
    ignored); the palette read from just after the header. Raises
    ValueError naming the cause."""
    def dword(at):
        if at + 4 > len(raw):
            raise ValueError("truncated BMP header")
        return struct.unpack("<i", raw[at:at + 4])[0]

    if raw[:2] != b"BM":
        raise ValueError("not a BMP")
    offset, size = dword(10), dword(14)
    pal = bytearray(1024)
    masks = None
    if size >= 36:
        width, height = dword(18), dword(22)
        bpp, comp, used = dword(26) >> 16, dword(30), dword(46)
        at = 14 + size
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == 0)
            or (bpp in (16, 32) and comp in (0, 3))
            or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
        if not ok:
            if comp not in (0, 1, 2, 3):
                raise ValueError("unsupported BMP compression "
                                 f"{_BMP_COMPRESSION.get(comp, comp)}")
            raise ValueError(f"unsupported BMP: {bpp} bits, "
                             f"{_BMP_COMPRESSION.get(comp, comp)}, "
                             f"{width}x{height}")
        if bpp <= 8:
            if not 0 <= used <= 256:
                raise ValueError(f"corrupt BMP: {used} palette colours")
            count = 4 * (used or 1 << bpp)
            if at + count > len(raw):
                raise ValueError("truncated BMP palette")
            pal[:count] = raw[at:at + count]
        elif bpp == 16 and comp == 3:
            red, green, blue = dword(at), dword(at + 4), dword(at + 8)
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                raise ValueError("unsupported BMP 16-bit masks "
                                 f"{red:#x} {green:#x} {blue:#x}")
        elif bpp == 16:
            bpp = 15
        elif comp == 3 and size >= 56:
            masks = tuple(dword(54 + 4 * k) & 0xFFFFFFFF for k in range(3))
            if not all(masks):
                masks = None
    elif size == 12:
        if 26 > len(raw):
            raise ValueError("truncated BMP header")
        width, height = struct.unpack("<HH", raw[18:22])
        bpp, comp = dword(22) >> 16, 0
        if not (width > 0 and height > 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"unsupported BMP: {bpp} bits, core header")
        if bpp <= 8:
            count = 3 << bpp
            if 26 + count > len(raw):
                raise ValueError("truncated BMP palette")
            colours = np.frombuffer(raw, np.uint8, count, 26).reshape(-1, 3)
            quad = np.zeros((256, 4), np.uint8)
            quad[:len(colours), :3] = colours
            pal[:] = quad.tobytes()
    else:
        raise ValueError(f"unsupported BMP header of {size} bytes")
    if offset < 0:
        raise ValueError("corrupt BMP: negative data offset")
    if not (width <= MAX_SIDE and abs(height) <= MAX_SIDE):
        raise ValueError(f"BMP size {width}x{abs(height)} out of range")
    return Bmp(width, abs(height), height < 0, bpp,
               {1: 8, 2: 4}.get(comp, 0), bytes(pal), offset, masks)


# ------------------------------------------------------------------ WebP

WEBP_MIN_SIZE = 32       # cv::imread's WebP reader reads a 32-byte header
_MAX_CHUNK_PAYLOAD = 0xFFFFFFF6   # libwebp's ~0U - CHUNK_HEADER_SIZE - 1
_VP8X_ANIMATION, _VP8X_EXIF = 0x02, 0x08


class WebP(NamedTuple):
    """What of a WebP file its pixels depend on: frame 0's bitstream (the
    still image's, or an animation's first frame), where it lies on the
    canvas, and the EXIF orientation cv::imread applies."""
    width: int          # the image cv::imread returns, turned
    height: int
    lossless: bool      # VP8L, else VP8
    data_at: int        # offset of the VP8 / VP8L payload
    data_size: int      # bytes the bitstream decoder is given
    alpha_at: int       # offset of a lossy image's ALPH payload, -1: none
    alpha_size: int
    frame_width: int
    frame_height: int
    x0: int             # frame 0's place on the canvas
    y0: int
    canvas_width: int
    canvas_height: int
    orientation: int    # 1-8


def _le24(b: bytes) -> int:
    return b[0] | (b[1] << 8) | (b[2] << 16)


def _chunk_list(raw: bytes, pos: int, end: int):
    """(tag, payload offset, payload size) of the RIFF chunks from `pos`
    while a whole chunk header fits before `end`."""
    out = []
    while pos + 8 <= end:
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        out.append((raw[pos:pos + 4], pos + 8, size))
        pos += 8 + size + (size & 1)
    return out


def _walk_ends_at(raw: bytes, pos: int, end: int) -> bool:
    """Whether whole chunks (headers, padded payloads) from `pos` end
    exactly at `end`."""
    while pos < end:
        if pos + 8 > end:
            return False
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        pos += 8 + size + (size & 1)
    return pos == end


def _bitstream_size(raw: bytes, at: int, size: int, chunk_size: int,
                    lossless: bool):
    """(width, height) of a VP8 / VP8L bitstream of `size` bytes at `at`,
    checked as libwebp's VP8GetInfo / VP8LGetInfo check it."""
    if lossless:
        if size < 5 or raw[at] != 0x2F or raw[at + 4] >> 5:
            raise ValueError("corrupt WebP VP8L header")
        bits = int.from_bytes(raw[at + 1:at + 5], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if size < 10:
        raise ValueError("truncated WebP VP8 frame header")
    bits = _le24(raw[at:at + 3])
    if raw[at + 3:at + 6] != b"\x9d\x01\x2a":
        raise ValueError("corrupt WebP VP8 frame header (no start code)")
    if bits & 1:
        raise ValueError("WebP VP8 frame is not a key frame")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 \
            or bits >> 5 >= chunk_size:
        raise ValueError("corrupt WebP VP8 frame header")
    w = struct.unpack("<H", raw[at + 6:at + 8])[0] & 0x3FFF
    h = struct.unpack("<H", raw[at + 8:at + 10])[0] & 0x3FFF
    if w == 0 or h == 0:
        raise ValueError("WebP VP8 frame of size 0")
    return w, h


def _image_chunks(raw: bytes, chunks, riff_size: int, total: int):
    """The ALPH chunk and the VP8 / VP8L chunk that ends a run of chunks,
    as libwebp's ParseOptionalChunks walks them: (alpha offset, size or
    -1, 0), (tag, payload offset, size, index of the chunk)."""
    alpha = (-1, 0)
    for k, (tag, at, size) in enumerate(chunks):
        if size > _MAX_CHUNK_PAYLOAD:
            raise ValueError("corrupt WebP chunk size")
        total += 8 + size + (size & 1)
        if riff_size > 0 and total > riff_size:
            raise ValueError("WebP chunk beyond the RIFF size")
        if tag in (b"VP8 ", b"VP8L"):
            return alpha, (tag, at, size, k)
        if at + size + (size & 1) > len(raw):
            raise ValueError(f"truncated WebP (in chunk {tag!r})")
        if tag == b"ALPH":
            alpha = (at, size)
    raise ValueError("WebP has no VP8 / VP8L image chunk")


def _opencv_exif_orientation(tiff: bytes) -> int:
    """The orientation OpenCV's ExifReader finds in a TIFF-structured EXIF
    block (as csrc/jpeg.cpp's `read_exif`): IFD0's entries in order to the
    first 0x0112 tag; a read out of bounds, or a string or rational tag
    before it whose data lies out of bounds, ends the walk with none (1)."""
    size = len(tiff)
    order = "<" if tiff[:2] == b"II" else ">"

    def u16(off):
        return None if off < 0 or off + 1 >= size else \
            struct.unpack(order + "H", tiff[off:off + 2])[0]

    def u32(off):
        return None if off < 0 or off + 3 >= size else \
            struct.unpack(order + "I", tiff[off:off + 4])[0]

    def rationals(off, n):
        at = u32(off + 8)
        return at is not None and all(
            u32(at + 8 * i) is not None and u32(at + 8 * i + 4) is not None
            for i in range(n))

    ifd = u32(4)
    if u16(2) != 0x2A or ifd is None or u16(ifd) is None:
        return 1
    off = ifd + 2
    for _ in range(u16(ifd)):
        tag = u16(off)
        if tag is None:
            return 1
        if tag == 0x0112:
            v = u16(off + 8)
            return v if v is not None and 1 <= v <= 8 else 1
        ok = True
        if tag in (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298):
            n, at = u32(off + 4), 8
            if n is not None and n > 4:
                at = u32(off + 8)
            ok = n is not None and at is not None and at + n <= size
        elif tag in (0x011A, 0x011B):
            ok = rationals(off, 1)
        elif tag == 0x013E:
            ok = rationals(off, 2)
        elif tag in (0x013F, 0x0214):
            ok = rationals(off, 6)
        elif tag == 0x0211:
            ok = rationals(off, 3)
        elif tag in (0x0128, 0x0213):
            ok = u16(off + 8) is not None
        if not ok:
            return 1
        off += 12
    return 1


def webp_chunks(raw: bytes) -> WebP:
    """Parse a WebP as cv::imread reads it (OpenCV 5's WebP reader over
    libwebp): the RIFF header and size; a simple file's VP8 or VP8L chunk;
    an extended file's VP8X canvas and flags, its optional chunks up to
    the image chunk (the last ALPH counts; ICCP, XMP, unknown chunks are
    skipped), and the EXIF orientation of its first EXIF chunk where the
    EXIF flag is set; an animation's first ANMF frame (its rectangle on a
    canvas of zeros, its ALPH and image sub-chunks). The checks are
    libwebp's; the image chunk's bitstream is decoded by csrc/webp.cpp,
    which is given the bytes libwebp gives its decoder (a still image's
    payload to the end of the file). Raises ValueError naming the cause."""
    n = len(raw)
    if raw[:4] != b"RIFF" or raw[8:12] != b"WEBP":
        raise ValueError("not a WebP")
    if n < WEBP_MIN_SIZE:
        raise ValueError(f"WebP of {n} bytes (cv::imread reads 32 at least)")
    riff_size = struct.unpack("<I", raw[4:8])[0]
    if riff_size < 12 or riff_size > _MAX_CHUNK_PAYLOAD:
        raise ValueError(f"corrupt WebP RIFF size {riff_size}")
    if riff_size > n - 8:
        raise ValueError("truncated WebP (shorter than its RIFF size)")
    chunks = _chunk_list(raw, 12, n)
    if not chunks:
        raise ValueError("truncated WebP (no chunk)")
    flags = 0
    canvas = None
    first = chunks[0]
    if first[0] == b"VP8X":
        if first[2] != 10:
            raise ValueError(f"corrupt WebP VP8X chunk of {first[2]} bytes")
        if n < first[1] + 10:
            raise ValueError("truncated WebP VP8X chunk")
        at = first[1]
        flags = struct.unpack("<I", raw[at:at + 4])[0]
        canvas = (1 + _le24(raw[at + 4:at + 7]),
                  1 + _le24(raw[at + 7:at + 10]))
        check_cv_size(*canvas)  # frame 0 is drawn on a canvas this size
        chunks = chunks[1:]
    elif first[0] not in (b"VP8 ", b"VP8L"):
        raise ValueError(f"WebP chunk {first[0]!r} where VP8 / VP8L / VP8X "
                         "is expected")
    orientation = 1
    # OpenCV reads the EXIF chunk, and an animation's frames, through
    # libwebp's demuxer, which parses the chunks to the RIFF end and
    # fails if one of them is cut short there
    whole = _walk_ends_at(raw, 12, riff_size + 8)
    if canvas is not None and flags & _VP8X_EXIF and whole:
        exif = next(((at, size) for tag, at, size in chunks
                     if tag == b"EXIF"), None)
        if exif is not None and raw[exif[0]:exif[0] + 4] in (b"II*\0",
                                                             b"MM\0*"):
            orientation = _opencv_exif_orientation(
                raw[exif[0]:exif[0] + exif[1]])
    if canvas is not None and flags & _VP8X_ANIMATION:
        if not whole:
            raise ValueError("animated WebP with a chunk cut short (cv::"
                             "imread fails on it too)")
        return _webp_animation(raw, chunks, canvas, orientation)
    # an extended file's chunks count against the RIFF size, a simple
    # file's one chunk only by its own size (libwebp's ParseVP8Header)
    (alpha_at, alpha_size), (tag, at, size, _) = _image_chunks(
        raw, chunks, riff_size if canvas else 0, 22)
    if size > riff_size - 12:
        raise ValueError("WebP image chunk beyond the RIFF size")
    if at + size > n:
        raise ValueError(f"truncated WebP (in chunk {tag!r})")
    lossless = tag == b"VP8L"
    w, h = _bitstream_size(raw, at, n - at, size, lossless)
    if canvas is not None and canvas != (w, h):
        raise ValueError(f"WebP VP8X canvas {canvas[0]}x{canvas[1]} differs "
                         f"from its image's {w}x{h}")
    swap = orientation >= 5
    return WebP(h if swap else w, w if swap else h, lossless, at, n - at,
                -1 if lossless else alpha_at, alpha_size, w, h, 0, 0, w, h,
                orientation)


def _webp_animation(raw: bytes, chunks, canvas, orientation) -> WebP:
    """Frame 0 of an animated WebP, as WebPAnimDecoder gives it to
    cv::imread: its ANMF rectangle on a canvas of zeros, no blending (the
    first frame is a key frame), then the EXIF orientation."""
    tags = [c[0] for c in chunks]
    if b"ANIM" not in tags or b"ANMF" not in tags \
            or tags.index(b"ANIM") > tags.index(b"ANMF"):
        raise ValueError("corrupt animated WebP (no ANIM before ANMF)")
    tag, at, size = chunks[tags.index(b"ANMF")]
    if size < 16 + 8 or at + size > len(raw):
        raise ValueError("truncated animated WebP frame")
    x0, y0 = 2 * _le24(raw[at:at + 3]), 2 * _le24(raw[at + 3:at + 6])
    fw, fh = 1 + _le24(raw[at + 6:at + 9]), 1 + _le24(raw[at + 9:at + 12])
    if x0 + fw > canvas[0] or y0 + fh > canvas[1]:
        raise ValueError("animated WebP frame 0 does not fit its canvas")
    sub = _chunk_list(raw, at + 16, at + size)
    (alpha_at, alpha_size), (itag, iat, isize, k) = _image_chunks(
        raw, sub, 0, 0)
    if [c[0] for c in sub[:k]] not in ([], [b"ALPH"]):
        raise ValueError("animated WebP frame with chunks other than ALPH "
                         "before its image is not supported")
    if iat + isize > at + size:
        raise ValueError("truncated animated WebP frame")
    lossless = itag == b"VP8L"
    w, h = _bitstream_size(raw, iat, isize, isize, lossless)
    if (w, h) != (fw, fh):
        raise ValueError("animated WebP frame 0's bitstream size differs "
                         "from its ANMF rectangle")
    swap = orientation >= 5
    return WebP(canvas[swap], canvas[not swap], lossless, iat, isize,
                -1 if lossless else alpha_at, alpha_size, w, h, x0, y0,
                canvas[0], canvas[1], orientation)


# ----------------------------------------------------------- Sun raster

SUN_MAGIC = b"\x59\xa6\x6a\x95"
_SUN_TYPES = {0: "old", 1: "standard", 2: "byte-encoded (RLE)", 3: "RGB",
              4: "TIFF", 5: "IFF"}


class Ras(NamedTuple):
    width: int
    height: int
    depth: int          # 1, 8, 24, 32
    palette: Optional[bytes]  # 256 B, G, R triples of a colour map, None
    offset: int         # first byte of the pixel data


def ras_header(raw: bytes) -> Ras:
    """The header of a Sun raster as OpenCV's reader takes it: eight
    big-endian words (magic, width, height, depth, length, type, map type,
    map length); depth 1, 8, 24 or 32; types old (0) and standard (1); no
    colour map, or an RGB one (map type 1) of at most 3 * 2^depth bytes
    for depth 8 or less, R, G and B thirds, entries past its end black.
    Byte-encoded (RLE) and RGB-order files are refused: cv::imread fails
    on them too. Raises ValueError naming the cause."""
    if raw[:4] != SUN_MAGIC:
        raise ValueError("not a Sun raster")
    if len(raw) < 32:
        raise ValueError("truncated Sun raster header")
    _, w, h, depth, _, typ, maptype, maplen = struct.unpack(">8i", raw[:32])
    if not (w > 0 and h > 0 and depth in (1, 8, 24, 32)):
        raise ValueError(f"unsupported Sun raster: {w}x{h}, depth {depth}")
    if typ not in (0, 1):
        raise ValueError(f"{_SUN_TYPES.get(typ, f'type {typ}')} Sun raster "
                         "is not supported (cv::imread fails on it too)")
    pal_size = (1 << depth) * 3 if depth <= 8 else 0
    palette = None
    if maptype == 1 and 0 < maplen <= pal_size:
        if 32 + maplen > len(raw):
            raise ValueError("truncated Sun raster colour map")
        cmap = np.frombuffer(raw, np.uint8, maplen, 32)
        n = maplen // 3
        pal = np.zeros((256, 3), np.uint8)
        pal[:n, 0] = cmap[2 * n:3 * n]
        pal[:n, 1] = cmap[n:2 * n]
        pal[:n, 2] = cmap[:n]
        palette = pal.tobytes()
    elif not (maptype == 0 and maplen == 0):
        raise ValueError(f"unsupported Sun raster colour map: type {maptype}"
                         f", {maplen} bytes, depth {depth}")
    check_cv_size(w, h)
    return Ras(w, h, depth, palette, 32 + maplen)


# ------------------------------------------------------------------ PAM

_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE",
               b"ENDHDR")
_PAM_TUPLTYPES = (b"BLACKANDWHITE", b"GRAYSCALE", b"GRAYSCALE_ALPHA",
                  b"RGB", b"RGB_ALPHA")
_SPACE = b" \t\n\v\f\r"


class Pam(NamedTuple):
    width: int
    height: int
    depth: int          # samples a pixel: 1 or 3
    maxval: int
    offset: int         # first byte of the pixel data


def pam_header(raw: bytes) -> Pam:
    """The header of a PAM (P7) as OpenCV's PAM reader takes it: 'P7' and
    a line end, then lines of a field name and its value ('#' comments),
    WIDTH, HEIGHT, DEPTH and MAXVAL once each, TUPLTYPE BLACKANDWHITE,
    GRAYSCALE or RGB (or none: depth 1 or 3 and maxval below 256), to
    ENDHDR and the one byte after it. Tuple types with alpha are refused:
    cv::imread fills only part of each row of them. Raises ValueError
    naming the cause."""
    if raw[:2] != b"P7" or raw[2:3] not in (b"\n", b"\r"):
        raise ValueError("not a PAM (P7) file")
    pos, n = 3, len(raw)
    fields, tupltype = {}, None
    while True:
        while pos < n and raw[pos] in _SPACE:
            pos += 1
        if pos >= n:
            raise ValueError("truncated PAM header")
        if raw[pos] == 35:                              # '#'
            while pos < n and raw[pos] not in b"\n\r":
                pos += 1
            pos += 1
            continue
        start = pos
        while pos < n and raw[pos] not in _SPACE and pos - start < 8:
            pos += 1
        ident = raw[start:pos]
        if pos >= n or raw[pos] not in _SPACE or ident not in _PAM_FIELDS:
            raise ValueError(f"corrupt PAM header field {ident[:16]!r}")
        if ident == b"ENDHDR":
            if raw[pos] not in b"\n\r":
                raise ValueError("corrupt PAM header: ENDHDR not at a line "
                                 "end")
            pos += 1
            break
        if raw[pos] in b"\n\r":
            raise ValueError(f"PAM header field {ident.decode()} has no "
                             "value")
        while pos < n and raw[pos] in _SPACE:
            pos += 1
        start = pos
        while pos < n and raw[pos] not in b"\n\r" and pos - start < 255:
            pos += 1
        if pos >= n or raw[pos] not in b"\n\r":
            raise ValueError("corrupt PAM header: value not ended by a line "
                             "end")
        value = raw[start:pos].rstrip(_SPACE)
        pos += 1
        if ident == b"TUPLTYPE":
            if value not in _PAM_TUPLTYPES:
                raise ValueError(f"unsupported PAM TUPLTYPE {value[:32]!r} "
                                 "(cv::imread fails on it too)")
            tupltype = value
            continue
        if ident in fields:
            raise ValueError(f"PAM header field {ident.decode()} twice")
        if not value.isdigit() or len(value) > 9:
            raise ValueError(f"PAM {ident.decode()} {value[:32]!r} is not a "
                             "decimal number")
        fields[ident] = int(value)
    missing = [f.decode() for f in _PAM_FIELDS[:4] if f not in fields]
    if missing:
        raise ValueError(f"PAM header without {', '.join(missing)}")
    w, h = fields[b"WIDTH"], fields[b"HEIGHT"]
    depth, maxval = fields[b"DEPTH"], fields[b"MAXVAL"]
    if not (w > 0 and h > 0):
        raise ValueError(f"PAM size {w}x{h} out of range")
    check_cv_size(w, h)
    if not 0 < maxval <= 65535:
        raise ValueError(f"PAM maxval {maxval} out of range")
    if tupltype is None and not (depth in (1, 3) and maxval < 256):
        raise ValueError(f"PAM of depth {depth}, maxval {maxval} and no "
                         "TUPLTYPE (cv::imread fails on it too)")
    if tupltype is not None and tupltype.endswith(b"_ALPHA"):
        raise ValueError(f"PAM TUPLTYPE {tupltype.decode()} is not supported"
                         " (cv::imread fills only part of each row)")
    if tupltype is not None and depth != (3 if tupltype == b"RGB" else 1):
        raise ValueError(f"PAM TUPLTYPE {tupltype.decode()} with depth "
                         f"{depth} is not supported")
    if depth not in (1, 3):
        raise ValueError(f"PAM depth {depth} is not supported")
    return Pam(w, h, depth, maxval, pos)


# --------------------------------------------------------- Radiance HDR

HDR_MAGICS = (b"#?RADIANCE", b"#?RGBE")
_HDR_SIZE = re.compile(rb"-Y\s*([+-]?\d{1,9})\s*\+X\s*([+-]?\d{1,9})")


class Hdr(NamedTuple):
    width: int
    height: int
    offset: int         # first byte of the scanlines


def _fgets(raw: bytes, pos: int):
    """C's fgets into a 128-byte buffer: up to 127 bytes, through the
    first newline. Returns (line, position after it), line None at EOF."""
    if pos >= len(raw):
        return None, pos
    end = raw.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(raw)) if end < 0 else end + 1
    return raw[pos:end], end


def hdr_header(raw: bytes) -> Hdr:
    """The header of a Radiance HDR as OpenCV's RGBE_ReadHeader takes it:
    lines (as fgets reads them) to an empty one, among them exactly
    `FORMAT=32-bit_rle_rgbe` (EXPOSURE, GAMMA and other lines ignored);
    then the resolution line `-Y H +X W`, the pixel data after it. The
    XYZE format and other orientations are refused: cv::imread fails on
    them too. Raises ValueError naming the cause."""
    if not raw.startswith(HDR_MAGICS):
        raise ValueError("not a Radiance HDR")
    found = False
    line, pos = _fgets(raw, 0)
    while True:
        if line is None:
            raise ValueError("truncated Radiance HDR header")
        if line[:1] in (b"", b"\0", b"\n"):
            break
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            found = True
        line, pos = _fgets(raw, pos)
    if not found:
        raise ValueError("Radiance HDR without FORMAT=32-bit_rle_rgbe (the "
                         "XYZE format: cv::imread fails on it too)")
    line, pos = _fgets(raw, pos)
    m = _HDR_SIZE.match(line or b"")
    if m is None:
        raise ValueError("Radiance HDR resolution line other than -Y H +X W"
                         " (cv::imread fails on it too)")
    h, w = int(m.group(1)), int(m.group(2))
    if not (w > 0 and h > 0):
        raise ValueError(f"Radiance HDR size {w}x{h} out of range")
    check_cv_size(w, h)
    if not line.endswith(b"\n"):
        raise ValueError("Radiance HDR resolution line too long")
    return Hdr(w, h, pos)


# ------------------------------------------------------------------ PFM

class Pfm(NamedTuple):
    width: int
    height: int
    colour: bool        # PF (RGB), else Pf
    big_endian: bool    # a scale of 0 or more
    scale: float
    offset: int


def pfm_header(raw: bytes) -> Pfm:
    """The header of a PFM as OpenCV's PFM reader takes it: 'Pf' (gray) or
    'PF' (RGB), a newline, then width, height and scale, each ended by one
    whitespace byte; the scale's sign gives the byte order (negative
    little-endian). Raises ValueError naming the cause."""
    if raw[:2] not in (b"Pf", b"PF"):
        raise ValueError("not a PFM")
    if raw[2:3] != b"\n":
        raise ValueError("corrupt PFM header: no newline after its magic")
    pos, tokens = 3, []
    for _ in range(3):
        start = pos
        while pos < len(raw) and raw[pos] not in _SPACE and pos - start < 64:
            pos += 1
        if pos >= len(raw) or raw[pos] not in _SPACE:
            raise ValueError("truncated PFM header")
        tokens.append(raw[start:pos])
        pos += 1
    w, h, scale = tokens
    if not (w.isdigit() and h.isdigit()) or len(w) > 9 or len(h) > 9:
        raise ValueError(f"corrupt PFM size {w[:16]!r} {h[:16]!r}")
    try:
        s = float(scale)
    except ValueError:
        raise ValueError(f"corrupt PFM scale {scale[:16]!r}") from None
    if not (int(w) > 0 and int(h) > 0):
        raise ValueError(f"PFM size {int(w)}x{int(h)} out of range")
    check_cv_size(int(w), int(h))
    if s == 0 or s != s or abs(s) == float("inf"):
        raise ValueError(f"PFM scale {s} (cv::imread fails on it too)")
    return Pfm(int(w), int(h), raw[1:2] == b"F", s >= 0, s, pos)


# ------------------------------------------------------------------ TIFF

# the unsigned integer field types (BYTE, SHORT, LONG, LONG8) a numeric
# tag is read from; libtiff fails or skips a tag of another type
_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q"}
# libtiff's TIFFDataWidth of each field type
_TIFF_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                    10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_TIFF_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                      6: "old-style JPEG", 32771: "CCITT RLE (word)",
                      32809: "ThunderScan", 34661: "JBIG", 34676: "SGI Log",
                      34677: "SGI Log24", 34712: "JPEG 2000", 34925: "LZMA",
                      50000: "ZSTD", 50001: "WebP", 32908: "Pixar",
                      32909: "Pixar", 32947: "DCS", 34892: "lossy JPEG"}
# compressions cv::imread's libtiff reads and the port decodes
TIFF_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32773, 32946)
# libtiff 4.7's built-in codecs (tif_codec.c), and those of them on whose
# files cv::imread fails (not configured in its build, or failing there)
_TIFF_LIBTIFF_CODECS = frozenset(TIFF_COMPRESSIONS + (
    6, 32766, 32771, 32809, 32909, 34661, 34676, 34677, 34887, 34925, 50000,
    50001))
_TIFF_CV_FAILS = (32766, 32771, 32809, 34661, 34887, 34925, 50000, 50001)
_TIFF_PHOTOMETRICS = {4: "transparency mask", 8: "CIELab", 9: "ICCLab",
                      10: "ITULab", 32844: "LogL", 32845: "LogLuv",
                      32803: "CFA", 34892: "linear raw"}
_TIFF_MAX_TILE = 1 << 24    # OpenCV's TILE_MAX_WIDTH / _HEIGHT
# YCbCrSubSampling (h, v) libtiff's RGBA reader has a put routine for
_TIFF_YCBCR_SUBSAMPLINGS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2),
                            (1, 1))
# libtiff's defaults: YCbCrCoefficients, and ReferenceBlackWhite for YCbCr
_TIFF_LUMA = (0.299, 0.587, 0.114)
_TIFF_YCBCR_REF_BW = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)


class Tiff(NamedTuple):
    """What of page 0 of a TIFF its pixels depend on, as cv::imread reads
    it through libtiff's RGBA interface."""
    width: int
    height: int
    bits: int           # 1, 4, 8 or 16
    spp: int            # samples a pixel, 1-4
    compression: int    # one of TIFF_COMPRESSIONS
    photometric: int    # 0, 1, 2, 3, 5 or 6
    planar: int         # 1 chunky, 2 planar
    predictor: int      # 2 where it applies (LZW and Deflate), else 1
    fill_order: int     # 1, or 2: the bits of each stored byte reversed
    alpha: int          # 0 none, 1 associated, 2 unassociated (as used)
    big_endian: bool
    tiled: bool
    chunk_width: int    # a tile's width, or the image's
    chunk_height: int   # a tile's height, or the rows per strip
    orientation: int    # 1-4
    palette: Optional[bytes]  # 256 R, G, B entries of a palette, 8-bit
    offsets: tuple      # of each strip or tile, plane after plane
    counts: tuple
    jpeg_tables: Optional[tuple]  # (offset, bytes) of tag 347
    subsampling: tuple  # YCbCrSubSampling (h, v) of YCbCr, else (1, 1)
    fax_options: int    # T4Options (Group 3) or T6Options (Group 4), or 0
    # YCbCrCoefficients (3) and ReferenceBlackWhite (6) of YCbCr, as the C
    # floats libtiff keeps (float32 values), else ()
    ycbcr: tuple
    # the chunks that read as zeros: those libtiff cannot read (a byte
    # count of 0 or past the end of the file), all in planes after the
    # first, or every chunk of a compression libtiff has no codec for
    unread: tuple = ()


def tiff_chunk_bytes(info: Tiff, rows: int) -> int:
    """The bytes libtiff decodes from a strip of `rows` rows, or (rows the
    tile's height) a tile: the rows' bytes, or for subsampled YCbCr (not
    JPEG) TIFFVStripSize / TIFFVTileSize, a strip's cut to its rows
    rounded up to whole blocks times TIFFScanlineSize (a row of blocks
    over the vertical subsampling, rounded down)."""
    spc = 1 if info.planar == 2 and info.spp > 1 else info.spp
    if info.photometric != 6 or info.compression == 7:
        return rows * ((info.chunk_width * spc * info.bits + 7) // 8)
    h, v = info.subsampling
    block_row = -(-info.chunk_width // h) * (h * v + 2)
    block_rows = -(-rows // v)
    if info.tiled:
        return block_row * block_rows
    return min(block_row * block_rows, block_rows * v * (block_row // v))


def _tiff_refuse(what: str, cv2_fails: bool = False):
    raise ValueError(f"{what} is not supported" + (
        " (cv::imread fails on it too)" if cv2_fails else ""))


def tiff_ifd(raw: bytes) -> Tiff:
    """Parse page 0 (the first IFD) of a classic or Big TIFF as cv::imread
    reads it: OpenCV 5's TiffDecoder over libtiff 4.7, whose RGBA
    interface (TIFFReadRGBAStrip / TIFFReadRGBATile) gives the pixels of
    every 8-bit read. Reads strips and tiles, chunky and planar, of gray
    (1, 8, 16 bits, MINISBLACK or MINISWHITE), palette (1, 4, 8 bits), RGB
    (8, 16 bits) with or without alpha, CMYK (8 bits) and chunky 8-bit
    YCbCr (subsampled 4x4, 4x2, 4x1, 2x2, 2x1, 1x2 or 1x1; its
    YCbCrCoefficients and ReferenceBlackWhite as RATIONALs); compressions
    none, CCITT RLE, Group 3 (1-D or 2-D) and Group 4 (1-bit gray or
    palette), LZW, PackBits, Deflate and JPEG (gray, RGB with or without
    one extra sample, CMYK, YCbCr); predictor 2 under LZW and Deflate;
    orientations 1-4. Byte counts as libtiff takes them: its estimates
    where TIFFReadDirectory finds them bad (one strip's of 0; one
    uncompressed strip's past the file or short of its rows;
    uncompressed chunky strips whose first two differ), a count above
    1 MiB cut to ten chunks' bytes; a chunk of 0 or past the file's end
    fails cv::imread in the first plane (refused, saying so) and reads as
    zeros in a later one (`Tiff.unread`), as does every chunk of a
    compression libtiff has no codec for. What is damaged inside a
    chunk's data is left to the decoders. Raises ValueError naming the
    cause (a fault of the IFD itself: tags out of order or repeated, tag
    values beyond the file, a wrong count of offsets, a tag of a type or
    count libtiff reads otherwise), and for a variant cv::imread fails on
    saying so."""
    n = len(raw)
    magic = raw[:4]
    if magic in (b"II*\0", b"MM\0*"):
        big, order = False, "<" if magic[0] == 73 else ">"
    elif magic in (b"II+\0", b"MM\0+"):
        big, order = True, "<" if magic[0] == 73 else ">"
    else:
        raise ValueError("not a TIFF")
    if big:
        if n < 16:
            raise ValueError("truncated TIFF header")
        size, zero, ifd = struct.unpack(order + "HHQ", raw[4:16])
        if size != 8 or zero != 0:
            raise ValueError("corrupt BigTIFF header")
    else:
        if n < 8:
            raise ValueError("truncated TIFF header")
        ifd = struct.unpack(order + "I", raw[4:8])[0]
    count_fmt, entry, word = ("Q", 20, 8) if big else ("H", 12, 4)
    csize = struct.calcsize(count_fmt)
    if ifd < 8 or ifd + csize > n:
        raise ValueError("TIFF first IFD offset out of the file")
    entries = struct.unpack(order + count_fmt, raw[ifd:ifd + csize])[0]
    if entries == 0 or ifd + csize + entries * entry > n:
        raise ValueError("truncated TIFF IFD")
    tags = {}
    for k in range(entries):
        at = ifd + csize + k * entry
        tag, typ = struct.unpack(order + "HH", raw[at:at + 4])
        count = struct.unpack(order + ("Q" if big else "I"),
                              raw[at + 4:at + 4 + word])[0]
        if tag in tags:
            _tiff_refuse(f"TIFF IFD with tag {tag} twice")
        if tags and tag < max(tags):    # libtiff reads these otherwise
            _tiff_refuse("TIFF IFD with its tags out of order")
        tags[tag] = (typ, count, at + 4 + word)

    def values(tag, default=None, want=None):
        """A tag's integer values (a tuple), `default` if absent."""
        if tag not in tags:
            return default
        typ, count, at = tags[tag]
        code = _TIFF_TYPES.get(typ)
        if code is None or count == 0:
            raise ValueError(f"TIFF tag {tag} of type {typ} and {count} "
                             "values is not supported")
        nbytes = count * struct.calcsize(code)
        if nbytes > word:
            at = struct.unpack(order + ("Q" if big else "I"),
                               raw[at:at + word])[0]
            if at + nbytes > n:
                raise ValueError(f"TIFF tag {tag}'s values lie beyond the "
                                 "file")
        vals = struct.unpack(order + code * count, raw[at:at + nbytes])
        if want is not None and len(vals) not in want:
            raise ValueError(f"TIFF tag {tag} with {len(vals)} values")
        return vals

    def one(tag, default=None):
        """A one-value tag (libtiff fails on another count of most)."""
        v = values(tag, None if default is None else (default,), want=(1,))
        return None if v is None else v[0]

    def floats(tag, count, default):
        """A tag of `count` RATIONAL (or SRATIONAL) values as the C
        floats libtiff reads them into ((float)num / (float)den, 0 where
        den is 0), `default` if absent."""
        if tag not in tags:
            return tuple(float(np.float32(v)) for v in default)
        typ, n_vals, at = tags[tag]
        if typ not in (5, 10) or n_vals != count:
            _tiff_refuse(f"TIFF tag {tag} of type {typ} and {n_vals} values")
        at = struct.unpack(order + ("Q" if big else "I"),
                           raw[at:at + word])[0] if 8 * count > word else at
        if at + 8 * count > n:
            raise ValueError(f"TIFF tag {tag}'s values lie beyond the file")
        pairs = np.frombuffer(raw, order + ("u4" if typ == 5 else "i4"),
                              2 * count, at).reshape(count, 2)
        num, den = pairs.astype(np.float32).T
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = np.where(pairs[:, 1] == 0, np.float32(0), num / den)
        return tuple(float(v) for v in vals.astype(np.float32))

    def per_sample(tag, default):
        """A per-sample tag: one value, or at least `spp` equal ones (as
        libtiff's TIFFReadDirEntryPersampleShort takes it)."""
        v = values(tag, (default,))
        if len(v) != 1 and (len(v) < spp or len(set(v[:spp])) != 1):
            _tiff_refuse(f"TIFF tag {tag} with values {v[:8]} for {spp} "
                         "samples")
        return v[0]

    width, height = one(256), one(257)
    if width is None or height is None:
        raise ValueError("TIFF without ImageWidth or ImageLength")
    if not (0 < width and 0 < height):
        raise ValueError(f"TIFF size {width}x{height} out of range")
    check_cv_size(width, height)
    spp = one(277, 1)
    photometric = one(262)
    if not 1 <= spp <= 4:
        _tiff_refuse(f"TIFF of {spp} samples a pixel", spp > 4)
    if 258 not in tags and photometric not in (0, 1):
        _tiff_refuse("colour TIFF without BitsPerSample", True)
    bits = per_sample(258, 1)
    sample_format = per_sample(339, 1)
    compression = one(259, 1)
    planar = one(284, 1)
    orientation = one(274, 1)
    extra = values(338, ())
    if photometric is None:
        _tiff_refuse("TIFF without PhotometricInterpretation", True)
    if sample_format not in (1, 2):
        _tiff_refuse(f"TIFF SampleFormat {sample_format} (floating point "
                     "or other)", True)
    if bits not in (1, 4, 8, 16):
        _tiff_refuse(f"TIFF of {bits}-bit samples", True)
    if planar not in (1, 2):
        _tiff_refuse(f"TIFF PlanarConfiguration {planar}")
    # a compression libtiff has no codec for: its chunks fail to decode
    # and read as zeros
    no_codec = compression not in _TIFF_LIBTIFF_CODECS
    if compression not in TIFF_COMPRESSIONS and not no_codec:
        name = _TIFF_COMPRESSIONS.get(compression, f"{compression}")
        _tiff_refuse(f"TIFF compression {name}",
                     compression in _TIFF_CV_FAILS)
    fax_options = 0
    if compression in (2, 3, 4):
        # libtiff's fax codecs take 1-bit samples alone; T4Options bit 0
        # chooses 2-D Group 3 (bit 1, uncompressed mode, fails only where
        # an uncompressed run turns up; bit 2, fill bits, only pads EOLs)
        if bits != 1:
            _tiff_refuse(f"{_TIFF_COMPRESSIONS[compression]} TIFF of {bits}"
                         "-bit samples", True)
        fax_options = {2: 0, 3: one(292, 0), 4: one(293, 0)}[compression]
    if orientation in (5, 6, 7, 8):
        _tiff_refuse(f"TIFF orientation {orientation} (transposed)", True)
    if orientation not in (1, 2, 3, 4):
        _tiff_refuse(f"TIFF orientation {orientation}")
    if len(extra) >= spp or max(extra, default=0) > 2:
        _tiff_refuse(f"TIFF ExtraSamples {extra[:4]} for {spp} samples")
    colour = spp - len(extra)
    # libtiff's img->alpha
    alpha = 0
    if extra:
        alpha = {0: 1 if spp > 3 else 0, 1: 1, 2: 2}.get(extra[0], 0)
    planar_many = planar == 2 and spp > 1
    fill_order = one(266, 1)
    if fill_order not in (1, 2):
        _tiff_refuse(f"TIFF FillOrder {fill_order}")
    subsampling = (1, 1)
    ycbcr = ()
    palette = None
    if photometric in (0, 1):
        if bits == 4 or (bits == 1 and spp > 1 and not planar_many):
            _tiff_refuse(f"{bits}-bit gray TIFF"
                         f"{' with extra samples' if spp > 1 else ''}",
                         True)
        if planar_many and bits == 1:
            _tiff_refuse("planar 1-bit TIFF", True)
        if not planar_many:             # chunky gray ignores its alpha
            alpha = 0
    elif photometric == 3:
        if bits not in (1, 4, 8):
            _tiff_refuse(f"{bits}-bit palette TIFF", True)
        if planar_many:
            _tiff_refuse("planar palette TIFF", True)
        if bits < 8 and spp > 1:
            _tiff_refuse(f"{bits}-bit palette TIFF with extra samples",
                         True)
        cmap = values(320, want=(3 << bits,))
        if cmap is None:
            _tiff_refuse("palette TIFF without ColorMap", True)
        cm = np.asarray(cmap, np.int64).reshape(3, 1 << bits).T
        if (cm >= 256).any():          # libtiff's checkcmap and cvtcmap
            cm = cm >> 8
        pal = np.zeros((256, 3), np.uint8)
        pal[:1 << bits] = cm
        palette = pal.tobytes()
        alpha = 0
    elif photometric == 2:
        if colour < 3:
            _tiff_refuse(f"RGB TIFF of {colour} colour samples", True)
        if bits not in (8, 16):
            _tiff_refuse(f"{bits}-bit RGB TIFF", True)
        if not planar_many and spp < 4:
            alpha = 0
    elif photometric == 5:
        if one(332, 1) != 1:
            _tiff_refuse("separated TIFF with an InkSet other than CMYK",
                         True)
        if spp < 4 or bits != 8:
            _tiff_refuse(f"{bits}-bit separated TIFF of {spp} samples", True)
        if planar_many and spp != 4:
            _tiff_refuse("planar CMYK TIFF with extra samples", True)
        alpha = 0
    elif photometric == 6:
        if planar_many:
            _tiff_refuse("planar YCbCr TIFF")
        if spp != 3 or bits != 8:
            _tiff_refuse(f"YCbCr TIFF of {spp} {bits}-bit samples")
        subsampling = tuple(values(530, (2, 2), want=(2,)))
        if compression != 7:        # libjpeg converts a JPEG's to RGB
            if subsampling not in _TIFF_YCBCR_SUBSAMPLINGS:
                _tiff_refuse(f"TIFF YCbCr subsampling {subsampling[0]}x"
                             f"{subsampling[1]}", True)
            luma = floats(529, 3, _TIFF_LUMA)
            ref_bw = floats(532, 6, _TIFF_YCBCR_REF_BW)
            # libtiff's initYCbCrConversion
            if luma[1] == 0 or not all(np.isfinite(luma)):
                _tiff_refuse(f"TIFF YCbCrCoefficients {luma}", True)
            if not all(-0x7FFFFF7F < v < 0x7FFFFFFF for v in ref_bw):
                _tiff_refuse(f"TIFF ReferenceBlackWhite {ref_bw}", True)
            ycbcr = luma + ref_bw
        alpha = 0
    else:
        name = _TIFF_PHOTOMETRICS.get(photometric, f"{photometric}")
        _tiff_refuse(f"TIFF PhotometricInterpretation {name}")
    if compression == 7:
        # gray, RGB, YCbCr; or 4 samples, RGB + one extra (PIL's RGBA) or
        # CMYK, which libtiff has libjpeg leave as they are
        four = spp == 4 and (photometric, colour) in ((2, 3), (5, 4))
        if bits != 8 or planar_many or fill_order != 1 \
                or photometric not in (0, 1, 2, 5, 6) or not (
                    four or (spp == colour and spp in (1, 3))):
            _tiff_refuse("JPEG TIFF other than chunky 8-bit gray, RGB, "
                         "YCbCr, RGB with one extra sample or CMYK")
    predictor = 1
    if compression in (5, 8, 32946):
        predictor = one(317, 1)
        if predictor not in (1, 2):
            _tiff_refuse(f"TIFF predictor {predictor}")
        if predictor == 2 and bits not in (8, 16):
            _tiff_refuse(f"TIFF predictor 2 with {bits}-bit samples", True)
        if predictor == 2 and photometric == 6 and subsampling != (1, 1):
            _tiff_refuse("TIFF predictor 2 over subsampled YCbCr")
    tiled = 322 in tags or 323 in tags
    # libtiff keeps strip and tile offsets (and counts) in one slot
    other = (273, 279) if tiled else (322, 323, 324, 325)
    if any(t in tags for t in other):
        _tiff_refuse(f"{'tiled' if tiled else 'stripped'} TIFF with "
                     f"{'strip' if tiled else 'tile'} tags")
    if tiled:
        cw, ch = one(322), one(323)
        if cw is None or ch is None or not (0 < cw <= _TIFF_MAX_TILE
                                            and 0 < ch <= _TIFF_MAX_TILE):
            _tiff_refuse(f"TIFF tile of {cw}x{ch}")
        off_tag, cnt_tag = 324, 325
    else:
        cw, ch = width, one(278, 0xFFFFFFFF)
        if ch == 0:
            _tiff_refuse("TIFF RowsPerStrip 0", True)
        if ch == 0xFFFFFFFF:
            ch = height
        off_tag, cnt_tag = 273, 279
    # OpenCV's checks of a strip (rows per strip as stored) or tile, and
    # of its RGBA buffer
    if ch > _TIFF_MAX_TILE or cw * ch * 4 >= 1 << 30:
        _tiff_refuse(f"TIFF strip or tile of {cw}x{ch} (an RGBA buffer of "
                     "1 GiB or more)", True)
    ch = min(ch, height) if not tiled else ch
    nchunks = -(-width // cw) * -(-height // ch) * (spp if planar_many
                                                     else 1)
    offsets, counts = values(off_tag), values(cnt_tag)
    if offsets is None or counts is None:
        _tiff_refuse(f"TIFF without {'Tile' if tiled else 'Strip'}Offsets "
                     "and ByteCounts")
    if len(offsets) != nchunks or len(counts) != nchunks:
        raise ValueError(f"corrupt TIFF: {len(offsets)} offsets and "
                         f"{len(counts)} byte counts for {nchunks} chunks")
    info = Tiff(width, height, bits, spp, compression, photometric, planar,
                predictor, fill_order, alpha, order == ">", tiled, cw, ch,
                orientation, palette, offsets, counts, None,
                tuple(subsampling), fax_options, ycbcr)
    if tiled and compression == 1 and any(
            c != tiff_chunk_bytes(info, ch) for c in counts):
        _tiff_refuse("uncompressed TIFF tile of another byte count than "
                     "its size", True)
    # libtiff's TIFFReadDirectory replaces byte counts it finds bad by its
    # EstimateStripByteCounts: one strip's of 0 (compressed: the file's
    # bytes but for the header, the IFD and its values, up to the file's
    # end), or one uncompressed strip's past the end or short of its rows
    # (its rows' bytes); uncompressed chunky strips of which the first two
    # differ (each strip the rows of height / strips, rounded down)
    row_bytes = tiff_chunk_bytes(info, 1) if photometric != 6 \
        or compression == 7 else -(-cw // subsampling[0]) * (
            subsampling[0] * subsampling[1] + 2) // subsampling[1]
    counts = list(counts)
    if not tiled and nchunks == 1 and offsets[0] and (counts[0] == 0 or (
            compression == 1 and (counts[0] > n - offsets[0]
                                  or counts[0] < row_bytes * height))):
        if compression == 1:
            counts = [row_bytes * height]
        else:
            space = (16 + 8 + 20 * entries + 8) if big else (
                8 + 2 + 12 * entries + 4)
            for k in range(entries):
                at = ifd + csize + k * entry
                typ = struct.unpack(order + "H", raw[at + 2:at + 4])[0]
                count = struct.unpack(order + ("Q" if big else "I"),
                                      raw[at + 4:at + 4 + word])[0]
                size = _TIFF_TYPE_SIZES.get(typ, 0)
                if size == 0:
                    _tiff_refuse(f"TIFF IFD entry of type {typ} beside a "
                                 "byte count of 0", True)
                if size * count > word:
                    space += size * count
            counts = [min(max(n - space, 0), max(n - offsets[0], 0))]
    elif not tiled and not planar_many and nchunks > 2 \
            and compression == 1 and counts[0] != counts[1] \
            and counts[0] and counts[1]:
        counts = [row_bytes * (height // nchunks)] * nchunks
    # TIFFFillStrip / TIFFFillTile: a count above 1 MiB and ten chunks'
    # bytes is cut to that; a count of 0 or past the end of the file (the
    # file mapped) fails the read, which makes cv::imread fail in the
    # first plane and leaves a later plane's chunk zeros
    full = tiff_chunk_bytes(info, ch)
    per_plane = nchunks // (spp if planar_many else 1)
    unread = []
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        if cnt > 1 << 20 and full and (cnt - 4096) // 10 > full:
            cnt = counts[i] = full * 10 + 4096
        if cnt == 0 or cnt > n or off > n - cnt:
            if i < per_plane:
                _tiff_refuse("TIFF strip or tile with a byte count of 0 or "
                             "beyond the end of the file", True)
            unread.append(i)
    if no_codec:
        unread = range(nchunks)
    tables = None
    if compression == 7 and 347 in tags:
        typ, count, at = tags[347]
        if typ not in (1, 7) or count < 4:
            raise ValueError("corrupt TIFF JPEGTables tag")
        if count > word:
            at = struct.unpack(order + ("Q" if big else "I"),
                               raw[at:at + word])[0]
        if at + count > n:
            raise ValueError("TIFF tag 347's values lie beyond the file")
        tables = (at, count)
    return info._replace(jpeg_tables=tables, counts=tuple(counts),
                         unread=tuple(unread))


# ------------------------------------------------------------------- GIF

class Gif(NamedTuple):
    """What of a GIF cv::imread's pixels depend on: the logical screen,
    the colour tables and the first image."""
    width: int          # the logical screen's
    height: int
    gct: Optional[tuple]  # (offset, entries) of the global colour table
    background: int
    lct: Optional[tuple]  # (offset, entries) of the first image's table
    transparent: int    # the index not drawn, -1 for none
    left: int           # the first image's rectangle
    top: int
    frame_width: int
    frame_height: int
    interlace: bool
    min_code_size: int
    data_at: int        # its first data sub-block's length byte


def _gif_table(flags: int, at: int, n: int):
    """(offset, entries) of the colour table a flags byte declares at
    `at`, None for none; ValueError if it runs past the file."""
    if not flags & 0x80:
        return None
    entries = 2 << (flags & 7)
    if at + 3 * entries > n:
        raise ValueError("truncated GIF colour table")
    return at, entries


def _gif_skip_blocks(raw: bytes, pos: int) -> int:
    """The position after a run of data sub-blocks and its terminator."""
    n = len(raw)
    while True:
        if pos >= n:
            raise ValueError("truncated GIF (in a block's data)")
        size = raw[pos]
        pos += 1 + size
        if size == 0:
            return pos


def gif_blocks(raw: bytes) -> Gif:
    """Parse a GIF87a / GIF89a as cv::imread reads it (OpenCV 5's GIF
    reader): the logical screen (its size not 0) and global table (the
    background index inside it); every block to the trailer, which the
    reader walks to count the frames: images inside the screen with a
    minimum code size of 2-8, Graphic Control Extensions of 4 bytes and
    disposal 0-3, NETSCAPE2.0 application extensions, other extensions
    skipped; the first image and the transparent index of the last
    Graphic Control Extension before it. Raises ValueError naming the
    cause, and for a variant cv::imread fails on saying so."""
    n = len(raw)
    if raw[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF (GIF87a or GIF89a)")
    if n < 13:
        raise ValueError("truncated GIF header")
    width, height, flags, background = struct.unpack("<HHBB", raw[6:12])
    if width == 0 or height == 0:
        raise ValueError(f"GIF logical screen of {width}x{height} (cv::"
                         "imread fails on it too)")
    gct = _gif_table(flags, 13, n)
    if gct is not None and background >= gct[1]:
        raise ValueError(f"GIF background index {background} outside its "
                         "global colour table (cv::imread fails on it too)")
    pos = 13 + (3 * gct[1] if gct else 0)
    first, transparent = None, -1
    while True:
        if pos >= n:
            raise ValueError("truncated GIF (no trailer)")
        kind = raw[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos + 2 > n:
                raise ValueError("truncated GIF extension")
            label = raw[pos + 1]
            if label == 0xF9:
                if raw[pos + 2:pos + 3] != b"\x04" or pos + 7 > n:
                    raise ValueError("corrupt GIF Graphic Control Extension"
                                     " (cv::imread fails on it too)")
                gce_flags = raw[pos + 3]
                if (gce_flags >> 2) & 7 > 3:
                    raise ValueError(f"GIF disposal method "
                                     f"{(gce_flags >> 2) & 7} (cv::imread "
                                     "fails on it too)")
                if first is None:
                    transparent = raw[pos + 6] if gce_flags & 1 else -1
            elif label == 0xFF and raw[pos + 2:pos + 14] != \
                    b"\x0bNETSCAPE2.0":
                raise ValueError("GIF application extension other than "
                                 "NETSCAPE2.0 is not supported")
            pos = _gif_skip_blocks(raw, pos + 2)
            continue
        if kind != 0x2C:
            raise ValueError(f"corrupt GIF: block {kind:#04x} (cv::imread "
                             "fails on it too)")
        if pos + 11 > n:
            raise ValueError("truncated GIF image descriptor")
        left, top, fw, fh, iflags = struct.unpack("<HHHHB",
                                                  raw[pos + 1:pos + 10])
        if fw == 0 or fh == 0 or left + fw > width or top + fh > height:
            raise ValueError(f"GIF image of {fw}x{fh} at ({left}, {top}) "
                             f"outside its {width}x{height} screen (cv::"
                             "imread fails on it too)")
        lct = _gif_table(iflags, pos + 10, n)
        at = pos + 10 + (3 * lct[1] if lct else 0)
        if at >= n:
            raise ValueError("truncated GIF image")
        min_size = raw[at]
        if not 2 <= min_size <= 8:
            raise ValueError(f"GIF LZW minimum code size {min_size} is not "
                             "supported")
        if first is None:
            first = Gif(width, height, gct, background, lct, transparent,
                        left, top, fw, fh, bool(iflags & 0x40), min_size,
                        at + 1)
        pos = _gif_skip_blocks(raw, at + 1)
    if first is None:
        raise ValueError("GIF without an image (cv::imread fails on it "
                         "too)")
    tables = max(first.lct[1] if first.lct else 0,
                 gct[1] if gct else 0)
    if tables and first.transparent >= tables:
        raise ValueError(f"GIF transparent index {first.transparent} "
                         "outside its colour tables is not supported")
    return first


# ----------------------------------------------------------- JPEG 2000

JP2_MAGIC = b"\0\0\0\x0cjP  \r\n\x87\n"
J2K_MAGIC = b"\xff\x4f\xff\x51"        # SOC, then SIZ
# the layout of the parameters `of_jp2_decode` (csrc/jp2.cpp) takes
_J2K_HEAD, _J2K_MAX_RES = 16, 33
_J2K_BANDS = 3 * (_J2K_MAX_RES - 1) + 1
_J2K_PRCW = 8
_J2K_PRCH = _J2K_PRCW + _J2K_MAX_RES
_J2K_EXPN = _J2K_PRCH + _J2K_MAX_RES
_J2K_MANT = _J2K_EXPN + _J2K_BANDS
_J2K_STRIDE = _J2K_MANT + _J2K_BANDS
_J2K_CBLK_STYLES = ((1, "BYPASS"), (2, "RESET"), (4, "TERMALL"),
                    (8, "VSC"), (16, "PTERM"), (32, "SEGSYM"),
                    (64, "HT (HTJ2K)"))
# main-header markers refused by name, and those skipped
_J2K_REFUSED = {0xFF5E: "RGN (region of interest)",
                0xFF5F: "POC (progression order change)",
                0xFF60: "PPM (packed packet headers)",
                0xFF50: "CAP (HTJ2K)", 0xFF59: "CPF (HTJ2K)"}
_J2K_SKIPPED = (0xFF55, 0xFF57, 0xFF63, 0xFF64)    # TLM, PLM, CRG, COM
# the most samples (width x height x components) the decoder takes: its
# planes are int32, and a tile's float32 or int32 too (an 8K RGB frame
# is 2^26.6)
JP2_MAX_SAMPLES = 1 << 27
# top-level JP2 boxes skipped
_JP2_SKIPPED = (b"xml ", b"uuid", b"uinf", b"jp2i")


class Jp2(NamedTuple):
    """What of a JPEG 2000 file cv::imread's pixels depend on: the size,
    the components, the colour space its reader picks (JP2 `colr`
    enumerated 16 "srgb", 17 "gray"; a raw codestream "unknown", read as
    sRGB), and the codestream with its main header as `of_jp2_decode`
    takes it."""
    width: int
    height: int
    components: int
    precision: int          # the largest of the components'
    colour: str
    stream_at: int          # the codestream's offset in the file
    stream_size: int
    sot_at: int             # its first SOT, from the codestream's start
    params: bytes           # int64 parameters (csrc/jp2.cpp's layout)


def _jp2_refuse(what: str, cv2_fails: bool = False):
    raise ValueError(f"JPEG 2000 {what} "
                     + ("(cv::imread fails on it too)" if cv2_fails
                        else "is not supported"))


def _jp2_boxes(raw: bytes, pos: int, end: int):
    """(type, content start, content end) of each box from pos to end."""
    while pos < end:
        if pos + 8 > end:
            raise ValueError("truncated JP2 box header")
        size, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        at = pos + 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("truncated JP2 box header")
            size = struct.unpack(">Q", raw[pos + 8:pos + 16])[0]
            at = pos + 16
        elif size == 0:
            size = end - pos
        if size < at - pos or pos + size > end:
            raise ValueError(f"JP2 box {kind!r} runs past its end")
        yield kind, at, pos + size
        pos += size


def _jp2_container(raw: bytes):
    """(colour, codestream offset, size) of a JP2 file: the signature,
    ftyp (brand jp2), jp2h (ihdr, colr, cdef, res, bpcc) before jp2c."""
    n = len(raw)
    boxes = _jp2_boxes(raw, 0, n)
    first = next(boxes, None)
    if first is None or raw[:12] != JP2_MAGIC:
        raise ValueError("not a JP2 file")
    ftyp = next(boxes, None)
    if ftyp is None or ftyp[0] != b"ftyp" or ftyp[2] - ftyp[1] < 8:
        raise ValueError("JP2 file without an ftyp box second")
    brand = raw[ftyp[1]:ftyp[1] + 4]
    if brand != b"jp2 ":
        _jp2_refuse(f"brand {brand.decode('latin-1')!r} (JPX, Part 2 "
                    "extensions, or HTJ2K)")
    header = None
    for kind, at, end in boxes:
        if kind == b"jp2h":
            if header is not None:
                raise ValueError("JP2 file with two jp2h boxes")
            header = _jp2_header_box(raw, at, end)
        elif kind == b"jp2c":
            if header is None:
                raise ValueError("JP2 codestream before its jp2h box")
            return header + (at, end - at)
        elif kind not in _JP2_SKIPPED:
            _jp2_refuse(f"box {kind.decode('latin-1')!r}")
    raise ValueError("JP2 file without a codestream (jp2c box)")


def _jp2_header_box(raw: bytes, pos: int, end: int):
    """(colour, (width, height, components) of ihdr, cdef entries) of a
    jp2h box."""
    ihdr = colour = None
    cdef = ()
    for kind, at, stop in _jp2_boxes(raw, pos, end):
        body = raw[at:stop]
        if ihdr is None and kind != b"ihdr":
            raise ValueError("JP2 jp2h box without ihdr first")
        if kind == b"ihdr":
            if ihdr is not None or len(body) != 14:
                raise ValueError("corrupt JP2 ihdr box")
            h, w, nc, _bpc, method = struct.unpack(">IIHBB", body[:12])
            if method != 7:
                raise ValueError(f"JP2 ihdr compression {method} is not "
                                 "JPEG 2000")
            ihdr = (w, h, nc)
        elif kind == b"colr":
            if colour is not None:
                _jp2_refuse("second colr box")
            if len(body) < 3:
                raise ValueError("corrupt JP2 colr box")
            if body[0] == 2:
                _jp2_refuse("ICC colour profile (colr method 2)")
            if body[0] != 1 or len(body) != 7:
                _jp2_refuse(f"colr method {body[0]} (Part 2)")
            enumcs = struct.unpack(">I", body[3:7])[0]
            if enumcs == 18:
                _jp2_refuse("sYCC colour space (colr enumerated 18)")
            if enumcs in (12, 24):
                _jp2_refuse(f"colour space {enumcs} (CMYK or e-sYCC)",
                            cv2_fails=True)
            colour = {16: "srgb", 17: "gray"}.get(enumcs, "unknown")
        elif kind == b"cdef":
            if len(body) < 2 or cdef:
                raise ValueError("corrupt JP2 cdef box")
            count = struct.unpack(">H", body[:2])[0]
            if len(body) != 2 + 6 * count:
                raise ValueError("corrupt JP2 cdef box")
            cdef = tuple(struct.unpack(">HHH", body[2 + 6 * i:8 + 6 * i])
                         for i in range(count))
        elif kind in (b"pclr", b"cmap"):
            _jp2_refuse("palette (pclr / cmap boxes)")
        elif kind not in (b"res ", b"bpcc"):
            _jp2_refuse(f"jp2h box {kind.decode('latin-1')!r}")
    if ihdr is None or colour is None:
        raise ValueError("JP2 jp2h box without ihdr and colr")
    return colour, ihdr, cdef


def _j2k_coding_style(body: bytes, at: int, precincts: bool):
    """(numres, cblkw, cblkh, transform, precinct exponents) of SPcod /
    SPcoc from `at`; the end of it."""
    if at + 5 > len(body):
        raise ValueError("truncated JPEG 2000 COD / COC marker")
    levels, xcb, ycb, style, transform = body[at:at + 5]
    if levels > 32:
        raise ValueError(f"JPEG 2000 with {levels} decomposition levels")
    if xcb > 8 or ycb > 8 or xcb + ycb > 8:
        raise ValueError("corrupt JPEG 2000 code-block size")
    if style:
        _jp2_refuse("code-block style " + " | ".join(
            name for bit, name in _J2K_CBLK_STYLES if style & bit)
            if style & 127 else f"code-block style {style:#x}")
    if transform > 1:
        raise ValueError(f"corrupt JPEG 2000 wavelet transform {transform}")
    at += 5
    if precincts:
        if at + levels + 1 > len(body):
            raise ValueError("truncated JPEG 2000 precinct sizes")
        sizes = tuple((b & 15, b >> 4) for b in body[at:at + levels + 1])
        if any(r and (pw == 0 or ph == 0) for r, (pw, ph) in
               enumerate(sizes)):
            raise ValueError("corrupt JPEG 2000 precinct size")
        at += levels + 1
    else:
        sizes = ((15, 15),) * (levels + 1)
    return (levels + 1, xcb + 2, ycb + 2, transform, sizes), at


def _j2k_quantization(body: bytes, at: int):
    """(guard bits, [(exponent, mantissa)] by band) of SPqcd / SPqcc."""
    if at >= len(body):
        raise ValueError("truncated JPEG 2000 QCD / QCC marker")
    style, guard = body[at] & 31, body[at] >> 5
    rest = body[at + 1:]
    if style == 0:
        steps = [(b >> 3, 0) for b in rest]
    elif style in (1, 2):
        if len(rest) < 2 or (style == 1 and len(rest) != 2):
            raise ValueError("corrupt JPEG 2000 quantization marker")
        steps = [(v >> 11, v & 0x7FF) for v in struct.unpack(
            f">{len(rest) // 2}H", rest[:len(rest) // 2 * 2])]
        if style == 1:     # scalar derived (E-5)
            e0, m0 = steps[0]
            steps = [(e0, m0)] + [(max(e0 - (b - 1) // 3, 0), m0)
                                  for b in range(1, _J2K_BANDS)]
    else:
        raise ValueError(f"corrupt JPEG 2000 quantization style {style}")
    return guard, steps[:_J2K_BANDS]


def jp2_header(raw: bytes) -> Jp2:
    """Parse a JP2 file or a raw JPEG 2000 codestream as cv::imread reads
    it (OpenJPEG 2.5 under OpenCV 5's reader): the boxes, then the main
    header (SIZ, COD, COC, QCD, QCC; TLM, PLM, CRG and COM skipped) up to
    the first SOT. Raises ValueError naming the cause: corrupt headers,
    what cv::imread fails on too (signed components, precisions below 8,
    an image offset, more than 4 components, CMYK), and what the decoder
    does not take (RGN, POC, PPM, SOP / EPH, CAP and HTJ2K, code-block
    styles other than 0, subsampled components, precisions above 16,
    palettes, sYCC and ICC colour, Part 2 brands)."""
    if raw.startswith(JP2_MAGIC):
        colour, ihdr, cdef, at, size = _jp2_container(raw)
    elif raw.startswith(J2K_MAGIC):
        colour, ihdr, cdef, at, size = "unknown", None, (), 0, len(raw)
    else:
        raise ValueError("not a JPEG 2000 file")
    cs = raw[at:at + size]
    if cs[:4] != J2K_MAGIC or len(cs) < 6:
        raise ValueError("JPEG 2000 codestream without SOC and SIZ")
    lsiz = struct.unpack(">H", cs[4:6])[0]
    if lsiz < 41 or 4 + lsiz > len(cs):
        raise ValueError("truncated JPEG 2000 SIZ marker")
    (rsiz, xsiz, ysiz, xo, yo, xt, yt, xto, yto,
     nc) = struct.unpack(">HIIIIIIIIH", cs[6:42])
    if lsiz != 38 + 3 * nc or nc == 0:
        raise ValueError("corrupt JPEG 2000 SIZ marker")
    if rsiz & 0x4000:
        _jp2_refuse("HTJ2K codestream (Rsiz)")
    if rsiz & 0x8000:
        _jp2_refuse("Part 2 capabilities (Rsiz)")
    if xo or yo:
        _jp2_refuse(f"image offset ({xo}, {yo})", cv2_fails=True)
    if xsiz == 0 or ysiz == 0 or xt == 0 or yt == 0 or xto or yto:
        raise ValueError("corrupt JPEG 2000 image or tile size")
    if nc > 4:
        _jp2_refuse(f"image of {nc} components", cv2_fails=True)
    check_cv_size(xsiz, ysiz)
    if xsiz * ysiz * nc > JP2_MAX_SAMPLES:
        _jp2_refuse(f"image of {xsiz}x{ysiz}x{nc} samples (above 2^27)")
    precs = []
    for c in range(nc):
        ssiz, dx, dy = cs[42 + 3 * c:45 + 3 * c]
        if ssiz & 0x80:
            _jp2_refuse(f"signed component {c}", cv2_fails=True)
        if (ssiz & 0x7F) + 1 > 38 or dx == 0 or dy == 0:
            raise ValueError("corrupt JPEG 2000 SIZ component")
        if dx != 1 or dy != 1:
            _jp2_refuse(f"component {c} subsampled {dx}x{dy}")
        precs.append((ssiz & 0x7F) + 1)
    if max(precs) < 8:
        _jp2_refuse(f"precision {max(precs)} (below 8)", cv2_fails=True)
    if max(precs) > 16:
        _jp2_refuse(f"precision {max(precs)} (above 16)")
    if ihdr is not None and ihdr != (xsiz, ysiz, nc):
        raise ValueError("JP2 ihdr box differs from the codestream's SIZ")
    alpha = 0
    for cn, typ, asoc in cdef:
        if cn >= nc or (typ == 0 and asoc != cn + 1) or \
                (typ != 0 and asoc not in (0, 65535)):
            _jp2_refuse("cdef box reordering channels")
        alpha += typ != 0
    if alpha > 1:
        _jp2_refuse("cdef box of two alpha channels")

    cod = None
    coc, qcc = {}, {}
    qcd = None
    pos = 4 + lsiz
    while True:
        if pos + 2 > len(cs):
            raise ValueError("truncated JPEG 2000 main header")
        marker = struct.unpack(">H", cs[pos:pos + 2])[0]
        if marker == 0xFF90:
            break
        if marker < 0xFF40 or pos + 4 > len(cs):
            raise ValueError(f"corrupt JPEG 2000 main header (marker "
                             f"{marker:#06x})")
        length = struct.unpack(">H", cs[pos + 2:pos + 4])[0]
        if length < 2 or pos + 2 + length > len(cs):
            raise ValueError("truncated JPEG 2000 main header marker")
        body = cs[pos + 4:pos + 2 + length]
        comp_bytes = 1 if nc < 257 else 2

        def component(at=0):
            c = body[at] if comp_bytes == 1 else \
                struct.unpack(">H", body[at:at + 2])[0]
            if c >= nc:
                raise ValueError("JPEG 2000 COC / QCC of a component the "
                                 "image lacks")
            return c

        if marker == 0xFF52:            # COD
            if cod is not None or len(body) < 5:
                raise ValueError("corrupt JPEG 2000 COD marker")
            scod, prog, layers, mct = struct.unpack(">BBHB", body[:5])
            if scod & 6:
                _jp2_refuse("SOP / EPH markers")
            if scod & ~7 or prog > 4 or layers == 0 or mct > 1:
                raise ValueError("corrupt JPEG 2000 COD marker")
            style, end = _j2k_coding_style(body, 5, bool(scod & 1))
            if end != len(body):
                raise ValueError("corrupt JPEG 2000 COD marker")
            cod = (prog, layers, mct, style)
        elif marker == 0xFF53:          # COC
            if len(body) < comp_bytes + 1:
                raise ValueError("corrupt JPEG 2000 COC marker")
            c = component()
            scoc = body[comp_bytes]
            style, end = _j2k_coding_style(body, comp_bytes + 1,
                                           bool(scoc & 1))
            if c in coc or end != len(body):
                raise ValueError("corrupt JPEG 2000 COC marker")
            coc[c] = style
        elif marker == 0xFF5C:          # QCD
            if qcd is not None:
                raise ValueError("JPEG 2000 main header with two QCD")
            qcd = _j2k_quantization(body, 0)
        elif marker == 0xFF5D:          # QCC
            if len(body) < comp_bytes + 1:
                raise ValueError("corrupt JPEG 2000 QCC marker")
            c = component()
            if c in qcc:
                raise ValueError("corrupt JPEG 2000 QCC marker")
            qcc[c] = _j2k_quantization(body, comp_bytes)
        elif marker in _J2K_REFUSED:
            _jp2_refuse(_J2K_REFUSED[marker] + " marker")
        elif marker not in _J2K_SKIPPED:
            _jp2_refuse(f"main header marker {marker:#06x}")
        pos += 2 + length
    if cod is None or qcd is None:
        raise ValueError("JPEG 2000 main header without COD and QCD")

    prog, layers, mct, default_style = cod
    params = np.zeros(_J2K_HEAD + nc * _J2K_STRIDE, np.int64)
    params[:9] = (xsiz, ysiz, nc, xt, yt, layers, prog, mct,
                  max(precs) - 8)
    for c in range(nc):
        numres, cbw, cbh, transform, sizes = coc.get(c, default_style)
        guard, steps = qcc.get(c, qcd)
        if len(steps) < 3 * numres - 2:
            raise ValueError(f"JPEG 2000 quantization of component {c} "
                             "has fewer step sizes than bands")
        block = params[_J2K_HEAD + c * _J2K_STRIDE:
                       _J2K_HEAD + (c + 1) * _J2K_STRIDE]
        block[:7] = (precs[c], numres, cbw, cbh, 0, transform, guard)
        for r, (pw, ph) in enumerate(sizes):
            block[_J2K_PRCW + r], block[_J2K_PRCH + r] = pw, ph
        for b, (e, m) in enumerate(steps):
            block[_J2K_EXPN + b], block[_J2K_MANT + b] = e, m
    if mct and (nc < 3 or len({params[_J2K_HEAD + c * _J2K_STRIDE + 5]
                               for c in range(3)}) != 1):
        _jp2_refuse("component transform on fewer than 3 components or "
                    "mixed wavelets")
    return Jp2(xsiz, ysiz, nc, max(precs), colour, at, size, pos,
               params.tobytes())


# ------------------------------------------------------------- any frame

# magic -> name of the formats refused by name
_OTHER_FORMATS = ((b"\x76\x2f\x31\x01", "OpenEXR"),)


def image_kind(raw: bytes) -> str:
    """"png", "pnm", "bmp", "jpeg", "webp", "ras", "pam", "hdr", "pfm",
    "tiff", "gif" or "jp2" (a JP2 file or a raw codestream) by the file's
    magic; ValueError naming the format,
    where it is known, for any other file."""
    if raw[:8] == PNG_MAGIC:
        return "png"
    if raw[:3] == JPEG_MAGIC:
        return "jpeg"
    if raw[:1] == b"P" and raw[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6"):
        return "pnm"
    if raw[:2] == b"BM":
        return "bmp"
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "webp"
    if raw[:4] == SUN_MAGIC:
        return "ras"
    if raw[:2] == b"P7":
        return "pam"
    if raw[:2] in (b"Pf", b"PF"):
        return "pfm"
    if raw.startswith(HDR_MAGICS):
        return "hdr"
    if raw[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return "tiff"
    if raw[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if raw.startswith(JP2_MAGIC) or raw.startswith(J2K_MAGIC):
        return "jp2"
    name = next((n for m, n in _OTHER_FORMATS if raw.startswith(m)), None)
    if raw[4:8] == b"ftyp" and raw[8:12] in (b"avif", b"avis"):
        name = "AVIF"
    raise ValueError(f"unsupported image format{f' ({name})' if name else ''}"
                     f": {FORMATS} are read")


def load_image(path: str, channels: int = 1) -> np.ndarray:
    """A frame of any format `FORMATS` names as float32 (C, H, W), the
    values cv::imread gives: channels=1 IMREAD_GRAYSCALE, channels=3
    IMREAD_COLOR in BGR order. Decoded by the same host libraries as the
    serving pipeline's `native.io.decode_batch` (see that module for each
    format's rules). Raises ValueError naming the cause on a file it
    refuses (another format, corrupt data, an unsupported variant)."""
    from of_dis_tpu_torch.native import io as native_io
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return native_io.decode_image(raw, channels).astype(np.float32)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
