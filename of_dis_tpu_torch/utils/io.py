"""Flow/depth/image file I/O for the port, in numpy and the standard library.

Byte-compatible with the reference writers/readers:
  - `.flo`: "PIEH" magic + int32 width/height + row-major float32 payload with
    1 (depth), 2 (flow) or 4 (scene flow) channels (reference: run_dense.cpp:17-58).
  - `.pfm`: "Pf" header, bottom-up rows, NEGATED depth values, scale -1.0
    written via printf("%f") (reference: run_dense.cpp:61-82).
  - image loading reads PNG, PNM (P1-P6), BMP and JPEG frames with the
    values cv::imread gives (run_dense.cpp:200-210), with no OpenCV or PIL:
    the headers and chunks are parsed here (the PNG image data inflated by
    zlib) and the pixels decoded by the port's host libraries
    (`native.io`: csrc/io_native.cpp, csrc/jpeg.cpp). Gray is what
    cv::imread(GRAYSCALE) gives: for a colour PNG libpng's rgb_to_gray
    (0.299 / 0.587 in 1/32768ths, truncated, or through the file's gamma),
    for PNM and BMP OpenCV's fixed-point BGR2GRAY, for a JPEG its decoded
    Y plane; the EXIF orientation of a JPEG is applied.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

_FLO_MAGIC = b"PIEH"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"  # SOI, then a marker's FF
FORMATS = "PNG, PNM (P1-P6), BMP and JPEG"


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


# ------------------------------------------------------------- any frame

# magic -> name of the formats refused by name
_OTHER_FORMATS = ((b"II*\0", "TIFF"), (b"MM\0*", "TIFF"), (b"GIF8", "GIF"),
                  (b"\0\0\0\x0cjP  ", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000"),
                  (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
                  (b"PF", "PFM"), (b"Pf", "PFM"), (b"P7", "PAM"),
                  (b"\x59\xa6\x6a\x95", "Sun raster"),
                  (b"\x76\x2f\x31\x01", "OpenEXR"))


def image_kind(raw: bytes) -> str:
    """"png", "pnm", "bmp" or "jpeg" by the file's magic; ValueError
    naming the format, where it is known, for any other file."""
    if raw[:8] == PNG_MAGIC:
        return "png"
    if raw[:3] == JPEG_MAGIC:
        return "jpeg"
    if raw[:1] == b"P" and raw[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6"):
        return "pnm"
    if raw[:2] == b"BM":
        return "bmp"
    name = next((n for m, n in _OTHER_FORMATS if raw.startswith(m)), None)
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        name = "WebP"
    elif raw[4:8] == b"ftyp" and raw[8:12] in (b"avif", b"avis"):
        name = "AVIF"
    raise ValueError(f"unsupported image format{f' ({name})' if name else ''}"
                     f": {FORMATS} are read")


def load_image(path: str, channels: int = 1) -> np.ndarray:
    """A PNG, PNM (P1-P6), BMP or JPEG frame as float32 (C, H, W), the
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
